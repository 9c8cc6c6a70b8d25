"""Set-up: from the process's start to the window's first timed call
(input generation, routing, planning, the first calls, warm-ups), less
the seconds spent in nvcc, which only a checkout's first run spends and
the result line gives apart as ``nvcc_s``."""


def read(run):
    return run.setup_s
