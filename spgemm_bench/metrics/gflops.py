"""The paper's rate over the whole window: 2 * intprod floating-point
operations a call, times the calls completed, over the span from the
first call's start to the last call's end (host clock)."""


def read(run):
    if not run.calls:
        return None
    span = run.calls[-1]["end"] - run.calls[0]["start"]
    return 2.0 * run.work["intprod"] * len(run.calls) / span / 1e9
