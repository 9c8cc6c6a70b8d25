"""Device milliseconds a warm call spends in the gather frontend's
kernel (``gather_front``: one launch a gather class writes its keys and
A·B products), from the profiler's trace of the traced stretch; None
where no such kernel ran (a program without it)."""

# the gather frontend's kernel, matched by the start of its name
GATHER_KERNELS = ("gather_front",)


def is_gather(name: str) -> bool:
    return name.startswith(GATHER_KERNELS)


def read(run):
    p = run.profile
    if p is None or not any(is_gather(k) for k in p.by_name):
        return None
    return 1e3 * p.kernel_s(is_gather)
