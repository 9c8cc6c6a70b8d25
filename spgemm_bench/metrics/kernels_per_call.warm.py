"""Device operations (kernels, copies and sets) a warm call launches,
from the profiler's trace of the traced stretch."""


def read(run):
    p = run.profile
    if p is None or not p.by_name:
        return None
    return p.launches_per_call()
