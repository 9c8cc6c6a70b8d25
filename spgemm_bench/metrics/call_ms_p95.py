"""The 95th percentile (nearest rank) of every window call's time, each
call measured by CUDA events recorded before it and after its
synchronize, on the device's clock."""

import math


def read(run):
    ms = sorted(run.call_ms())
    if not ms:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
