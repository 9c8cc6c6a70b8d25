"""The share of the traced stretch of warm calls in which no operation
ran on the card: 1 - busy / window, from the profiler's trace."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
