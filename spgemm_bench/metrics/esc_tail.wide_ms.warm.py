"""Device milliseconds a warm call spends in the ESC tail's wide path
(rows wider than 8192 slots: the pieces on the tile path, then the merge
rounds), from the profiler's trace of the traced stretch; None where no
kernel of that path ran (a program without it)."""

# the wide path's kernels, matched by the start of their names
WIDE_KERNELS = ("wide_pieces", "wide_dups", "wide_scan", "wide_merge")


def is_wide(name: str) -> bool:
    return name.startswith(WIDE_KERNELS)


def read(run):
    p = run.profile
    if p is None or not any(is_wide(k) for k in p.by_name):
        return None
    return 1e3 * p.kernel_s(is_wide)
