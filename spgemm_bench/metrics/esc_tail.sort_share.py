"""The share of the ESC tail's slots that took the sort tail (torch ops)
rather than the hand-written tail kernels or the direct path, over the
window's calls: the plan's own counter (``BucketPlan.tail_slots``, slots
by route, summed over its runs), read before and after the window."""


def read(run):
    slots = run.counters.get("tail_slots")
    if not slots or sum(slots.values()) <= 0:
        return None
    return 100.0 * slots.get("sort", 0) / sum(slots.values())
