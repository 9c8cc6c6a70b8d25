"""The ESC tail's wide path against its byte bound, in percent: the
bytes that its rows need at least (:func:`wide_bytes`: each slot that
the path reads, its key and value read once, and each slot of its output
written once), over the card's HBM rate, over the wide path's device
time a call (``esc_tail.wide_ms.warm``).  The slots are the plan's
counters (``BucketPlan.stats()``): ``wide_tail_slots``, the slots one
call sends to the wide path, all written, and ``wide_tail_live_slots``,
those of them read (a slab row's slots below its count, every slot of a
flat segment).  The bytes count the same work whatever implements the
path, as the tile path's byte bounds count only live slots' reads.  None
where the program has no such counters or no wide-path kernel ran."""

import importlib.util
import os

# one H100 SXM's HBM3 rate (NVIDIA's data sheet), the byte bounds' rate
HBM_BYTES_PER_S = 3.35e12


def wide_bytes(slots: int, live: int, value_bytes: int = 8) -> int:
    """Least bytes of the tail on ``slots`` slots of which ``live`` hold
    products: a 4-byte key and a value read for each live slot and
    written for each slot (12 B each way in float64)."""
    return (4 + value_bytes) * (live + slots)


def _wide_ms():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "esc_tail.wide_ms.warm.py")
    spec = importlib.util.spec_from_file_location("_wide_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    plan = run.counters.get("plan", {})
    slots = plan.get("wide_tail_slots")
    live = plan.get("wide_tail_live_slots")
    ms = _wide_ms().read(run)
    if not slots or live is None or not ms:
        return None
    value_bytes = 8 if run.config["value_dtype"] == "float64" else 4
    bound_s = wide_bytes(slots, live, value_bytes) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (ms / 1e3)
