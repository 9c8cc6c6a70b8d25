"""The gather frontend against its byte bound, in percent: the bytes
that its classes need at least (:func:`gather_bytes`: each slot of the
classes, its key and product written once; B's columns and values read
once, as many as the covered slots ask for but no more than B holds,
since B's repeated reads can come from the card's 50 MB L2), over the card's HBM rate, over the gather kernel's
device time a call (``front.gather_ms.warm``).  The slots are the plan's
counters (``BucketPlan.stats()``): ``gather_front_slots``, the slots of
the gather classes that one call sends to the kernel, all written, and
``gather_front_live_slots``, those of them that entries cover; B is the
run's A (every cell multiplies A by itself).  The bytes count the same
work whatever implements the frontend.  None where the program has no
such counters or no gather kernel ran."""

import importlib.util
import os

# one H100 SXM's HBM3 rate (NVIDIA's data sheet), the byte bounds' rate
HBM_BYTES_PER_S = 3.35e12


def gather_bytes(slots: int, live: int, nnz_b: int,
                 value_bytes: int = 8) -> int:
    """Least HBM bytes of the frontend on ``slots`` slots of which
    ``live`` hold products of a B of ``nnz_b`` nonzeros: a 4-byte key and
    a product written for each slot, and a 4-byte column and a value read
    for each of B's nonzeros that the live slots read, at most ``live``
    and at most ``nnz_b`` (12 B each in float64)."""
    return (4 + value_bytes) * (slots + min(live, nnz_b))


def _gather_ms():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "front.gather_ms.warm.py")
    spec = importlib.util.spec_from_file_location("_gather_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(run):
    plan = run.counters.get("plan", {})
    slots = plan.get("gather_front_slots")
    live = plan.get("gather_front_live_slots")
    nnz_b = getattr(run.A, "nnz", None)
    ms = _gather_ms().read(run)
    if not slots or live is None or nnz_b is None or not ms:
        return None
    value_bytes = 8 if run.config["value_dtype"] == "float64" else 4
    bound_s = (gather_bytes(slots, live, nnz_b, value_bytes)
               / HBM_BYTES_PER_S)
    return 100.0 * bound_s / (ms / 1e3)
