"""Per-phase timing: the seven phase fields of the reference's ``Timing``
(``total`` excludes ``form_mask_matrix_b``), a context helper that adds
a block's wall time to one field, and ``gflops``.

A phase's wall time means the device's time only when the block ends
in a device fence (:func:`device_fence`, ``torch.cuda.synchronize``):
PyTorch returns from a CUDA call before the card has finished.
"""

from __future__ import annotations

import dataclasses
import time

import torch

_PHASES = ("mem_alloc", "form_mask_matrix_b", "symbolic_binning",
           "calculate_c_nnz", "malloc_c_col_val", "numeric_binning",
           "numeric")


@dataclasses.dataclass
class Timing:
    """Per-phase milliseconds."""

    mem_alloc: float = 0.0
    form_mask_matrix_b: float = 0.0
    symbolic_binning: float = 0.0
    calculate_c_nnz: float = 0.0
    malloc_c_col_val: float = 0.0
    numeric_binning: float = 0.0
    numeric: float = 0.0

    def total(self) -> float:
        """Total SpGEMM time in ms; the mask build is excluded."""
        return (self.mem_alloc + self.symbolic_binning +
                self.calculate_c_nnz + self.malloc_c_col_val +
                self.numeric_binning + self.numeric)


class PhaseTimer:
    """``with PhaseTimer.phase(t, "numeric"): ...`` adds the block's
    wall time to ``t.numeric`` (the caller fences the device inside)."""

    class _Ctx:
        def __init__(self, timing: Timing, field: str):
            self.timing, self.field = timing, field

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = (time.perf_counter() - self.t0) * 1e3
            setattr(self.timing, self.field,
                    getattr(self.timing, self.field) + dt)
            return False

    @staticmethod
    def phase(timing: Timing, field: str) -> "PhaseTimer._Ctx":
        assert field in _PHASES, field
        return PhaseTimer._Ctx(timing, field)


def gflops(intprod: int, total_ms: float) -> float:
    """2 * intprod / (ms * 1e6)."""
    if total_ms <= 0:
        return 0.0
    return 2.0 * intprod / (total_ms * 1e6)


def device_fence(device) -> None:
    """Wait until ``device`` has finished all queued work (a no-op for
    the CPU, where torch runs synchronously)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
