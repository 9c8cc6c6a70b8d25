"""The port's tracing: program spans on the profiler's clock
(:func:`span`), the seven phase fields of the reference's ``Timing``
(``total`` excludes ``form_mask_matrix_b``; sums and averages over
iterations, ``print_step_time``), a context helper that opens a phase's
span and adds the block's wall time to one field, and ``gflops``.

A span is a ``torch.profiler.record_function`` range named
``mh::<name>``, opened only while a profiler records: any
``torch.profiler.profile`` around a call shows the program's stages on
the same clock as the kernels they launch.  With no profiler recording
a span is one shared no-op context: no clock read, no device sync.

A phase's wall time means the device's time only when the block ends
in a device fence (:func:`device_fence`, ``torch.cuda.synchronize``):
PyTorch returns from a CUDA call before the card has finished.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

SPAN_PREFIX = "mh::"

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

    def __iadd__(self, other: "Timing") -> "Timing":
        for f in _PHASES:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def __itruediv__(self, k: float) -> "Timing":
        for f in _PHASES:
            setattr(self, f, getattr(self, f) / k)
        return self

    def total(self) -> float:
        """Total SpGEMM time in ms; the mask build is excluded."""
        return (self.mem_alloc + self.symbolic_binning +
                self.calculate_c_nnz + self.malloc_c_col_val +
                self.numeric_binning + self.numeric)

    def print_step_time(self) -> None:
        print(f"mem_alloc          = {self.mem_alloc:9.3f} ms")
        print(f"Form_mask_matrix_B = {self.form_mask_matrix_b:9.3f} ms")
        print(f"symbolic_binning   = {self.symbolic_binning:9.3f} ms")
        print(f"Calculate_C_nnz    = {self.calculate_c_nnz:9.3f} ms")
        print(f"Malloc_C_col_val   = {self.malloc_c_col_val:9.3f} ms")
        print(f"numeric_binning    = {self.numeric_binning:9.3f} ms")
        print(f"Numeric            = {self.numeric:9.3f} ms")

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in _PHASES}
        d["total"] = self.total()
        return d


class _NoSpan:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **args):
    """A ``mh::<name>`` range while a ``torch.profiler`` records, with
    ``args`` (such as ``W=384``) as its argument string; otherwise the
    shared no-op context.  Never synchronizes the device or reads a
    tensor."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(
        SPAN_PREFIX + name,
        ",".join(f"{k}={v}" for k, v in args.items()) if args else None)


class PhaseTimer:
    """``with PhaseTimer.phase(t, "numeric"): ...`` opens the phase's
    span and, where a :class:`Timing` is given, adds the block's wall
    time to ``t.numeric`` (the caller fences the device inside)."""

    class _Ctx:
        __slots__ = ("timing", "field", "rf", "t0")

        def __init__(self, timing: Timing, field: str):
            self.timing, self.field = timing, field

        def __enter__(self):
            self.rf = span(self.field)
            self.rf.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = (time.perf_counter() - self.t0) * 1e3
            setattr(self.timing, self.field,
                    getattr(self.timing, self.field) + dt)
            return self.rf.__exit__(*exc)

    @staticmethod
    def phase(timing: Optional[Timing], field: str):
        assert field in _PHASES, field
        if timing is None:
            return span(field)
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
