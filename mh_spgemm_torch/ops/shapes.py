"""Capacity quantization: every host-read dynamic size (entries per
chunk, rows per chunk, nnz(C)) is rounded up to a small geometric grid
{8, 10, 12, 14} x 2^k, at most 25% padding per size.  The planner's
class shapes depend on it, so the port keeps the JAX package's grid
exactly and its plans stay array-for-array equal.  ``quantize_pow2``
bounds scan pass counts; ``pad1`` pads a host array to a capacity."""

from __future__ import annotations

import numpy as np

_MANTISSAS = (8, 10, 12, 14)


def quantize(n: int, min_size: int = 8) -> int:
    """Round ``n`` up to the next grid size {8,10,12,14} * 2^k."""
    n = max(int(n), min_size)
    if n <= _MANTISSAS[0]:
        return _MANTISSAS[0]
    k = max(0, (n - 1).bit_length() - 4)
    while True:
        for m in _MANTISSAS:
            c = m << k
            if c >= n:
                return c
        k += 1


def quantize_pow2(n: int, min_size: int = 1) -> int:
    """Round up to the next power of two (for scan pass bounds)."""
    n = max(int(n), min_size)
    return 1 << (n - 1).bit_length() if n > 1 else 1


def pad1(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Pad a 1-D host array to ``size`` with ``fill`` (no-op if exact)."""
    if x.shape[0] == size:
        return x
    assert x.shape[0] < size, (x.shape, size)
    out = np.full((size,), fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out
