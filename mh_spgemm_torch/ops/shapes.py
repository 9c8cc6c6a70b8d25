"""Capacity quantization: every host-read dynamic size (entries per
chunk, rows per chunk, nnz(C)) is rounded up to a small geometric grid
{8, 10, 12, 14} x 2^k, at most 25% padding per size.  The planner's
class shapes depend on it, so the port keeps the JAX package's grid
exactly and its plans stay array-for-array equal."""

from __future__ import annotations

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
