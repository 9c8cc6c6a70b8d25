"""Scan and segmented-reduction helpers of the port: its own copies of
``mh_spgemm_tpu/ops/scan.py`` (``exclusive_cumsum``, ``cum_at``,
``rows_reduce_int``, ``seg_scan``, ``seg_sum_at_runs``, ``compact``,
``compact_multi``) and ``mh_spgemm_tpu/ops/expand.py`` (``row_ids``), in
torch, and :func:`take`, a gather whose out-of-range indices clamp into
range as JAX's gathers do (a product stream's padding slots index past
its arrays).

None of them reads a value back to the host, so a caller that knows its
sizes runs them on the card with no synchronisation.
"""

from __future__ import annotations

from typing import Callable

import torch


def exclusive_cumsum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """[x0, x1, ...] -> [0, x0, x0+x1, ..., total]; length n+1."""
    dtype = dtype or x.dtype
    return torch.cat([torch.zeros(1, dtype=dtype, device=x.device),
                      torch.cumsum(x, 0, dtype=dtype)])


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with each index clamped into ``[0, len(x) - 1]``."""
    return x[idx.clamp(0, x.shape[0] - 1)]


def cum_at(incl_cumsum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Prefix sum of the underlying array up to (exclusive) position
    ``idx``, given its inclusive cumsum.  idx in [0, n]."""
    safe = (idx - 1).clamp(min=0)
    return torch.where(idx > 0, incl_cumsum[safe],
                       torch.zeros((), dtype=incl_cumsum.dtype,
                                   device=incl_cumsum.device))


def rows_reduce_int(values: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Per-row sums of an integer stream in CSR order:
    ``out[i] = sum(values[ptr[i]:ptr[i+1]])``, in the values' type."""
    c = exclusive_cumsum(values, dtype=torch.int64)
    p = ptr.long()
    return (c[p[1:]] - c[p[:-1]]).to(values.dtype)


def seg_scan(op: Callable, flags: torch.Tensor, values: torch.Tensor,
             max_seg_len: int) -> torch.Tensor:
    """Segmented inclusive scan of ``values`` under the associative
    ``op`` (``torch.add`` for sums, ``torch.bitwise_or`` for tile masks).
    ``flags`` is True at segment starts; ``max_seg_len`` bounds a
    segment's length, and the scan runs ceil(log2(bound)) Hillis-Steele
    passes.  Each element is the sum of its own segment's prefix in a
    fixed order, with no float difference of running totals, so a sum
    that cancels comes out exactly as the pairwise additions give it."""
    n = values.shape[0]
    v, f = values, flags
    dist = 1
    while dist < max_seg_len and dist < n:
        sv = torch.cat([v[:dist], v[:-dist]])      # ignored where sf
        sf = torch.cat([torch.ones(dist, dtype=torch.bool, device=f.device),
                        f[:-dist]])
        v = torch.where(f, v, op(sv, v))
        f = f | sf
        dist *= 2
    return v


def seg_sum_at_runs(values: torch.Tensor, run_starts: torch.Tensor,
                    max_seg_len: int) -> torch.Tensor:
    """Inclusive segmented sum; read it at run ends for each run's
    total."""
    return seg_scan(torch.add, run_starts, values, max_seg_len)


def compact(values: torch.Tensor, flags: torch.Tensor, out_size: int,
            fill=0) -> torch.Tensor:
    """Stream compaction: ``values[flags]`` in order into ``out_size``
    slots, the tail ``fill``.  Set flags past ``out_size`` are dropped,
    as the JAX package's scatter with ``mode="drop"`` drops them."""
    pos = torch.cumsum(flags, 0, dtype=torch.int64) - 1
    idx = torch.where(flags & (pos < out_size), pos, out_size)
    out = torch.full((out_size + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[idx] = values
    return out[:out_size]


def compact_multi(arrays, flags: torch.Tensor, out_size: int):
    """Compact several same-length arrays with one shared flag stream."""
    return tuple(compact(a, flags, out_size) for a in arrays)


def row_ids(ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row index of every CSR nonzero, ``nnz`` long, int32, as
    ``jnp.repeat(arange(M), diff(ptr), total_repeat_length=nnz)`` gives
    it: empty rows are skipped, and past ``ptr[-1]`` the last row index
    ``M - 1`` repeats.  One count per row start and a cumsum, so no total
    is read back (``ptr[0]`` must be 0)."""
    marks = torch.zeros(nnz + 1, dtype=torch.int32, device=ptr.device)
    starts = ptr[1:-1].long().clamp(max=nnz)     # row i + 1 starts here
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(marks[:nnz], 0, dtype=torch.int32)
