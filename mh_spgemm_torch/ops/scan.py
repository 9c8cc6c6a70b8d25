"""Scan and segmented-reduction helpers of the port: its own copies of
``mh_spgemm_tpu/ops/scan.py`` (``exclusive_cumsum``, ``rows_reduce_int``,
``compact``) and ``mh_spgemm_tpu/ops/expand.py`` (``row_ids``), in
torch."""

from __future__ import annotations

import torch


def exclusive_cumsum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """[x0, x1, ...] -> [0, x0, x0+x1, ..., total]; length n+1."""
    dtype = dtype or x.dtype
    return torch.cat([torch.zeros(1, dtype=dtype, device=x.device),
                      torch.cumsum(x, 0, dtype=dtype)])


def rows_reduce_int(values: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Per-row sums of an integer stream in CSR order:
    ``out[i] = sum(values[ptr[i]:ptr[i+1]])``, in the values' type."""
    c = exclusive_cumsum(values, dtype=torch.int64)
    p = ptr.long()
    return (c[p[1:]] - c[p[:-1]]).to(values.dtype)


def compact(values: torch.Tensor, flags: torch.Tensor, out_size: int,
            fill=0) -> torch.Tensor:
    """Stream compaction: ``values[flags]`` in order, padded with ``fill``
    to ``out_size`` (which must hold every set flag)."""
    pos = torch.cumsum(flags.to(torch.int64), 0) - 1
    idx = torch.where(flags, pos, out_size)
    out = torch.full((out_size + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[idx] = values
    return out[:out_size]


def row_ids(ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row index of every CSR nonzero, ``nnz`` long (past ``ptr[-1]``
    the last row repeats), int32."""
    lens = (ptr[1:] - ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(ptr.shape[0] - 1, dtype=torch.int32,
                     device=ptr.device), lens)
    if rows.numel() >= nnz:
        return rows[:nnz]
    last = rows[-1:] if rows.numel() else rows.new_zeros(1)
    return torch.cat([rows, last.expand(nnz - rows.numel())])
