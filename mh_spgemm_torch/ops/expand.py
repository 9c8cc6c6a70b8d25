"""Gather-expansion of CSR row references — the port of
``mh_spgemm_tpu/ops/expand.py``.

For each A nonzero e (in CSR order) the stream holds the ``lens[e]``
consecutive items of the B-row segment it references, so the stream is
ordered by C row.  Lengths come from the device and the stream's length
is a host capacity: the segment ids are a count of segment starts and a
cumsum (:func:`.scan.row_ids`), where ``torch.repeat_interleave`` would
read the total back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .scan import exclusive_cumsum, row_ids

__all__ = ["Expansion", "ProductStream", "expand_segments",
           "expand_products", "expand_products_sl", "row_ids"]


class Expansion(NamedTuple):
    """A flattened segment expansion of total length P."""

    seg_id: torch.Tensor   # int32[P]  which source element each slot came from
    offset: torch.Tensor   # int32[P]  position within the source segment
    starts: torch.Tensor   # int32[E+1] exclusive cumsum of segment lengths


def expand_segments(lens: torch.Tensor, total: int) -> Expansion:
    """Expand ``E`` segments of device lengths ``lens`` into a flat
    stream of (segment id, offset), ``total`` slots long.  Zero-length
    segments are skipped; past ``sum(lens)`` the last segment id repeats
    with growing offsets (callers mask by comparing against
    ``starts[-1]``)."""
    starts = exclusive_cumsum(lens, dtype=torch.int32)
    seg_id = row_ids(starts, total)
    offset = (torch.arange(total, dtype=torch.int32, device=lens.device)
              - starts[seg_id])
    return Expansion(seg_id=seg_id, offset=offset, starts=starts)


class ProductStream(NamedTuple):
    """The intermediate-product stream of C = A @ B at some granularity.

    ``crow``  int32[P]: C row of each product (nondecreasing).
    ``src``   int32[P]: index into the B-side payload arrays.
    ``a_idx`` int32[P]: index of the originating A nonzero.
    ``valid`` bool[P]:  False for padding slots.
    """

    crow: torch.Tensor
    src: torch.Tensor
    a_idx: torch.Tensor
    valid: torch.Tensor


def expand_products(a_ptr: torch.Tensor, a_col: torch.Tensor,
                    b_seg_ptr: torch.Tensor, total: int,
                    nnz_a: int) -> ProductStream:
    """The product stream: for each A nonzero e with column k, the
    indices ``b_seg_ptr[k] .. b_seg_ptr[k+1]-1`` tagged with e's row.
    ``b_seg_ptr`` is B's row pointer (column granularity, the numeric
    stage) or the mask matrix's ``tileptr`` (tile granularity, the
    symbolic stage).  A nonzeros past ``a_ptr[-1]`` are capacity padding
    and contribute no products."""
    ac = a_col.long()
    starts = b_seg_ptr[ac]
    lens = b_seg_ptr[ac + 1] - starts                   # int32[nnzA]
    return expand_products_sl(a_ptr, a_col, starts, lens, total, nnz_a,
                              a_nnz_valid=a_ptr[-1])


def expand_products_sl(a_ptr: torch.Tensor, a_col: torch.Tensor,
                       b_starts: torch.Tensor, b_lens: torch.Tensor,
                       total: int, nnz_a: int,
                       a_nnz_valid: Optional[torch.Tensor] = None
                       ) -> ProductStream:
    """Product expansion with an explicit (start, length) segment per A
    nonzero: the distributed path's gathered B blocks are not one CSR
    array.  ``a_nnz_valid`` masks padded A nonzeros (shards pad to a
    common capacity)."""
    dev = a_ptr.device
    if a_nnz_valid is not None:
        keep = torch.arange(nnz_a, dtype=torch.int32, device=dev) \
            < a_nnz_valid
        b_lens = torch.where(keep, b_lens, 0)
    ex = expand_segments(b_lens, total)
    a_rows = row_ids(a_ptr, nnz_a)                       # int32[nnzA]
    crow = a_rows[ex.seg_id]
    src = b_starts[ex.seg_id] + ex.offset
    valid = torch.arange(total, dtype=torch.int32, device=dev) \
        < ex.starts[-1]
    return ProductStream(crow=crow, src=src, a_idx=ex.seg_id, valid=valid)
