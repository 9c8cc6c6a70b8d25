"""Numeric stage: value accumulation into C — the port of
``mh_spgemm_tpu/ops/numeric.py``.

* :func:`finish_masked` — the mask-guided path, fused with C's structure
  expansion.  The symbolic stage fixed C's structure, and the tile mask
  gives every intermediate product its destination, ``tile_base +
  popcount(mask & ((1 << bit) - 1))``; accumulation is one
  ``index_add_`` (atomics on the card, so its sums agree with the JAX
  package's within the comparator, not bit for bit).
* :func:`numeric_esc` — fused expand-sort-compress at column
  granularity: the (row, col)-sorted product stream gives nnz(C),
  structure and values in one pass (sort, segmented sum, run-end
  compaction).  No symbolic stage; the robust fallback and the
  differential check of the masked path.

The only host sizes are quantized capacities; true sizes come from
tensor extents or device scalars, so the inputs may be capacity-padded.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .expand import expand_products, expand_products_sl
from .mask import TILE_BITS, MaskMatrix
from .masked_classes import popcount32
from .scan import (compact, exclusive_cumsum, rows_reduce_int, seg_scan,
                   take)
from .symbolic import (CStructure, SymbolicResult, _run_starts2,
                       c_structure, sort_pairs)


def finish_masked(a_ptr, a_col, a_val, b_ptr, b_col, b_val,
                  mask: MaskMatrix, sym: SymbolicResult,
                  total: int, tc: int, nnz_c: int
                  ) -> Tuple[CStructure, torch.Tensor]:
    """Fused C-structure expansion and mask-guided accumulation.
    ``total`` is the quantized intermediate-product count, ``tc`` /
    ``nnz_c`` the quantized C tile and nonzero counts.  Returns
    (structure, values); the values are ``nnz_c`` long with a zero
    tail."""
    cs = c_structure(sym, tc, nnz_c)

    ps = expand_products(a_ptr, a_col, b_ptr, total, a_col.shape[0])
    c = take(b_col, ps.src)

    # product -> symbolic stream item -> C tile
    k = a_col[ps.a_idx].long()
    ac = a_col.long()
    lens_t = mask.tileptr[ac + 1] - mask.tileptr[ac]
    sym_start = exclusive_cumsum(lens_t, dtype=torch.int32)
    s = sym_start[ps.a_idx] + (take(mask.nnz_to_tile, ps.src)
                               - mask.tileptr[k])
    tile = take(sym.run_id_unsorted, s)

    bit = (c & ((1 << TILE_BITS) - 1)).to(torch.int64)
    below = (torch.ones_like(bit) << bit) - 1
    rank = popcount32(take(cs.ctile_mask, tile).to(torch.int64) & below)
    dst = take(cs.ctile_base, tile) + rank

    v = a_val[ps.a_idx] * take(b_val, ps.src)
    v = torch.where(ps.valid, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))
    dst = torch.where(ps.valid, dst, 0)
    cval = torch.zeros(nnz_c, dtype=v.dtype, device=v.device)
    cval.index_add_(0, dst, v)
    return cs, cval


def numeric_masked(a_ptr, a_col, a_val, b_ptr, b_col, b_val,
                   mask: MaskMatrix, sym: SymbolicResult, cs: CStructure,
                   nnz_a: int, total: int, nnz_c: int) -> torch.Tensor:
    """Values only, structure precomputed (the pipeline uses
    :func:`finish_masked`)."""
    tc = cs.ctile_col.shape[0]
    _, cval = finish_masked(a_ptr, a_col, a_val, b_ptr, b_col, b_val,
                            mask, sym, total, tc, nnz_c)
    return cval


class ESCResult(NamedTuple):
    """Capacity-padded output of the fused ESC pipeline."""

    cptr: torch.Tensor       # int32[M+1]  exclusive scan of per-row nnz
    crow_nnz: torch.Tensor   # int32[M]    exact nnz per row
    col_cap: torch.Tensor    # int32[cap]  compacted columns (tail 0)
    val_cap: torch.Tensor    # float[cap]  compacted values
    nnz_total: torch.Tensor  # int32[]     total nnz(C)


def numeric_esc(a_ptr, a_col, a_val, b_ptr, b_col, b_val,
                total: int, cap: int, max_group: int) -> ESCResult:
    """Fused expand-sort-compress SpGEMM.  ``total`` is the quantized
    product-stream capacity, ``cap`` the output capacity (<= total, >=
    nnz(C)); the host reads ``nnz_total`` back and trims.  ``max_group``
    bounds the products of one (row, col) pair (at most the longest A
    row).  A nonzeros past ``a_ptr[-1]`` are capacity padding."""
    ac = a_col.long()
    starts = b_ptr[ac]
    return esc_segments(a_ptr, a_val, starts, b_ptr[ac + 1] - starts,
                        a_ptr[-1], b_col, b_val, total, cap, max_group)


def esc_segments(a_ptr, a_val, b_starts, b_lens, a_nnz_valid, b_col,
                 b_val, total: int, cap: int, max_group: int) -> ESCResult:
    """:func:`numeric_esc` with an explicit (start, length) B segment per
    A nonzero and the count ``a_nnz_valid`` of A nonzeros that are not
    padding: the distributed path's B payload is not one CSR array
    (``parallel/spgemm_dist._shard_esc_kernel``)."""
    m_pad = a_ptr.shape[0] - 1
    nnz_a = b_lens.shape[0]
    dev = a_ptr.device
    keep = torch.arange(nnz_a, dtype=torch.int32, device=dev) < a_nnz_valid
    lens = torch.where(keep, b_lens, 0)
    ps = expand_products_sl(a_ptr, None, b_starts, lens, total, nnz_a)
    c = take(b_col, ps.src)
    crow = torch.where(ps.valid, ps.crow, m_pad)
    s_row, s_col, s_orig = sort_pairs(crow, c)

    # values gathered after the sort (it carries one index, not a value)
    live = s_row < m_pad
    v = a_val[ps.a_idx[s_orig]] * take(b_val, ps.src[s_orig])
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=dev))

    new = _run_starts2(s_row, s_col)
    vsum = seg_scan(torch.add, new, v, max_group)
    is_end = torch.cat([new[1:], torch.ones(1, dtype=torch.bool,
                                            device=dev)]) & live

    # a row's products occupy a contiguous span of the sorted stream
    contrib = is_end.to(torch.int32)
    p_ex = exclusive_cumsum(rows_reduce_int(lens, a_ptr), dtype=torch.int32)
    crow_nnz = rows_reduce_int(contrib, p_ex)
    cptr = exclusive_cumsum(crow_nnz, dtype=torch.int32)

    col_cap = compact(s_col, is_end, cap)
    val_cap = compact(vsum, is_end, cap)
    return ESCResult(cptr=cptr, crow_nnz=crow_nnz, col_cap=col_cap,
                     val_cap=val_cap, nnz_total=contrib.sum(
                         dtype=torch.int32))
