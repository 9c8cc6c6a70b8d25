"""Symbolic stage: exact nnz(C) per row and C's tile structure — the port
of ``mh_spgemm_tpu/ops/symbolic.py``.

The tile-granularity product stream (one item per A nonzero and tile of
the B row it references, already grouped by C row) is sorted by (row,
tile column), the tile masks of each run are OR-ed by a segmented scan,
and each run end's popcount is its C row's share of nnz(C).  Torch has no
lexicographic sort over several keys, so the two keys pack into one
int64, ``row << 32 | tilecol``, sorted stably; its permutation carries
the payloads.  Tile masks are int32 bit patterns (``ops/mask.py``).

The only host sizes are the stream capacity ``total`` and the scan pass
bound ``max_group``; every other size comes from tensor extents, and the
inputs may be capacity-padded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .expand import expand_products
from .mask import TILE_BITS, MaskMatrix
from .masked_classes import popcount32
from .scan import compact, exclusive_cumsum, rows_reduce_int, seg_scan, take


class SymbolicResult(NamedTuple):
    """Everything the numeric stage needs about C's structure."""

    crow_nnz: torch.Tensor         # int32[M]   exact nnz per C row
    ctiles_row: torch.Tensor       # int32[M]   C tiles per row
    run_id_unsorted: torch.Tensor  # int32[T'] C-tile id of each stream item
    sort_row: torch.Tensor         # int32[T']  sorted stream: C row
    sort_tcol: torch.Tensor        # int32[T']  sorted stream: tile column
    or_mask: torch.Tensor          # int32[T']  OR scan (totals at run ends)
    is_end: torch.Tensor           # bool[T']   True at run ends (valid runs)
    totals: torch.Tensor           # int64[2]   [nnz_C, tile count Tc]


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor):
    """Stable sort by (hi, lo), both nonnegative int32: returns the sorted
    ``hi``, the sorted ``lo`` and the permutation (int64)."""
    key = (hi.to(torch.int64) << 32) | lo.to(torch.int64)
    skey, perm = torch.sort(key, stable=True)
    return (skey >> 32).to(torch.int32), \
        (skey & 0xFFFFFFFF).to(torch.int32), perm


def symbolic(a_ptr: torch.Tensor, a_col: torch.Tensor, mask: MaskMatrix,
             total: int, max_group: int) -> SymbolicResult:
    """Exact symbolic pass over the tile-granularity product stream.
    ``total`` is the quantized T' (flop upper bound, read by the host),
    ``max_group`` a bound on the items of one (row, tile column) group
    (at most the longest A row)."""
    m_pad = a_ptr.shape[0] - 1
    dev = a_ptr.device
    ps = expand_products(a_ptr, a_col, mask.tileptr, total, a_col.shape[0])
    tcol = take(mask.tilecol, ps.src)
    tmask = take(mask.tilemask, ps.src)
    crow = torch.where(ps.valid, ps.crow, m_pad)         # padding last

    s_row, s_tcol, s_orig = sort_pairs(crow, tcol)
    s_mask = tmask[s_orig]

    new = _run_starts2(s_row, s_tcol)
    or_scan = seg_scan(torch.bitwise_or, new, s_mask, max_group)
    is_end = torch.cat([new[1:], torch.ones(1, dtype=torch.bool,
                                            device=dev)])
    valid_end = is_end & (s_row < m_pad)
    contrib = torch.where(valid_end, popcount32(or_scan), 0)
    tile_contrib = valid_end.to(torch.int32)

    run_id_sorted = torch.cumsum(new, 0, dtype=torch.int32) - 1
    run_id_unsorted = torch.empty(total, dtype=torch.int32, device=dev)
    run_id_unsorted[s_orig] = run_id_sorted

    # the sorted stream keeps exactly fub_row[i] items for row i, so the
    # row pointer over it is the exclusive cumsum of the upper bound
    ac = a_col.long()
    lens = mask.tileptr[ac + 1] - mask.tileptr[ac]
    fub_row = rows_reduce_int(lens, a_ptr)
    f_ex = exclusive_cumsum(fub_row, dtype=torch.int32)
    crow_nnz = rows_reduce_int(contrib, f_ex)
    ctiles_row = rows_reduce_int(tile_contrib, f_ex)

    totals = torch.stack([crow_nnz.sum(dtype=torch.int64),
                          ctiles_row.sum(dtype=torch.int64)])
    return SymbolicResult(crow_nnz=crow_nnz, ctiles_row=ctiles_row,
                          run_id_unsorted=run_id_unsorted,
                          sort_row=s_row, sort_tcol=s_tcol,
                          or_mask=or_scan, is_end=valid_end,
                          totals=totals)


class CStructure(NamedTuple):
    """Compacted C tile structure and expanded (sorted) column indices."""

    cptr: torch.Tensor        # int32[M+1]
    ccol: torch.Tensor        # int32[nnzC] sorted per row
    ctile_col: torch.Tensor   # int32[Tc]
    ctile_mask: torch.Tensor  # int32[Tc] (32 mask bits)
    ctile_base: torch.Tensor  # int32[Tc+1] value offset of each C tile


def c_structure(sym: SymbolicResult, tc: int, nnz_c: int) -> CStructure:
    """Compact the symbolic run ends into C's tile list and expand the
    tile masks into the per-row-sorted column indices: tiles come out of
    the sort ordered by (row, tile column) and bits are enumerated
    ascending, so C's columns are born sorted.  ``tc`` / ``nnz_c`` are
    quantized capacities (>= the true counts)."""
    flags = sym.is_end
    ctile_col = compact(sym.sort_tcol, flags, tc)
    ctile_mask = compact(sym.or_mask, flags, tc)
    ctile_base = exclusive_cumsum(popcount32(ctile_mask), dtype=torch.int32)

    cptr = exclusive_cumsum(sym.crow_nnz, dtype=torch.int32)

    # expand masks -> columns: a (Tc, 32) grid of candidate bits, compacted
    # (int32 shifts are arithmetic, hence the & 1)
    bit = torch.arange(1 << TILE_BITS, dtype=torch.int32,
                       device=ctile_mask.device)[None, :]
    keep = ((ctile_mask[:, None] >> bit) & 1).to(torch.bool)
    colgrid = (ctile_col[:, None] << TILE_BITS) + bit
    ccol = compact(colgrid.reshape(-1), keep.reshape(-1), nnz_c)
    return CStructure(cptr=cptr, ccol=ccol, ctile_col=ctile_col,
                      ctile_mask=ctile_mask, ctile_base=ctile_base)


def _run_starts2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True where a new (a, b) run begins in a sorted stream."""
    first = torch.ones(1, dtype=torch.bool, device=a.device)
    changed = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    return torch.cat([first, changed])
