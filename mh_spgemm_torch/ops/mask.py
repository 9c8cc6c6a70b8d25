"""B mask-matrix formation — the port of ``mh_spgemm_tpu/ops/mask.py``
(``MaskMatrix``, ``mask_stage``, and the standalone pieces
``count_tiles``, ``form_mask_matrix``, ``flops_upper_bound`` and
``flops_exact`` that tests and tools use).

Each B row is re-encoded as a list of 32-column tiles ``(tilecol,
tilemask)``: bit k of a tile's mask means column ``32*tilecol + k`` is
nonzero.  Columns are sorted within each row, so tile boundaries are the
positions where ``col >> 5`` changes, and a tile's mask is the in-run
sum of its distinct bits.  :func:`mask_stage` forms the mask at capacity
nnz(B) (tiles per row never exceed nonzeros per row) and the per-C-row
work estimates in one pass of torch ops on the operands' device.

Masks are ``uint32`` in the JAX package; the port keeps the same 32 bits
in ``int32`` tensors (``.numpy().view(np.uint32)`` reads them back).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .scan import (compact, exclusive_cumsum, row_ids, rows_reduce_int,
                   take)

TILE_BITS = 5                       # 32-column tiles


class MaskMatrix(NamedTuple):
    """Compressed bitmap mask matrix of B; ``tilecol`` / ``tilemask`` are
    nnz(B) long, zero past the true tile count."""

    tileptr: torch.Tensor      # int32[M+1] exclusive scan of tiles per row
    tilecol: torch.Tensor      # int32[cap]  tile column (= col >> 5)
    tilemask: torch.Tensor     # int32[cap]  the 32 mask bits
    nnz_to_tile: torch.Tensor  # int32[nnzB] global tile of each nonzero


class MaskStage(NamedTuple):
    """Output of :func:`mask_stage`."""

    mask: MaskMatrix
    fub_row: torch.Tensor      # int32[M_A]  flop upper bound per C row
    prod_row: torch.Tensor     # int32[M_A]  exact products per C row
    totals: torch.Tensor       # int64[3]    [tiles, t_prime, intprod]
    max_arow: torch.Tensor     # int32[]     max nnz of an A row


def _run_starts(rows: torch.Tensor, btile: torch.Tensor) -> torch.Tensor:
    """True where a new (row, tile) run begins in the CSR stream."""
    start = torch.ones_like(rows, dtype=torch.bool)
    start[1:] = (rows[1:] != rows[:-1]) | (btile[1:] != btile[:-1])
    return start


def as_bits32(x: torch.Tensor) -> torch.Tensor:
    """Values in [0, 2^32) (int64) as the int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mask_stage(b_ptr: torch.Tensor, b_col: torch.Tensor,
               a_ptr: torch.Tensor, a_col: torch.Tensor) -> MaskStage:
    """Mask matrix of B plus the per-C-row work estimates of A @ B (all
    inputs int32 on one device)."""
    nnz_b = b_col.shape[0]
    dev = b_col.device
    valid_b = torch.arange(nnz_b, device=dev) < b_ptr[-1]
    btile = b_col >> TILE_BITS
    rows = row_ids(b_ptr, nnz_b)
    is_start = _run_starts(rows, btile) & valid_b

    tiles_per_row = rows_reduce_int(is_start.to(torch.int32), b_ptr)
    tileptr = exclusive_cumsum(tiles_per_row, dtype=torch.int32)
    nnz_to_tile = (torch.cumsum(is_start, 0, dtype=torch.int32) - 1)

    tilecol = compact(btile, is_start, nnz_b)
    run_start = compact(torch.arange(nnz_b, device=dev), is_start, nnz_b,
                        fill=nnz_b)
    run_end = torch.cat([run_start[1:],
                         torch.full((1,), nnz_b, device=dev)])
    bits = torch.where(valid_b,
                       torch.ones((), dtype=torch.int64, device=dev)
                       << (b_col & ((1 << TILE_BITS) - 1)).long(), 0)
    bitcum = torch.cumsum(bits, 0)

    def before(idx):            # sum of bits[:idx]
        return torch.where(idx > 0, bitcum[(idx - 1).clamp(min=0)], 0)

    tilemask = as_bits32(before(run_end) - before(run_start))
    mask = MaskMatrix(tileptr=tileptr, tilecol=tilecol, tilemask=tilemask,
                      nnz_to_tile=nnz_to_tile)

    # clamped gathers, as JAX's: the class-based masked engine passes B
    # as both operands, whose column indices may pass B's row count
    ac = a_col.long()
    fub_row = rows_reduce_int(take(tiles_per_row, ac), a_ptr)
    prod_row = rows_reduce_int(take(b_ptr, ac + 1) - take(b_ptr, ac), a_ptr)
    totals = torch.stack([tiles_per_row.sum(dtype=torch.int64),
                          fub_row.sum(dtype=torch.int64),
                          prod_row.sum(dtype=torch.int64)])
    arow = a_ptr[1:] - a_ptr[:-1]
    return MaskStage(mask=mask, fub_row=fub_row, prod_row=prod_row,
                     totals=totals,
                     max_arow=arow.max() if arow.numel() else arow.sum())


# ---------------------------------------------------------------------------
# Standalone pieces (tests and tools; the pipeline uses mask_stage)
# ---------------------------------------------------------------------------

def count_tiles(ptr: torch.Tensor, col: torch.Tensor, m: int, nnz: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row distinct-tile counts (int32[m]) and their total.  ``col``
    may be padded past ``nnz``; the padding is not read."""
    valid = torch.arange(nnz, device=col.device) < ptr[-1]
    btile = col[:nnz] >> TILE_BITS
    rows = row_ids(ptr, nnz)
    is_start = _run_starts(rows, btile) & valid
    tiles_per_row = rows_reduce_int(is_start.to(torch.int32), ptr)
    return tiles_per_row, tiles_per_row.sum()


def form_mask_matrix(ptr: torch.Tensor, col: torch.Tensor, m: int,
                     nnz: int, total_tiles: int) -> MaskMatrix:
    """The mask matrix with a tile array of exactly ``total_tiles``
    entries (the host-read true count)."""
    mk = mask_stage(ptr, col[:nnz], ptr, col[:nnz]).mask
    return MaskMatrix(tileptr=mk.tileptr, tilecol=mk.tilecol[:total_tiles],
                      tilemask=mk.tilemask[:total_tiles],
                      nnz_to_tile=mk.nnz_to_tile)


def flops_upper_bound(a_ptr: torch.Tensor, a_col: torch.Tensor,
                      tiles_per_row_b: torch.Tensor, nnz_a: int
                      ) -> torch.Tensor:
    """Per-C-row flop upper bound: the sum over A(i,:) of the tile counts
    of the B rows it references."""
    return rows_reduce_int(take(tiles_per_row_b, a_col[:nnz_a].long()),
                           a_ptr)


def flops_exact(a_ptr: torch.Tensor, a_col: torch.Tensor,
                b_ptr: torch.Tensor, nnz_a: int) -> torch.Tensor:
    """Per-C-row intermediate-product count."""
    ac = a_col[:nnz_a].long()
    return rows_reduce_int(take(b_ptr, ac + 1) - take(b_ptr, ac), a_ptr)
