"""Masked engine on the bucketed class machinery — the port of
``mh_spgemm_tpu/ops/masked_classes.py``.

The engine keeps the MH-SpGEMM paper's two stages inside the bucketed
engine's row classes (planned with ``precompute=False``: the 1.5x width
grid, gather or fill frontends):

* symbolic: per chunk a TILE slab ``[rb, Wt]`` is expanded from B's
  32-column tile bitmap (ops/mask.py) — by the ``ragged_fill`` kernel
  over host-planned (tilecol, tilemask) runs where the plan says so, else
  by gathers — sorted by tile column, OR-accumulated over equal-tile
  runs, and popcounted: the exact nnz of every C row, before any numeric
  work;
* numeric: the bucketed engine's gather or fill frontend and its sort
  tail (sort by column, segment sum, left-pack), as in the JAX package.

The host planning (:func:`host_mask_matrix`, :func:`plan_masked_extras`)
equals the JAX package's array for array.  The device half runs every
chunk of a class at once, as the bucketed engine does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import bucketed as bk
from . import ragged_fill as rf
from .mask import TILE_BITS, mask_stage
from .shapes import quantize

_TILE_LOW = (1 << TILE_BITS) - 1
_TILE_STRIDE = 2               # planes of the tile stream: tilecol, mask
_TILE_FIELDS = ("t_ent_dst", "t_row_len", "t_win", "t_runs")


def host_mask_matrix(b_ptr: np.ndarray, b_col: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tile-mask matrix of B on the host (the numpy twin of
    ``mask.mask_stage``): per B row one ``(tilecol, tilemask)`` pair per
    distinct 32-column tile, in ascending column order.  Returns
    (tiles_per_row int32, tilecol int32, tilemask uint32)."""
    btile = (b_col >> TILE_BITS).astype(np.int64)
    rows_of = np.repeat(np.arange(b_ptr.shape[0] - 1),
                        np.diff(b_ptr))
    starts = np.ones(b_col.shape[0], bool)
    starts[1:] = (rows_of[1:] != rows_of[:-1]) | (btile[1:] != btile[:-1])
    tiles_per_row = np.bincount(rows_of[starts],
                                minlength=b_ptr.shape[0] - 1)
    tilecol = btile[starts].astype(np.int32)
    bit = (np.uint32(1) << (b_col & _TILE_LOW).astype(np.uint32))
    if b_col.size:
        tilemask = np.bitwise_or.reduceat(bit, np.flatnonzero(starts))
    else:
        tilemask = np.zeros(0, np.uint32)
    return tiles_per_row.astype(np.int32), tilecol, \
        tilemask.astype(np.uint32)


def plan_masked_extras(plan: bk.BucketPlan, a_ptr: np.ndarray,
                       a_col: np.ndarray, b_ptr: np.ndarray,
                       b_col: np.ndarray, dma_fill: str = "off"
                       ) -> Tuple[np.ndarray, List[dict],
                                  Optional[np.ndarray]]:
    """Host additions of the masked engine: B's per-row tile counts; per
    class the static tile-slab width Wt (the quantized largest per-row
    tile total, at least 8); and, where ``dma_fill`` (resolved: "off",
    "auto", "on") allows and the cost model agrees, a ``ragged_fill``
    plan for the tile slab, built by the same run machinery as the
    product slab.  Returns (tiles_per_row, extras, tile stream or
    None)."""
    tiles_per_row, tilecol_h, tilemask_h = host_mask_matrix(b_ptr, b_col)
    btileptr = np.concatenate(
        [[0], np.cumsum(tiles_per_row)]).astype(np.int64)
    # per C row: total tiles streamed = sum over its entries
    tcs = np.concatenate([[0], np.cumsum(tiles_per_row[a_col])])
    t_row = tcs[a_ptr[1:]] - tcs[a_ptr[:-1]]
    fill_ok = (dma_fill in ("auto", "on")
               and int(btileptr[-1]) * _TILE_STRIDE < 2**31)
    force = dma_fill == "on"
    extras = []
    any_fill = False
    for c in plan.classes:
        rows = c.rows_g.reshape(-1)
        live = rows[rows >= 0]
        wt = int(t_row[live].max()) if live.size else 1
        wt = max(8, quantize(wt))
        e = {"Wt": wt, "t_hold": bk._log2_bound(wt), "t_fill": False,
             "t_wrows": 0, "t_out_rows": 0}
        extras.append(e)
        if not fill_ok:
            continue
        # tile entry descriptors per chunk: src = first tile of the hit B
        # row, len = its tile count, dst = the in-row running offset in
        # the [rb, Wt] tile slab (entries are in dst order)
        wrows = bk._fill_wrows(wt, 1)
        wins, runss, tds = [], [], []
        t_row_len = np.zeros((c.nchunks, c.rb), np.int32)
        for k in range(c.nchunks):
            lv = c.ent_len[k] > 0
            cols = a_col[c.ent_aidx[k]]
            tl = np.where(lv, tiles_per_row[cols], 0).astype(np.int64)
            slot = np.minimum(c.ent_dst[k] // c.W, c.rb)
            cs = np.cumsum(tl)
            first = np.ones(tl.size, bool)
            first[1:] = slot[1:] != slot[:-1]
            base = np.maximum.accumulate(np.where(first, cs - tl, 0))
            toff = cs - tl - base
            tdst = np.where(lv & (slot < c.rb), slot * wt + toff,
                            c.rb * wt).astype(np.int64)
            tsrc = btileptr[cols]
            w, r = bk._plan_runs_chunk(tsrc.astype(np.int64), tdst, tl, 1,
                                       c.rb * wt, wrows, bk._FILL_EPG)
            wins.append(w)
            runss.append(r)
            tds.append(tdst.astype(np.int32))
            np.add.at(t_row_len[k], np.minimum(slot, c.rb - 1),
                      np.where(lv & (slot < c.rb), tl, 0).astype(
                          np.int32))
        if not (force or bk.fill_beats_gather(wins, wt * c.rb * c.nchunks)):
            continue
        t_win, t_runs = bk._pad_steps(wins, runss)
        e.update(t_fill=True, t_wrows=wrows,
                 t_out_rows=-(-(c.rb * wt) // 128),     # per plane
                 t_win=t_win, t_runs=t_runs,
                 t_ent_dst=np.stack(tds), t_row_len=t_row_len)
        any_fill = True
    tile_pairs = None
    if any_fill:
        wrows_max = max(e["t_wrows"] for e in extras)
        tile_pairs = bk.build_pairs_planar(tilecol_h, tilemask_h, 1,
                                           wrows_max)
    return tiles_per_row, extras, tile_pairs


def upload_operands(A, B, plan: bk.BucketPlan, extras: List[dict],
                    tiles_per_row: np.ndarray,
                    tile_pairs: Optional[np.ndarray], vdtype: torch.dtype,
                    device) -> dict:
    """Everything the masked main stage reads, on ``device``: the values
    and columns, B's mask matrix (``mask.mask_stage`` on the device),
    the fill streams, and each class's tensors (the bucketed plan's, plus
    the tile-slab descriptors of tile-fill classes)."""
    dev = torch.device(device)

    def up(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    np_dt = np.float64 if vdtype == torch.float64 else np.float32
    ops = {"a_val": up(A.val, np_dt), "b_val": up(B.val, np_dt),
           "a_col": up(A.col, np.int32), "b_col": up(B.col, np.int32),
           "tiles_per_row": up(tiles_per_row, np.int32)}
    ops["mask"] = mask_stage(up(B.ptr, np.int32), ops["b_col"],
                             up(B.ptr, np.int32), ops["b_col"]).mask
    ops["pairs"] = (up(bk.build_pairs_planar(
        B.col, B.val.astype(np_dt), plan.vwords, bk.pairs_wrows_max(plan)))
        if bk.needs_pairs(plan) else None)
    ops["tile_pairs"] = None if tile_pairs is None else up(tile_pairs)
    bk.upload_plan(plan, dev)
    ops["classes"] = [
        dict(d, **{k: up(e[k]) for k in _TILE_FIELDS}) if e["t_fill"]
        else d for d, e in zip(plan.dev, extras)]
    return ops


def _entry_tile_seeds(d: dict, ops: dict, *, W: int, rb: int, Wt: int):
    """Tile-slab entry descriptors on the device, per chunk: src and len
    from the mask matrix by entry-granularity gathers, dst from an
    in-row exclusive cumsum over the row-ordered entries.  Returns
    (tsrc, tlen, tdst), int32[nchunks, eb]; padding entries get dst
    ``rb * Wt``."""
    ent_dst, ent_len = d["ent_dst"], d["ent_len"]
    cols = ops["a_col"][d["ent_aidx"].long()].long()
    tsrc = ops["mask"].tileptr[cols]
    tlen = torch.where(ent_len > 0, ops["tiles_per_row"][cols], 0)
    row = ent_dst // W                  # pad entries: row rb
    cs = torch.cumsum(tlen, dim=1, dtype=torch.int32)
    first = torch.ones_like(row, dtype=torch.bool)
    first[:, 1:] = row[:, 1:] != row[:, :-1]
    base = torch.cummax(torch.where(first, cs - tlen, -1), dim=1).values
    toff = cs - tlen - base
    tdst = torch.where((ent_len > 0) & (row < rb), row * Wt + toff, rb * Wt)
    return tsrc, tlen, tdst.to(torch.int32)


def tile_front_gather(d: dict, ops: dict, *, W: int, rb: int, Wt: int):
    """Tile slab by gathers: per-entry tile descriptors, held down each
    entry's tile span, and one gather of (tilecol, tilemask) per slot.
    Returns (tc, tm), ``[nchunks * rb, Wt]``; empty slots hold 2^31-1
    and 0."""
    tsrc, tlen, tdst = _entry_tile_seeds(d, ops, W=W, rb=rb, Wt=Wt)
    nch = tdst.shape[0]
    RT = rb * Wt
    kw = dict(rows=nch * rb, RW=RT, W=Wt)
    starts = bk._seed(tdst, torch.ones_like(tdst, dtype=torch.bool),
                      fill=False, **kw)
    src0, len0, pos0 = bk._hold_rows(starts, bk._seed(tdst, tsrc, **kw),
                                     bk._seed(tdst, tlen, **kw),
                                     bk._seed(tdst, tdst, **kw))
    tpos = torch.arange(RT, dtype=torch.int32, device=tdst.device).view(
        rb, Wt).repeat(nch, 1)
    toff = tpos - pos0
    tvalid = (toff >= 0) & (toff < len0)
    tread = torch.where(tvalid, src0 + toff, 0).long()
    mask = ops["mask"]
    tc = torch.where(tvalid, mask.tilecol[tread], bk.I32_MAX)
    tm = torch.where(tvalid, mask.tilemask[tread], 0)
    return tc, tm


def tile_front_fill(d: dict, tile_pairs, *, rb: int, Wt: int,
                    t_out_rows: int):
    """Tile slab by one ``ragged_fill`` launch over all chunks: the
    (tilecol, tilemask) spans stream in as planar runs planned on the
    host.  Returns (tc, tm), ``[nchunks * rb, Wt]``."""
    slab = rf.ragged_fill(d["t_win"], d["t_runs"], tile_pairs,
                          out_rows=_TILE_STRIDE * t_out_rows,
                          nplanes=_TILE_STRIDE,
                          src_stride_rows=tile_pairs.shape[0]
                          // _TILE_STRIDE,
                          dst_stride=t_out_rows * 128)
    tc, tm = bk.slab_planes(slab, nplanes=_TILE_STRIDE, out_rows=t_out_rows,
                            rb=rb, W=Wt)
    tvalid = (torch.arange(Wt, device=slab.device)[None, :]
              < d["t_row_len"].reshape(-1, 1))
    return torch.where(tvalid, tc, bk.I32_MAX), torch.where(tvalid, tm, 0)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (int32 in, int32 out)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def symbolic_rows(tc: torch.Tensor, tm: torch.Tensor,
                  t_hold: int) -> torch.Tensor:
    """Exact nnz per C row from its tile slab: sort by tile column, OR
    the masks of equal tiles (the ``atomicOr`` accumulation analogue),
    popcount each distinct tile's mask and sum (the reference's hash +
    atomicOr + popc reduction)."""
    sc, order = torch.sort(tc, dim=1, stable=True)
    sm = torch.gather(tm, 1, order)
    new = torch.ones_like(sc, dtype=torch.bool)
    new[:, 1:] = sc[:, 1:] != sc[:, :-1]
    orm = bk.seg_scan_rows(sm, new, t_hold, op=torch.bitwise_or)
    ends = torch.ones_like(new)
    ends[:, :-1] = new[:, 1:]
    ends &= sc < bk.I32_MAX
    return torch.where(ends, popcount32(orm), 0).sum(dim=1,
                                                     dtype=torch.int32)


def class_tiles(c: bk.ClassPlan, e: dict, d: dict, ops: dict):
    """The tile slab of class ``c``, by its extras' frontend."""
    if e["t_fill"]:
        return tile_front_fill(d, ops["tile_pairs"], rb=c.rb, Wt=e["Wt"],
                               t_out_rows=e["t_out_rows"])
    return tile_front_gather(d, ops, W=c.W, rb=c.rb, Wt=e["Wt"])


def masked_main(plan: bk.BucketPlan, extras: List[dict], ops: dict):
    """Whole-matrix masked main stage, with the bucketed engine's output
    contract so the extraction is shared: per class the symbolic row
    counts, then the numeric slab (the class's gather or fill frontend
    and the sort tail, as in the JAX package).  Returns (crow, cptr,
    totals, slabs)."""
    slabs = []
    for c, e, d in zip(plan.classes, extras, ops["classes"]):
        tc, tm = class_tiles(c, e, d, ops)
        crow_nnz = symbolic_rows(tc, tm, e["t_hold"])
        del tc, tm
        front = bk.class_front(c, d, ops["a_val"], ops["b_col"],
                               ops["b_val"], ops["pairs"])
        oC, oV, _ = bk.class_tail(c, front, route="sort",
                                  counts=plan.tail_slots)
        slabs.append((oC, oV, crow_nnz))
    crow, cptr, totals = bk.bucketed_counts(plan, slabs)
    return crow, cptr, totals, slabs


def masked_fused(plan: bk.BucketPlan, extras: List[dict], ops: dict):
    """Warm path (the plan knows nnz(C)): main stage then extraction
    (windowed or static), queued with no host sync between them.
    Returns (cptr, ccol, cval)."""
    _, _, _, slabs = masked_main(plan, extras, ops)
    ccol, cval = bk.extract_warm(plan, slabs)
    return bk.static_dev(plan)[1], ccol, cval
