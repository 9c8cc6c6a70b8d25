"""Block-dense SpGEMM engine — the port of
``mh_spgemm_tpu/ops/blockdense.py``.

Matrices whose nonzeros cluster into dense 128 x 128 blocks (banded, FEM,
block-structured) multiply as batched dense block products:

1. densify the nonzero blocks of A and B once into ``[nblk, 128, 128]``
   value tensors and 0/1 pattern tensors (the pattern product keeps
   structural nonzeros whose values cancel);
2. the pair stream: for every C block (i, j), the k with A(i, k) and
   B(k, j) both nonzero, sorted by C block.  Two routes compute the C
   blocks from it:

   * ``"kernel"`` (f32, and f64 unless ``ozaki="off"``): the streaming
     pair-matmul kernels (ops/pair_matmul.py), one for the values and
     ``pair_matmul_f32`` for the patterns, with no ``[npairs, 128, 128]``
     intermediate; the JAX package's fused Pallas and Ozaki kernels;
   * ``"bmm"`` (f64 under ``ozaki="off"``): gather the operand blocks in
     chunks of pairs, ``torch.bmm``, and a segmented sum over the pair
     axis; the JAX package's XLA route;

3. each C block-row becomes a left-packed strip (columns of the row in
   ascending order, survivors of the structural pattern first), and the
   bucketed engine's extraction copies the strips into CSR: the windowed
   ``ragged_fill`` copy where the plan's fill mode allows it and the cost
   model agrees, else the gather.

The host planner is numpy and equals the JAX planner array for array.
The routing costs (:func:`_per_elem_s`) are the JAX package's TPU v5e
figures, kept so that ``mode="auto"`` picks the same engine; they are
not measured on the H100.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import bucketed as bucketed_ops
from .pair_matmul import pair_matmul_f32, pair_matmul_f64
from .shapes import quantize

BS = 128


# ---------------------------------------------------------------------------
# Host planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StripClass:
    """C block-rows with the same (quantized) block count nj."""

    nj: int                      # blocks per strip (padded)
    nrows_blk: int               # number of block-rows in this class
    blk_rows: np.ndarray         # int32[nrows_blk] block-row ids
    cb_idx: np.ndarray           # int32[nrows_blk, nj] C block ids (-1 pad)


@dataclasses.dataclass
class BlockPlan:
    """Host plan of the block-dense engine, cached per (A, B)."""

    m: int
    n: int
    mb: int                      # ceil(m / BS)
    nab: int                     # nonzero A blocks
    nbb: int
    ncb: int                     # candidate C blocks
    npairs: int
    # densification scatter indices (per CSR entry, used once)
    a_blk_of_ent: np.ndarray     # int32[nnzA]  dense A block of the entry
    a_pos_of_ent: np.ndarray     # int32[nnzA]  r%BS * BS + c%BS
    b_blk_of_ent: np.ndarray
    b_pos_of_ent: np.ndarray
    # pair stream, sorted by C block
    pair_a: np.ndarray           # int32[npairs] A block index
    pair_b: np.ndarray           # int32[npairs] B block index
    pair_new: np.ndarray         # bool[npairs]  True where a C block starts
    cb_i: np.ndarray             # int32[ncb]    C block row
    cb_j: np.ndarray             # int32[ncb]    C block column
    end_pair: np.ndarray         # int32[ncb]    last pair of each C block
    seg_passes: int              # log2 bound on pairs per C block
    max_seg: int = 1             # most pairs of one C block
    strips: list = dataclasses.field(default_factory=list)
    slab_row_start: Optional[np.ndarray] = None  # int32[m]
    flops: int = 0               # 2 * npairs * BS^3
    route: str = "kernel"        # "kernel" or "bmm" (see the module doc)
    device: Optional[torch.device] = None        # where ``dev`` lives
    dev: Optional[dict] = None
    nnz_c: Optional[int] = None
    nnz_cap: Optional[int] = None
    crow_h: Optional[np.ndarray] = None  # learned per-row nnz(C) (host)
    # windowed extraction: the resolved fill mode ("off", "auto", "on"),
    # the plan (None: the gather extraction), and its inputs
    dma_fill: str = "off"
    ext: Optional[bucketed_ops.ExtractPlan] = None
    ext_area: Optional[int] = None       # strip slab slots
    ext_nplanes: Optional[int] = None    # column + value word planes

    def stats(self) -> dict:
        """Block-occupancy counters, with the JAX package's keys."""
        dense_elems = self.ncb * BS * BS
        return {
            "engine": "blockdense",
            "a_blocks": self.nab, "b_blocks": self.nbb,
            "c_blocks": self.ncb, "pairs": self.npairs,
            "mxu_flops": self.flops,
            "nnz_c": self.nnz_c,
            "c_fill": (round(self.nnz_c / dense_elems, 4)
                       if self.nnz_c else None),
            "strip_classes": [
                {"nj": s.nj, "block_rows": s.nrows_blk}
                for s in self.strips
            ],
        }


def plan_blockdense(a_ptr: np.ndarray, a_col: np.ndarray,
                    b_ptr: np.ndarray, b_col: np.ndarray,
                    m: int, k: int, n: int,
                    max_pairs: int = 16384) -> Optional[BlockPlan]:
    """Build the block plan, or None when the engine cannot take the
    product: an empty operand, a pair stream longer than ``max_pairs``,
    or a strip slab past int32 indexing."""
    nnz_a, nnz_b = a_ptr[-1], b_ptr[-1]
    if nnz_a == 0 or nnz_b == 0:
        return None
    mb = -(-m // BS)

    def block_index(ptr, col, nrows):
        rows = np.repeat(np.arange(nrows, dtype=np.int64),
                         np.diff(ptr)).astype(np.int64)
        bi, bj = rows // BS, col.astype(np.int64) // BS
        key = bi * (1 << 32) + bj
        uniq, inv = np.unique(key, return_inverse=True)
        pos = (rows % BS) * BS + (col.astype(np.int64) % BS)
        return (uniq >> 32).astype(np.int32), \
            (uniq & 0xFFFFFFFF).astype(np.int32), \
            inv.astype(np.int32), pos.astype(np.int32)

    abi, abj, a_inv, a_pos = block_index(a_ptr, a_col[:nnz_a], m)
    bbi, bbj, b_inv, b_pos = block_index(b_ptr, b_col[:nnz_b], k)
    nab, nbb = abi.size, bbi.size

    # join A blocks (i, kb) with B block-rows kb -> pairs (i, kb, j)
    border = np.lexsort((bbj, bbi))
    bbi_s, bbj_s = bbi[border], bbj[border]
    kb_ptr = np.zeros(-(-k // BS) + 1, dtype=np.int64)
    np.add.at(kb_ptr, bbi_s + 1, 1)
    np.cumsum(kb_ptr, out=kb_ptr)
    deg = (kb_ptr[abj + 1] - kb_ptr[abj]).astype(np.int64)
    npairs = int(deg.sum())
    if npairs == 0 or npairs > max_pairs:
        return None
    pa = np.repeat(np.arange(nab, dtype=np.int64), deg)
    base = np.repeat(kb_ptr[abj] - np.concatenate(
        [[0], np.cumsum(deg)[:-1]]), deg)
    bslot = base + np.arange(npairs, dtype=np.int64)
    pb = border[bslot].astype(np.int64)
    ci = abi[pa].astype(np.int64)
    cj = bbj_s[bslot].astype(np.int64)

    order = np.lexsort((cj, ci))
    pa, pb, ci, cj = pa[order], pb[order], ci[order], cj[order]
    ckey = ci * (1 << 32) + cj
    new = np.concatenate([[True], ckey[1:] != ckey[:-1]])
    cb_i = ci[new].astype(np.int32)
    cb_j = cj[new].astype(np.int32)
    ncb = int(new.sum())
    starts = np.flatnonzero(new)
    end_pair = np.concatenate([starts[1:], [npairs]]) - 1
    seg_len = np.diff(np.concatenate([starts, [npairs]]))
    seg_passes = max(1, int(seg_len.max() - 1).bit_length()) \
        if seg_len.size else 1

    plan = BlockPlan(
        m=m, n=n, mb=mb, nab=nab, nbb=nbb, ncb=ncb, npairs=npairs,
        a_blk_of_ent=a_inv, a_pos_of_ent=a_pos,
        b_blk_of_ent=b_inv, b_pos_of_ent=b_pos,
        pair_a=pa.astype(np.int32), pair_b=pb.astype(np.int32),
        pair_new=new, cb_i=cb_i, cb_j=cb_j,
        end_pair=end_pair.astype(np.int32), seg_passes=seg_passes,
        max_seg=int(seg_len.max()) if seg_len.size else 1,
        flops=2 * npairs * BS ** 3)

    # strip classes: block-rows grouped by quantized nj (#C blocks)
    nj_of = np.bincount(cb_i, minlength=mb)
    cb_order = np.arange(ncb, dtype=np.int64)  # cb already sorted by (i, j)
    cb_starts = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(cb_starts, cb_i + 1, 1)
    np.cumsum(cb_starts, out=cb_starts)
    active = np.flatnonzero(nj_of > 0).astype(np.int32)
    slab_row_start = np.zeros(m, dtype=np.int64)
    base = 0
    for njq in sorted(set(int(quantize(int(x))) for x in nj_of[active])):
        sel = active[quantize_vec(nj_of[active]) == njq]
        cb_idx = np.full((sel.size, njq), -1, dtype=np.int32)
        for t, i in enumerate(sel):
            s, e = cb_starts[i], cb_starts[i + 1]
            cb_idx[t, : e - s] = cb_order[s:e]
        plan.strips.append(StripClass(nj=njq, nrows_blk=sel.size,
                                      blk_rows=sel, cb_idx=cb_idx))
        # strip t covers global rows [sel[t]*BS, +BS); row r's slab row is
        # (strip base) + (r % BS) * (nj*BS)
        W = njq * BS
        for t, i in enumerate(sel):
            lo = i * BS
            hi = min(m, lo + BS)
            slab_row_start[lo:hi] = (base + t * BS * W
                                     + np.arange(hi - lo) * W)
        base += sel.size * BS * W
    if base >= 2**31:
        return None                       # strip slab exceeds int32
    plan.slab_row_start = slab_row_start.astype(np.int32)
    return plan


def quantize_vec(x: np.ndarray) -> np.ndarray:
    return np.array([quantize(int(v)) for v in x], dtype=np.int64)


_PLAN_FIELDS = ("m", "n", "mb", "nab", "nbb", "ncb", "npairs",
                "a_blk_of_ent", "a_pos_of_ent", "b_blk_of_ent",
                "b_pos_of_ent", "pair_a", "pair_b", "pair_new", "cb_i",
                "cb_j", "end_pair", "seg_passes", "max_seg",
                "slab_row_start", "flops")


def blockplan_from_arrays(fields: dict) -> BlockPlan:
    """Rebuild a plan from plain fields, for example ``vars()`` of a JAX
    package ``BlockPlan``: every name in ``_PLAN_FIELDS`` plus
    ``strips``, a list of strip classes (objects or dicts with ``nj``,
    ``nrows_blk``, ``blk_rows``, ``cb_idx``).  A plan that has run
    already carries its learned ``nnz_c``, ``nnz_cap`` and ``crow_h``
    across, so its first call here takes the warm path.  The plan takes
    the default ``"kernel"`` route; set ``route`` for another."""
    kw = {}
    for k in _PLAN_FIELDS:
        v = fields[k]
        if isinstance(v, np.ndarray):
            v = np.ascontiguousarray(v, dtype=bool if k == "pair_new"
                                     else np.int32)
        else:
            v = int(v)
        kw[k] = v
    strips = []
    for s in fields["strips"]:
        s = s if isinstance(s, dict) else vars(s)
        strips.append(StripClass(
            nj=int(s["nj"]), nrows_blk=int(s["nrows_blk"]),
            blk_rows=np.ascontiguousarray(s["blk_rows"], dtype=np.int32),
            cb_idx=np.ascontiguousarray(s["cb_idx"], dtype=np.int32)))
    plan = BlockPlan(strips=strips, **kw)
    if fields.get("nnz_cap") is not None:
        plan.nnz_c = int(fields["nnz_c"])
        plan.nnz_cap = int(fields["nnz_cap"])
        crow = fields.get("crow_h")
        plan.crow_h = (None if crow is None
                       else np.asarray(crow, dtype=np.int32))
    return plan


def _per_elem_s(vdtype: torch.dtype, ozaki: bool) -> float:
    """Seconds per dense pair element, the JAX package's calibration on
    a TPU v5e (not measured on the H100): f32 on the fused pair kernel
    5 ns, f64 on the streaming pair kernel (``ozaki``) 6 ns, f64 on the
    gather + batched-matmul route 15 ns."""
    if vdtype == torch.float32:
        return 5e-9
    return 6e-9 if ozaki else 15e-9


def estimate_blockdense_cost(a_ptr: np.ndarray, a_col: np.ndarray,
                             b_ptr: np.ndarray, b_col: np.ndarray,
                             m: int, k: int, vdtype: torch.dtype,
                             nslices: int = 16,
                             ozaki: bool = False) -> float:
    """Sampled estimate of :func:`blockdense_cost` without building the
    plan: ``nslices`` evenly spaced 128-row block-rows of each operand
    give the mean blocks per block-row, and npairs ~= nab * the mean B
    block-row degree.  Callers keep a margin and run the exact planner
    when the decision is close."""
    nnz_a, nnz_b = int(a_ptr[-1]), int(b_ptr[-1])
    if nnz_a == 0 or nnz_b == 0:
        return float("inf")
    mb = -(-m // BS)
    kb = -(-k // BS)

    def mean_deg(ptr, col, nrows_blk):
        ts = np.unique(np.linspace(0, nrows_blk - 1,
                                   min(nslices, nrows_blk)).astype(
                                       np.int64))
        degs = np.empty(ts.size, np.float64)
        nrows = ptr.shape[0] - 1
        for i, t in enumerate(ts):
            lo = int(t) * BS
            hi = min(nrows, lo + BS)
            cols = col[ptr[lo]: ptr[hi]]
            degs[i] = np.unique(cols // BS).size
        return float(degs.mean())

    est_nab = mean_deg(a_ptr, a_col, mb) * mb
    est_npairs = est_nab * mean_deg(b_ptr, b_col, kb)
    return est_npairs * BS * BS * _per_elem_s(vdtype, ozaki)


def blockdense_cost(plan: Optional[BlockPlan], vdtype: torch.dtype,
                    ozaki: bool = False) -> float:
    """Estimated seconds of the block-dense engine from its plan (see
    :func:`_per_elem_s`); the extraction, common to both engines, is
    left out."""
    if plan is None:
        return float("inf")
    return plan.npairs * BS * BS * _per_elem_s(vdtype, ozaki)


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

def upload_blockplan(plan: BlockPlan, device) -> None:
    """Copy the plan's index arrays to ``device`` once and keep them on
    the plan."""
    device = torch.device(device)
    if plan.dev is not None and plan.device == device:
        return
    plan.device = device

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    end = [np.where(s.cb_idx >= 0, plan.end_pair[np.maximum(s.cb_idx, 0)],
                    -1).astype(np.int32) for s in plan.strips]
    plan.dev = dict(
        a_blk=up(plan.a_blk_of_ent), a_pos=up(plan.a_pos_of_ent),
        b_blk=up(plan.b_blk_of_ent), b_pos=up(plan.b_pos_of_ent),
        pair_a=up(plan.pair_a), pair_b=up(plan.pair_b),
        pair_new=up(plan.pair_new),
        pair_cb=up((np.cumsum(plan.pair_new) - 1).astype(np.int32)),
        live=up(np.ones(plan.npairs, np.int32)),
        cb_j=up(plan.cb_j),
        # per strip class: C block ids (-1 pad), their segment-end pair
        # positions, and the first global row of each block-row
        strips=[(up(s.cb_idx), up(e), up(s.blk_rows.astype(np.int32) * BS))
                for s, e in zip(plan.strips, end)],
        slab_start=up(plan.slab_row_start),
    )


def densify(blk_of_ent: torch.Tensor, pos_of_ent: torch.Tensor,
            val: torch.Tensor, nblk: int):
    """Scatter CSR entries into dense ``[nblk, BS, BS]`` value and f32
    pattern tensors (once per operand)."""
    flat = blk_of_ent.long() * (BS * BS) + pos_of_ent.long()
    dense = torch.zeros(nblk * BS * BS, dtype=val.dtype, device=val.device)
    dense.index_add_(0, flat, val)
    pat = torch.zeros(nblk * BS * BS, dtype=torch.float32,
                      device=val.device)
    pat.index_fill_(0, flat, 1.0)
    return dense.view(nblk, BS, BS), pat.view(nblk, BS, BS)


def _seg_block_sum(vals: torch.Tensor, new: torch.Tensor,
                   passes: int) -> torch.Tensor:
    """Segmented inclusive sum over the pair axis of ``[npairs, BS, BS]``
    (``new`` marks segment starts): Hillis-Steele, ``passes`` doublings."""
    v, f = vals, new
    dist = 1
    for _ in range(passes):
        sv = torch.cat([torch.zeros_like(v[:dist]), v[:-dist]])
        sf = torch.cat([torch.ones_like(f[:dist]), f[:-dist]])
        v = torch.where(f[:, None, None], v, v + sv)
        f = f | sf
        dist *= 2
    return v


def _bmm_route(dev, a_dense, a_pat, b_dense, b_pat, *, seg_passes: int,
               pair_chunk: int):
    """The gather + batched-matmul route: per chunk of pairs, gather the
    operand blocks and ``torch.bmm`` values and patterns, then take the
    segmented sums over the whole ``[npairs, BS, BS]`` stream.  The
    stream is padded to a chunk multiple with dead pairs, each its own
    segment.  Returns (value sums, pattern sums, padded ``new``)."""
    pair_a, pair_b, new = dev["pair_a"], dev["pair_b"], dev["pair_new"]
    npairs = pair_a.shape[0]
    npad = -(-npairs // pair_chunk) * pair_chunk
    if npad != npairs:
        pz = pair_a.new_zeros(npad - npairs)
        pair_a = torch.cat([pair_a, pz])
        pair_b = torch.cat([pair_b, pz])
        new = torch.cat([new, new.new_ones(npad - npairs)])
    live = torch.arange(npad, device=pair_a.device) < npairs
    prods, pats = [], []
    for lo in range(0, npad, pair_chunk):
        pa = pair_a[lo:lo + pair_chunk]
        pb = pair_b[lo:lo + pair_chunk]
        lv = live[lo:lo + pair_chunk]
        av = a_dense.index_select(0, pa) * lv.to(a_dense.dtype)[:, None,
                                                               None]
        ap = a_pat.index_select(0, pa) * lv.to(torch.float32)[:, None,
                                                              None]
        prods.append(torch.bmm(av, b_dense.index_select(0, pb)))
        pats.append(torch.bmm(ap, b_pat.index_select(0, pb)))
    prod = prods[0] if len(prods) == 1 else torch.cat(prods)
    pat = pats[0] if len(pats) == 1 else torch.cat(pats)
    return (_seg_block_sum(prod, new, seg_passes),
            _seg_block_sum(pat, new, seg_passes))


def blockdense_main(dev, a_dense, a_pat, b_dense, b_pat, *, specs: tuple,
                    seg_passes: int, m: int, pair_chunk: int, route: str):
    """C blocks from the pair stream by ``route`` (module doc), then the
    strips.  Returns (crow, cptr, total, strips)."""
    if route == "kernel":
        ncb = int(dev["cb_j"].shape[0])
        pm = pair_matmul_f64 if a_dense.dtype == torch.float64 \
            else pair_matmul_f32
        stream = (dev["pair_a"], dev["pair_b"], dev["pair_cb"], dev["live"])
        cvals = pm(a_dense, b_dense, *stream, ncb=ncb)
        cpats = pair_matmul_f32(a_pat, b_pat, *stream, ncb=ncb)
        return _blockdense_strips(dev, cvals, cpats, specs, m,
                                  by_end_pair=False)
    if route != "bmm":
        raise ValueError(f"unknown block-dense route {route!r}")
    vsum, psum = _bmm_route(dev, a_dense, a_pat, b_dense, b_pat,
                            seg_passes=seg_passes, pair_chunk=pair_chunk)
    return _blockdense_strips(dev, vsum, psum, specs, m, by_end_pair=True)


def _left_pack(has: torch.Tensor, *planes):
    """Stable left-pack of each row by ``has``: the flagged slots in
    their order, then the others.  A scatter by rank: a flagged slot goes
    to its rank among the flagged, any other to the row's count plus its
    rank among the others.  Returns (per-row counts, packed planes)."""
    cnt = torch.cumsum(has, dim=1, dtype=torch.int32)      # inclusive
    nnz_row = cnt[:, -1]
    j = torch.arange(has.shape[1], dtype=torch.int32, device=has.device)
    dest = torch.where(has, cnt - 1, nnz_row[:, None] + j - cnt).long()
    return nnz_row, [torch.empty_like(p).scatter_(1, dest, p)
                     for p in planes]


def _blockdense_strips(dev, vsum, psum, specs, m: int, by_end_pair: bool):
    """Per strip class, take each block-row's C blocks (at their
    segment-end pair positions, or by C block id when the pair kernels
    produced one block each), lay them side by side, and left-pack each
    row by its structural pattern."""
    device = vsum.device
    crow = torch.zeros(m, dtype=torch.int32, device=device)
    strips = []
    total = torch.zeros((), dtype=torch.int64, device=device)
    cb_j = dev["cb_j"]
    lane = torch.arange(BS, dtype=torch.int32, device=device)
    for (nj, nrows_blk), (cb_idx, endp, rows0) in zip(specs, dev["strips"]):
        keep = (cb_idx >= 0)[:, :, None, None]
        idx = endp if by_end_pair else cb_idx
        safe_e = torch.where(idx >= 0, idx, 0).reshape(-1)
        shape = (nrows_blk, nj, BS, BS)
        vb = vsum.index_select(0, safe_e).view(shape) * keep.to(vsum.dtype)
        pb = psum.index_select(0, safe_e).view(shape) * keep.to(psum.dtype)
        safe_c = torch.where(cb_idx >= 0, cb_idx, 0)
        colb = cb_j[safe_c][:, :, None] * BS + lane           # [R, nj, BS]
        W = nj * BS
        # [R*BS rows, nj*BS columns]
        v2 = vb.permute(0, 2, 1, 3).reshape(-1, W)
        p2 = pb.permute(0, 2, 1, 3).reshape(-1, W)
        c2 = colb[:, None].expand(nrows_blk, BS, nj, BS).reshape(-1, W)
        nnz_row, (oC, oV) = _left_pack(p2 > 0, c2, v2)
        strips.append((oC, oV))
        total = total + nnz_row.sum(dtype=torch.int64)
        gr = (rows0[:, None] + lane[None, :]).reshape(-1)
        gr = torch.where(gr < m, gr, m).long()
        full = torch.zeros(m + 1, dtype=torch.int32, device=device)
        full.index_copy_(0, gr, nnz_row)
        crow = crow + full[:m]
    cptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                      torch.cumsum(crow, 0, dtype=torch.int32)])
    return crow, cptr, total, strips


def run_blockdense(plan: BlockPlan, a_val: Optional[torch.Tensor],
                   b_val: Optional[torch.Tensor], pair_chunk: int = 512):
    """Densify (once: the dense operands are cached on the plan, so a
    warm call passes no values) and run the main stage on the device the
    plan was uploaded to.  Returns (crow, cptr, total, strips)."""
    d = plan.dev
    if "a_dense" not in d:
        d["a_dense"], d["a_pat"] = densify(d["a_blk"], d["a_pos"], a_val,
                                           nblk=plan.nab)
        d["b_dense"], d["b_pat"] = densify(d["b_blk"], d["b_pos"], b_val,
                                           nblk=plan.nbb)
    specs = tuple((s.nj, s.nrows_blk) for s in plan.strips)
    return blockdense_main(
        d, d["a_dense"], d["a_pat"], d["b_dense"], d["b_pat"],
        specs=specs, seg_passes=plan.seg_passes, m=plan.m,
        pair_chunk=min(quantize(plan.npairs), pair_chunk), route=plan.route)


def warm_blockplan_from_crow(plan: BlockPlan, crow: np.ndarray,
                             ext_area: int, ext_nplanes: int) -> None:
    """Fix what the first run's readback fixes, from per-row nnz(C)
    counts and the strip geometry (``ext_area`` strip slots,
    ``ext_nplanes`` = 3 for f64, 2 for f32): nnz(C), its capacity and,
    where the plan's fill mode allows it and the cost model agrees, the
    windowed extraction plan — the block-dense twin of
    ``bucketed.warm_plan_from_crow``."""
    crow = np.asarray(crow).astype(np.int32)[: plan.m]
    plan.nnz_c = int(crow.sum())
    plan.nnz_cap = quantize(max(1, plan.nnz_c))
    plan.crow_h = crow
    plan.ext_area = int(ext_area)
    plan.ext_nplanes = int(ext_nplanes)
    plan.ext = None
    if plan.dma_fill != "off" and plan.nnz_c:
        plan.ext = bucketed_ops.build_extract_plan(
            plan.crow_h, plan.slab_row_start, area=plan.ext_area,
            nplanes=plan.ext_nplanes, force=plan.dma_fill == "on")


def finish_blockdense(plan: BlockPlan, main_out):
    """Extraction of the strips into CSR: the windowed copy when the plan
    has one, else the bucketed engine's gather (``bucketed_extract``).
    The first run fetches the per-row counts (the one host sync), fixes
    the output capacity and plans the windowed copy.  Returns (cptr,
    ccol, cval)."""
    crow, cptr, _, strips = main_out
    if plan.nnz_cap is None:
        vdt = strips[0][1].dtype if strips else torch.float32
        warm_blockplan_from_crow(
            plan, crow.cpu().numpy(),
            ext_area=sum(oC.numel() for oC, _ in strips),
            ext_nplanes=3 if vdt == torch.float64 else 2)
    slabs = [(oC.reshape(-1), oV.reshape(-1), None) for oC, oV in strips]
    if plan.ext is not None:
        ccol, cval = bucketed_ops.bucketed_extract_windowed(
            slabs, plan.ext, nnz_cap=plan.nnz_cap, nnz_c=plan.nnz_c)
    else:
        ccol, cval = bucketed_ops.bucketed_extract(
            slabs, plan.dev["slab_start"], cptr, m=plan.m,
            nnz_cap=plan.nnz_cap)
    return cptr, ccol, cval
