"""Bucketed expand-sort-compress SpGEMM — the port of
``mh_spgemm_tpu/ops/bucketed.py`` on its precomputed-slot path.

Host half (numpy): rows are binned by their intermediate-product count
into power-of-two width classes W (W = 1 for single-product rows); each
class is cut into chunks of ``rb`` rows, and every slot of a chunk's
``rb * W`` slab gets, at plan time, the index of the B nonzero and of the
A nonzero whose product lands there (``slot_src`` / ``slot_aidx``, -1 for
an empty slot).  The plans are array-for-array those of the JAX planner
with ``precompute=True`` and the fill, planned and grouped frontends off.

Device half (torch): per class, one gather of B columns, one of A and B
values, one product, and one tail over all chunks at once (the slot
arrays are flat ``[nchunks, rb * W]``, so there is no loop over chunks):

* W = 1: no duplicates are possible, the product is the output;
* W a power of two up to 65536: the flat ESC tail kernel
  (ops/esc_tail.py, ``esc_tail_flat``) sorts each row's W slots by
  column, sums equal columns and left-packs the survivors;
* wider W (or ``esc_tail="off"``): the sort tail in torch ops, the port
  of the JAX package's XLA tail (``_chunk_tail``).

Extraction gathers the left-packed row slabs into one CSR.  The first
call learns nnz(C) per row with one small device-to-host copy; later
calls use host-evaluated extraction indices and run without a sync
between the main stage and the extraction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import esc_tail as esc_tail_mod
from .shapes import quantize

I32_MAX = 2**31 - 1

# Class consolidation cost constants, copied from the JAX planner so the
# plans match.  Both are TPU v5e measurements (ns per padded slot, and the
# fixed cost per extra class); they have not been measured on the H100.
_MERGE_SLOT_NS = 30.0
_CLASS_MERGE_NS = 1e6
# The fill frontend's per-chunk slab budget in i32 words; the JAX
# planner's consolidation never pushes a class across it even with the
# fill off, so it shapes the plans (TPU VMEM budget, not an H100 limit).
_FILL_WORDS_CAP = 3 << 18


class SlabOverflowError(ValueError):
    """The padded slab area or the product count exceeds int32 indexing;
    callers split the rows (``pipeline.spgemm_chunked``)."""


@dataclasses.dataclass
class ClassPlan:
    """One row class: all rows whose product count fits in width W."""

    W: int                 # row capacity (slots per row)
    rb: int                # rows per chunk
    nchunks: int
    eb: int                # A-entry capacity per chunk (quantized)
    rows_g: np.ndarray     # int32[nchunks, rb]   global row ids, -1 pad
    ent_dst: np.ndarray    # int32[nchunks, eb]   slot*W + in-row offset
    ent_src: np.ndarray    # int32[nchunks, eb]   b_ptr[a_col[e]]
    ent_len: np.ndarray    # int32[nchunks, eb]   nnz of referenced B row
    ent_aidx: np.ndarray   # int32[nchunks, eb]   index into a_val
    hold_passes: int       # log2 bound on B-segment length within a row
    seg_passes: int        # log2 bound on same-column run length
    pre: bool = False
    slot_src: Optional[np.ndarray] = None   # int32[nchunks, rb*W], -1 pad
    slot_aidx: Optional[np.ndarray] = None  # int32[nchunks, rb*W]


@dataclasses.dataclass
class BucketPlan:
    """Host plan: row classes, their device tensors, and the sizes the
    first run learns."""

    m: int                              # true row count
    m_cap: int                          # quantized row count
    classes: List[ClassPlan]
    intprod: int
    slab_row_start: Optional[np.ndarray] = None  # int32[m_cap] slab offset
    device: Optional[torch.device] = None        # where ``dev`` lives
    dev: Optional[list] = None          # per class (rows_g, src, aidx)
    dev_slab_start: Optional[torch.Tensor] = None
    class_caps: Optional[Tuple[int, ...]] = None  # quantized nnz per class
    nnz_c: Optional[int] = None
    nnz_cap: Optional[int] = None
    crow_h: Optional[np.ndarray] = None  # learned per-row nnz(C) (host)
    ext_src_h: Optional[np.ndarray] = None   # int32[nnz_cap]
    cptr_h: Optional[np.ndarray] = None      # int32[m_cap + 1]
    ext_static_dev: Optional[tuple] = None   # (src, cptr) on ``device``
    # slots that went through each tail, summed over this plan's runs
    tail_slots: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"direct": 0, "kernel": 0, "sort": 0})


def _log2_bound(x: int) -> int:
    return max(1, int(x - 1).bit_length()) if x > 1 else 0


def _attach_slot_arrays(c: ClassPlan) -> None:
    """Evaluate the per-slot B source index and A value index from the
    entry descriptors; slots outside every entry's span keep -1."""
    RW = c.rb * c.W
    ss = np.full((c.nchunks, RW), -1, np.int32)
    sa = np.zeros((c.nchunks, RW), np.int32)
    live = c.ent_len > 0
    ch, ei = np.nonzero(live)
    if ch.size:
        dst = c.ent_dst[ch, ei].astype(np.int64)
        src = c.ent_src[ch, ei].astype(np.int64)
        ln = c.ent_len[ch, ei].astype(np.int64)
        ai = c.ent_aidx[ch, ei]
        tot = int(ln.sum())
        rep = np.repeat(np.arange(dst.size), ln)
        within = (np.arange(tot, dtype=np.int64)
                  - np.repeat(np.cumsum(ln) - ln, ln))
        pos = ch[rep] * RW + dst[rep] + within
        ss.reshape(-1)[pos] = (src[rep] + within).astype(np.int32)
        sa.reshape(-1)[pos] = ai[rep]
    c.pre = True
    c.slot_src = ss
    c.slot_aidx = sa


def _entries_numpy(a_ptr, a_col, b_ptr, p_ent, rows_c, rb, W, nchunks):
    """Per-entry descriptors of one class (the numpy twin of the native
    builder): entries that reference an empty B row are dropped."""
    a_row_nnz = np.diff(a_ptr)
    cnt = a_row_nnz[rows_c].astype(np.int64)
    local_row = np.repeat(np.arange(rows_c.size, dtype=np.int64), cnt)
    starts = a_ptr[rows_c].astype(np.int64)
    bases = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    ent_e = (np.repeat(starts - bases, cnt)
             + np.arange(int(cnt.sum()), dtype=np.int64))
    pe = p_ent[ent_e]
    keep = pe > 0
    ent_e, local_row, pe = ent_e[keep], local_row[keep], pe[keep]
    pc = np.cumsum(pe)
    row_first = np.concatenate([[True], local_row[1:] != local_row[:-1]])
    row_base = np.maximum.accumulate(np.where(row_first, pc - pe, 0))
    off = pc - pe - row_base
    chunk = local_row // rb
    slot = local_row - chunk * rb
    dst = (slot * W + off).astype(np.int64)
    ecnt = (np.bincount(chunk, minlength=nchunks).astype(np.int64)
            if chunk.size else np.zeros(nchunks, np.int64))
    eb = quantize(int(ecnt.max())) if ecnt.size and ecnt.max() else 1
    shape = (nchunks, eb)
    ent_dst = np.full(shape, rb * W, dtype=np.int32)    # pad -> dropped
    ent_src = np.zeros(shape, dtype=np.int32)
    ent_len = np.zeros(shape, dtype=np.int32)
    ent_aidx = np.zeros(shape, dtype=np.int32)
    within = np.arange(ent_e.size, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(ecnt)[:-1]]), ecnt)
    flat = chunk * eb + within
    ent_dst.ravel()[flat] = dst.astype(np.int32)
    ent_src.ravel()[flat] = b_ptr[:-1][a_col[ent_e]].astype(np.int32)
    ent_len.ravel()[flat] = pe.astype(np.int32)
    ent_aidx.ravel()[flat] = ent_e.astype(np.int32)
    return eb, (ent_dst, ent_src, ent_len, ent_aidx)


def plan_buckets(a_ptr: np.ndarray, a_col: np.ndarray, b_ptr: np.ndarray,
                 area_cap: int = 1 << 23, vwords: int = 2) -> BucketPlan:
    """Bin rows into power-of-two width classes, consolidate small
    classes, build per-chunk entry descriptors (native builder when the
    host library is present, numpy otherwise) and the per-slot arrays.

    ``vwords`` is the value width in i32 words (2 = f64, 1 = f32); it
    only enters through the consolidation cap.  Raises
    :class:`SlabOverflowError` when the slab needs more than int32
    indexing."""
    from ..utils import native as native_lib

    m = a_ptr.shape[0] - 1
    b_lens = np.diff(b_ptr).astype(np.int64)
    p_ent = b_lens[a_col]                                   # per A-entry
    cs = np.concatenate([[0], np.cumsum(p_ent)])
    p_row = cs[a_ptr[1:]] - cs[a_ptr[:-1]]                  # per C row
    intprod = int(cs[-1])

    active = np.flatnonzero(p_row > 0).astype(np.int32)
    classes: List[ClassPlan] = []
    if active.size == 0:
        m_cap = quantize(max(1, m))
        return BucketPlan(m=m, m_cap=m_cap, classes=classes,
                          intprod=intprod,
                          slab_row_start=np.zeros(m_cap, np.int32))

    p = p_row[active]
    vcs = np.concatenate([[0], np.cumsum(p_ent > 0)])
    row_vcnt = (vcs[a_ptr[1:]] - vcs[a_ptr[:-1]]).astype(np.int64)
    fill_slot_cap = _FILL_WORDS_CAP // (1 + vwords)

    # pow2 widths (the flat tail needs aligned pow2 segments); rows with
    # one product take the W = 1 direct path
    pw = 2 ** np.ceil(np.log2(np.maximum(1, p))).astype(np.int64)
    wclass = np.where(p == 1, 1, np.maximum(2, pw))

    # class consolidation: merge a class into the next wider one while
    # the padding cost stays under the fixed per-class cost
    widths_u = sorted(int(w) for w in np.unique(wclass))
    for i, w in enumerate(widths_u[:-1]):
        if w == 1:
            continue                    # keep the W = 1 direct class
        sel = wclass == w
        nxt = widths_u[i + 1]
        if nxt > fill_slot_cap >= w:
            continue
        if int(sel.sum()) * (nxt - w) * _MERGE_SLOT_NS < _CLASS_MERGE_NS:
            wclass[sel] = nxt

    groups = []
    for W in sorted(set(wclass.tolist())):
        rows_c = active[wclass == W]                    # original order
        rb = max(1, min(area_cap // W, quantize(max(1, rows_c.size))))
        groups.append((W, rows_c, rb, max(1, -(-rows_c.size // rb))))
    area = sum(W * rb * nchunks for W, _, rb, nchunks in groups)
    if area >= 2**31 or intprod >= 2**31:       # before any slot array
        raise SlabOverflowError(
            f"bucketed slab area {area} / intprod {intprod} exceeds int32 "
            "indexing; split the matrix (spgemm_chunked)")

    for W, rows_c, rb, nchunks in groups:
        vc = row_vcnt[rows_c]
        ecnt_max = int(np.max(np.add.reduceat(
            np.concatenate([vc, np.zeros(nchunks * rb - vc.size,
                                         np.int64)]),
            np.arange(0, nchunks * rb, rb))))
        eb = quantize(max(1, ecnt_max))
        rows_pad = np.full(nchunks * rb, -1, dtype=np.int32)
        rows_pad[: rows_c.size] = rows_c
        ent = native_lib.bucket_entries(a_ptr, a_col, b_ptr, rows_c, rb,
                                        int(W), eb, nchunks)
        if ent is None:
            eb, ent = _entries_numpy(a_ptr, a_col, b_ptr, p_ent, rows_c,
                                     rb, int(W), nchunks)
        c = ClassPlan(W=int(W), rb=rb, nchunks=nchunks, eb=eb,
                      rows_g=rows_pad.reshape(nchunks, rb),
                      ent_dst=ent[0], ent_src=ent[1], ent_len=ent[2],
                      ent_aidx=ent[3], hold_passes=_log2_bound(W),
                      seg_passes=_log2_bound(W))
        _attach_slot_arrays(c)
        classes.append(c)

    # flat offset of each row's slab in the concatenated class slabs
    slab_row_start = np.zeros(m, dtype=np.int32)
    base = 0
    for c in classes:
        rows = c.rows_g.reshape(-1)
        local = np.arange(rows.size, dtype=np.int64)
        live = rows >= 0
        slab_row_start[rows[live]] = (base + local[live] * c.W).astype(
            np.int32)
        base += rows.size * c.W
    m_cap = quantize(max(1, m))
    slab_row_start = np.concatenate(
        [slab_row_start, np.zeros(m_cap - m, np.int32)])
    return BucketPlan(m=m, m_cap=m_cap, classes=classes, intprod=intprod,
                      slab_row_start=slab_row_start)


_CLASS_FIELDS = ("W", "rb", "nchunks", "eb", "rows_g", "ent_dst",
                 "ent_src", "ent_len", "ent_aidx", "hold_passes",
                 "seg_passes", "slot_src", "slot_aidx")


def plan_from_arrays(fields: dict) -> BucketPlan:
    """Rebuild a plan from plain fields: ``m``, ``m_cap``, ``intprod``,
    ``slab_row_start`` and ``classes``, a list of dicts holding every
    name in ``_CLASS_FIELDS`` (for example the numpy fields of a JAX
    package ``BucketPlan`` planned with precomputed slot arrays).  A class
    that says it runs another frontend (``fill``, ``pf``, ``G > 1`` or
    ``pre`` false) raises: the port runs only precomputed classes."""
    classes = []
    for cf in fields["classes"]:
        if (cf.get("fill") or cf.get("pf") or cf.get("G", 1) != 1
                or not cf.get("pre", True) or cf.get("slot_src") is None):
            raise NotImplementedError(
                "only precomputed-slot classes are ported (ROADMAP "
                "Queue 1: the ESC-gather and fill frontends come later)")
        kw = {k: cf[k] for k in _CLASS_FIELDS}
        for k in ("W", "rb", "nchunks", "eb", "hold_passes", "seg_passes"):
            kw[k] = int(kw[k])
        for k in _CLASS_FIELDS[4:9] + _CLASS_FIELDS[11:]:
            kw[k] = np.ascontiguousarray(kw[k], dtype=np.int32)
        classes.append(ClassPlan(pre=True, **kw))
    return BucketPlan(
        m=int(fields["m"]), m_cap=int(fields["m_cap"]), classes=classes,
        intprod=int(fields["intprod"]),
        slab_row_start=np.ascontiguousarray(fields["slab_row_start"],
                                            dtype=np.int32))


def attach_static_extract(plan: BucketPlan) -> None:
    """Host-evaluate the extraction operands from the learned per-row
    counts: ``src[j]``, the flat slab index of output j, and the full
    ``cptr``.  nnz(C) is structural, so once learned these are plan
    constants and warm calls skip the device-side row counts."""
    crow = plan.crow_h.astype(np.int64)
    cptr = np.concatenate([[0], np.cumsum(crow)])
    area = sum(c.W * c.rb * c.nchunks for c in plan.classes)
    src = np.arange(plan.nnz_cap, dtype=np.int64)
    row_of = np.repeat(np.arange(plan.m), crow)
    base = (plan.slab_row_start[: plan.m].astype(np.int64)
            - cptr[: plan.m])
    add = np.zeros(plan.nnz_cap, np.int64)
    add[: row_of.size] = base[row_of]
    plan.ext_src_h = np.clip(src + add, 0, max(0, area - 1)) \
        .astype(np.int32)
    full = np.full((plan.m_cap + 1,), cptr[-1], np.int64)
    full[: plan.m + 1] = cptr
    plan.cptr_h = full.astype(np.int32)
    plan.ext_static_dev = None


def warm_plan_from_crow(plan: BucketPlan, crow: np.ndarray) -> None:
    """Warm a fresh plan from previously learned per-row nnz(C) counts
    (from the same matrices and config), so its first call takes the
    warm path: per-class capacities and the extraction operands are
    derived exactly as the first run's readback would."""
    crow = np.asarray(crow).astype(np.int64)[: plan.m]
    caps = []
    for c in plan.classes:
        rows = c.rows_g[c.rows_g >= 0]
        total = int(crow[rows].sum()) if rows.size else 0
        caps.append(quantize(total) if total else 1)
    plan.class_caps = tuple(caps)
    plan.nnz_c = int(crow.sum())
    plan.nnz_cap = quantize(max(1, plan.nnz_c))
    plan.crow_h = crow.astype(np.int32)
    attach_static_extract(plan)


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

def upload_plan(plan: BucketPlan, device) -> None:
    """Copy the plan's per-class tensors to ``device`` once and keep them
    on the plan."""
    device = torch.device(device)
    if plan.dev is not None and plan.device == device:
        return
    plan.device = device
    plan.dev = [tuple(torch.as_tensor(x).to(device)
                      for x in (c.rows_g, c.slot_src, c.slot_aidx))
                for c in plan.classes]
    plan.dev_slab_start = torch.as_tensor(plan.slab_row_start).to(device)
    plan.ext_static_dev = None


def _product(AV, bv, valid):
    """Masked product in the value type (native f64 on the card)."""
    return torch.where(valid, AV * bv, torch.zeros((), dtype=bv.dtype,
                                                   device=bv.device))


def _seg_sum_rows(values, new, passes: int):
    """Segmented inclusive sum along rows (``new`` marks run starts):
    Hillis-Steele, ``passes`` doublings."""
    v, f = values, new
    dist = 1
    for _ in range(passes):
        sv = torch.zeros_like(v)
        sv[:, dist:] = v[:, :-dist]
        sf = torch.ones_like(f)
        sf[:, dist:] = f[:, :-dist]
        v = torch.where(f, v, v + sv)
        f = f | sf
        dist *= 2
    return v


def _chunk_tail(K, prod, *, seg_passes: int):
    """Sort tail over ``[rows, W]``: sort by column, segment-sum equal
    columns, left-pack the survivors (the port of the JAX package's XLA
    tail, ``bucketed.py:1289-1299``).  Slots past a row's count hold
    2^31-1 and 0, as the kernel writes them.  Returns (oC, oV, nnz_row)."""
    rows = K.shape[0]
    sK, order = torch.sort(K, dim=1, stable=True)
    sV = torch.gather(prod, 1, order)
    new = torch.ones_like(sK, dtype=torch.bool)
    new[:, 1:] = sK[:, 1:] != sK[:, :-1]
    run = _seg_sum_rows(sV, new, seg_passes)
    ends = torch.cat([new[:, 1:], torch.ones((rows, 1), dtype=torch.bool,
                                             device=K.device)], dim=1)
    ends &= sK < I32_MAX
    nnz_row = ends.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(ends, dim=1, dtype=torch.int32) - 1
    key2 = torch.where(ends, rank, I32_MAX)
    k2, order2 = torch.sort(key2, dim=1, stable=True)
    live = k2 < I32_MAX
    oC = torch.where(live, torch.gather(sK, 1, order2), I32_MAX)
    oV = torch.where(live, torch.gather(run, 1, order2),
                     torch.zeros((), dtype=run.dtype, device=run.device))
    return oC, oV, nnz_row


def _flat_tail(K, prod, valid, *, W: int, rows: int, seg_passes: int,
               route: str, counts: Dict[str, int]):
    """Tail of one class over flat ``[rows * W]`` planes, routed by
    width: W = 1 is the direct path; ``route == "kernel"`` sends pow2
    widths up to 65536 through ``esc_tail_flat``; every other width (and
    ``route == "sort"``) takes the sort tail.  Adds the class's slots to
    ``counts`` under the route taken.  Returns (oC [L], oV [L],
    nnz_row [rows])."""
    L = rows * W
    if W == 1:
        counts["direct"] += L
        return K, prod, valid.to(torch.int32)
    if route == "kernel" and esc_tail_mod.supported_w2(W):
        counts["kernel"] += L
        return esc_tail_mod.esc_tail_flat(K, prod, w2=W)
    counts["sort"] += L
    oC, oV, nnz_row = _chunk_tail(K.view(rows, W), prod.view(rows, W),
                                  seg_passes=seg_passes)
    return oC.reshape(L), oV.reshape(L), nnz_row


def expand_pre(slot_src, slot_aidx, a_val, b_col, b_val):
    """Frontend of a precomputed class over all its chunks: gather B
    columns and A/B values by the plan's slot arrays and multiply.
    Returns flat (keys, products, valid); empty slots carry key 2^31-1
    and product 0, as the tail expects."""
    src = slot_src.reshape(-1)
    valid = src >= 0
    srcc = torch.where(valid, src, 0)
    ai = torch.where(valid, slot_aidx.reshape(-1), 0)
    K = torch.where(valid, b_col.index_select(0, srcc), I32_MAX)
    prod = _product(a_val.index_select(0, ai), b_val.index_select(0, srcc),
                    valid)
    return K, prod, valid


def _chunk_pre(slot_src, slot_aidx, a_val, b_col, b_val, *, W: int,
               rows: int, seg_passes: int, route: str,
               counts: Dict[str, int]):
    """All chunks of one precomputed class at once: frontend, then the
    tail routed by width."""
    K, prod, valid = expand_pre(slot_src, slot_aidx, a_val, b_col, b_val)
    return _flat_tail(K, prod, valid, W=W, rows=rows,
                      seg_passes=seg_passes, route=route, counts=counts)


def bucketed_main(plan: BucketPlan, a_val, b_col, b_val, *, route: str):
    """Main stage over every class; returns the per-class slabs
    ``[(cols [L], vals [L], nnz_row [rows])]``, left-packed per row."""
    slabs = []
    for c, (rows_g, ss, sa) in zip(plan.classes, plan.dev):
        slabs.append(_chunk_pre(ss, sa, a_val, b_col, b_val, W=c.W,
                                rows=c.nchunks * c.rb,
                                seg_passes=c.seg_passes, route=route,
                                counts=plan.tail_slots))
    return slabs


def bucketed_counts(plan: BucketPlan, slabs):
    """Per-row nnz(C) scattered from the class slabs, its prefix sum, and
    per-class totals.  Returns (crow int32[m_cap], cptr int32[m_cap+1],
    totals int64[classes])."""
    dev = plan.device
    m = plan.m_cap
    crow = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    totals = []
    for (rows_g, _, _), (_, _, nnz_row) in zip(plan.dev, slabs):
        idx = torch.where(rows_g >= 0, rows_g, m).reshape(-1)
        crow.index_copy_(0, idx.to(torch.int64), nnz_row)
        totals.append(nnz_row.sum(dtype=torch.int64))
    crow = crow[:m]
    cptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(crow, 0, dtype=torch.int32)])
    tot = (torch.stack(totals) if totals
           else torch.zeros(0, dtype=torch.int64, device=dev))
    return crow, cptr, tot


def _slab_src(slab_row_start, cptr, m: int, nnz_cap: int):
    """Slab source index of every output position: within a row the
    source advances by one, and at each row start it jumps by a known
    delta, so ``src = j + cumsum(deltas scattered at row starts)``."""
    base = slab_row_start.to(torch.int64) - cptr[:m].to(torch.int64)
    prev = torch.cat([base.new_zeros(1), base[:-1]])
    at = cptr[:m].to(torch.int64)
    keep = at < nnz_cap
    hold = torch.zeros(nnz_cap, dtype=torch.int64, device=base.device)
    hold.index_add_(0, at[keep], (base - prev)[keep])
    return (torch.arange(nnz_cap, dtype=torch.int64, device=base.device)
            + torch.cumsum(hold, 0))


def _flat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def bucketed_extract(slabs, slab_row_start, cptr, *, m: int, nnz_cap: int):
    """Gather the left-packed class slabs into one CSR (col, val) pair,
    ``nnz_cap`` long, zero past nnz(C) = ``cptr[m]``."""
    src = _slab_src(slab_row_start, cptr, m, nnz_cap)
    j = torch.arange(nnz_cap, dtype=torch.int64, device=src.device)
    ok = j < cptr[m]
    area = sum(oC.numel() for oC, _, _ in slabs)
    src = torch.clamp(torch.where(ok, src, 0), 0, area - 1)
    ccol = torch.where(ok, _flat([s[0] for s in slabs]).index_select(0, src),
                       0)
    flat_v = _flat([s[1] for s in slabs])
    cval = torch.where(ok, flat_v.index_select(0, src),
                       torch.zeros((), dtype=flat_v.dtype,
                                   device=flat_v.device))
    return ccol, cval


def bucketed_extract_static(slabs, ext_src, *, nnz_c: int):
    """Warm extraction with host-evaluated slab sources (already clipped
    into the slab): two gathers and a static validity bound."""
    ok = torch.arange(ext_src.shape[0], device=ext_src.device) < nnz_c
    ccol = torch.where(
        ok, _flat([s[0] for s in slabs]).index_select(0, ext_src), 0)
    flat_v = _flat([s[1] for s in slabs])
    cval = torch.where(ok, flat_v.index_select(0, ext_src),
                       torch.zeros((), dtype=flat_v.dtype,
                                   device=flat_v.device))
    return ccol, cval


def run_bucketed(plan: BucketPlan, a_val, b_col, b_val, *, route: str):
    """Cold main stage: slabs plus their row counts.  Returns (crow,
    cptr, totals, slabs)."""
    upload_plan(plan, a_val.device)
    slabs = bucketed_main(plan, a_val, b_col, b_val, route=route)
    crow, cptr, totals = bucketed_counts(plan, slabs)
    return crow, cptr, totals, slabs


def run_bucketed_fused(plan: BucketPlan, a_val, b_col, b_val, *,
                       route: str):
    """Warm path (the plan knows nnz(C)): main stage then static
    extraction, queued back to back with no host sync between them.
    Returns (cptr, ccol, cval)."""
    assert plan.nnz_cap is not None, "fused path needs a warm plan"
    upload_plan(plan, a_val.device)
    if plan.ext_static_dev is None:
        plan.ext_static_dev = (
            torch.as_tensor(plan.ext_src_h).to(plan.device),
            torch.as_tensor(plan.cptr_h).to(plan.device))
    ext_src, cptr = plan.ext_static_dev
    slabs = bucketed_main(plan, a_val, b_col, b_val, route=route)
    ccol, cval = bucketed_extract_static(slabs, ext_src, nnz_c=plan.nnz_c)
    return cptr, ccol, cval


def finish_bucketed(plan: BucketPlan, main_out):
    """Extraction after a cold main stage.  The first run fetches the
    per-class totals and per-row counts (the one host sync), fixes the
    output capacity and evaluates the warm extraction operands."""
    crow, cptr, totals, slabs = main_out
    if plan.class_caps is None:
        t = totals.cpu().numpy()
        plan.class_caps = tuple(quantize(int(x)) if x else 1 for x in t)
        plan.nnz_c = int(t.sum())
        plan.nnz_cap = quantize(max(1, plan.nnz_c))
        plan.crow_h = crow[: plan.m].cpu().numpy().astype(np.int32)
        attach_static_extract(plan)
    ccol, cval = bucketed_extract(slabs, plan.dev_slab_start, cptr,
                                  m=plan.m_cap, nnz_cap=plan.nnz_cap)
    return cptr, ccol, cval
