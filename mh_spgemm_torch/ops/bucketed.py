"""Bucketed expand-sort-compress SpGEMM — the port of
``mh_spgemm_tpu/ops/bucketed.py``.

Host half (numpy): rows are binned by their intermediate-product count
into width classes W (powers of two on the precomputed-slot path, the
1.5x grid 2, 3, 4, 6, 8, 12, ... with ``precompute=False``); each class
is cut into chunks of ``rb`` rows with per-entry descriptors.  A class
then runs one of three frontends, as the JAX planner decides:

* ``"pre"``: every slot of a chunk's ``rb * W`` slab gets, at plan time,
  the index of the B nonzero and of the A nonzero whose product lands
  there (``slot_src`` / ``slot_aidx``);
* ``"fill"`` (``dma_fill`` not "off", rows whose B spans average at least
  16 words): host-planned (src, dst, len) runs that the ``ragged_fill``
  kernel (ops/ragged_fill.py) copies out of a planar stream of B's column
  and value words (:func:`build_pairs_planar`), plus each row's product
  count ``row_len``;
* ``"planned"`` (``planned="on"``, a ``pre`` class whose chunks the
  host can schedule): the ``pre`` slot arrays turned into host schedules
  (:func:`attach_planned`): a windowed gather of B's words and a routing
  network back to slot order (``pgather`` and ``proute``,
  ops/planned.py), and the same for the A values of each run head, held
  down their runs;
* ``"gather"`` (``precompute=False``, the masked engine's plans and the
  legacy replan; or a long-span ``pre`` class the planned frontend could
  not schedule, demoted): the entry descriptors alone; the device
  broadcasts each entry down its slots (the JAX package's hold-scan) and
  gathers B per slot.

The plans are array-for-array those of the JAX planner with ``planar=True``
and the grouped frontend off.  The distributed engines
(``parallel/spgemm_dist.py``) plan each shard against another B layout
(``b_starts`` / ``b_lens``) and force one class layout over the mesh
(``forced``, :func:`plan_buckets_sharded`); their fill streams are built
on the device after the collective (:func:`pairs_planar_device`).
``dma_fill`` arrives resolved by the pipeline: "auto" (the cost model;
the pipeline passes it only for a state prepared for a CUDA device),
"on" (forced on any device) or "off"; so does ``planned``: "on" or
"off".

Device half (torch): per class, one frontend call and one tail call over
all chunks at once (every step is row-local, so the chunks of a class
batch as one ``[nchunks * rb, W]`` slab):

* W = 1: no duplicates are possible, the product is the output;
* W a power of two up to 65536: the ESC tail kernel (ops/esc_tail.py;
  ``esc_tail_flat`` on the flat pre slabs, the slab form ``esc_tail``
  with the plan's ``row_len`` on fill and gather slabs) sorts each row's
  W slots by column, sums equal columns and left-packs the survivors;
* on CUDA, every other W too: up to 8192 (the 1.5x grid's classes,
  never a pre class) each row padded in registers to the next power of
  two, wider on the kernel's wide path (pieces of 8192 slots, then merge
  rounds); their sums are added in the kernel's order, which is within
  rounding of the JAX package's, not bit for bit;
* the rest (``esc_tail="off"``, and on CPU tensors the widths off the
  powers of two and past 65536, which so keep the JAX package's bits):
  the sort tail in torch ops, the port of the JAX package's XLA tail
  (``_chunk_tail``).

:func:`tail_route` decides among them.

Extraction copies the left-packed row slabs into one CSR.  The first call
learns nnz(C) per row with one small device-to-host copy; later calls use
host-evaluated extraction indices and run without a sync between the main
stage and the extraction.  Where ``dma_fill`` allows and the cost model
agrees (:func:`build_extract_plan`), the extraction is the windowed copy
instead: one ``ragged_fill`` run per C row and plane; otherwise, where a
class is planned, the planned extraction (the slab-to-CSR gather as
``pgather`` and ``proute`` schedules over output chunks).

Every cost constant here is the JAX package's TPU v5e figure, kept so the
plans and the routing match; none is measured on the H100.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..timing import span
from . import esc_tail as esc_tail_mod
from . import gather_front as gf
from . import planned as pn
from . import ragged_fill as rf
from .shapes import quantize

I32_MAX = 2**31 - 1

# Class consolidation cost constants, copied from the JAX planner so the
# plans match.  Both are TPU v5e measurements (ns per padded slot, and the
# fixed cost per extra class); they have not been measured on the H100.
_MERGE_SLOT_NS = 30.0
_CLASS_MERGE_NS = 1e6
# The fill frontend's per-chunk slab budget in i32 words (the TPU's VMEM
# budget, not an H100 limit); it caps fill chunks and shapes the class
# consolidation, so the plans match.
_FILL_WORDS_CAP = 3 << 18
# Frontend and engine-routing constants of the JAX planner, TPU v5e
# measurements, not measured on the H100: ns per slot of a gather-frontend
# class (the JAX default of MHSPGEMM_GATHER_NS, which the port does not
# read); the fill's cost per grid step (us), per run (us) and per slot
# (ns); and its shortest worthwhile span in i32 words.
_GATHER_NS_PER_SLOT = 30.0
_FILL_STEP_US = 1.7
_FILL_RUN_US = 0.4
_FILL_NS_PER_SLOT = 2.0
_FILL_MIN_SPAN_WORDS = 16
_FILL_EPG = 256                # runs per grid step (descriptor block)
# The fill streams start with this many zero words and every window one
# row early with src biased by +128: the JAX encoding, kept so the run
# descriptors compare array for array.
_FILL_BIAS_WORDS = 8192
# The windowed extraction's peak-memory guard of the JAX planner (the TPU
# v5e's HBM budget, not an H100 limit), kept so the plans match.
_EXTRACT_PEAK_BYTES = 11 * (1 << 30)
# Planned-frontend limits of the JAX planner (the JAX defaults of
# MHSPGEMM_PF_CHUNK_CAP and MHSPGEMM_PF_TABLE_CAP, which the port does not
# read): the chunk slot count that bounds a routing network's width, and
# the B table size in words.  Both are TPU VMEM budgets, not H100 limits,
# kept so the plans match.
_PF_CHUNK_CAP = 32768
_PF_TABLE_CAP_WORDS = 6_500_000
_PN_NSTAGES_1024 = 55          # len(_stage_list(1024)): the dummy A route
# The long-span demotion's mean entry span and the legacy replan's share
# of demoted slots (the JAX planner's and pipeline's rules).
_DEMOTE_SPAN = 5.0
_REPLAN_SHARE = 0.6


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
    # fill frontend (planar stream, run geometry in elements)
    fill: bool = False
    stride: int = 0                       # word planes: column + value words
    wrows: int = 0                        # source window rows per step
    out_rows: int = 0                     # slab rows per plane
    win_row: Optional[np.ndarray] = None  # int32[nchunks, S, 2]
    runs: Optional[np.ndarray] = None     # int32[nchunks, S, EPG, 3]
    row_len: Optional[np.ndarray] = None  # int32[nchunks, rb] products/row
    # precomputed-slot frontend
    pre: bool = False
    slot_src: Optional[np.ndarray] = None   # int32[nchunks, rb*W], -1 pad
    slot_aidx: Optional[np.ndarray] = None  # int32[nchunks, rb*W]
    # planned frontend (a pre class with host schedules, attach_planned)
    pf: bool = False
    pf_host: Optional[dict] = None          # stacked per-chunk arrays
    pf_spec: Tuple = ()                     # (m_b, nst_b, m_a, nst_a, a_route)

    @property
    def frontend(self) -> str:
        return ("fill" if self.fill else "planned" if self.pf
                else "pre" if self.pre else "gather")


@dataclasses.dataclass
class ExtractPlan:
    """Host plan of the windowed extraction: per output chunk (a CSR slot
    range of ``cap_slots``), the per-row packed-slab spans as (src, dst,
    len) runs grouped into source windows.  One descriptor drives every
    plane (columns, then the value words)."""

    nplanes: int                        # column + value word planes
    nchunks: int
    cap_slots: int                      # output slots per chunk
    wrows: int
    area_pad: int                       # per-plane stream words (128-mult)
    win_row: np.ndarray                 # int32[nchunks, S, 2]
    runs: np.ndarray                    # int32[nchunks, S, EPG, 3]
    device: Optional[torch.device] = None
    dev: Optional[tuple] = None         # (win_row, runs) on ``device``


@dataclasses.dataclass
class BucketPlan:
    """Host plan: row classes, their device tensors, and the sizes the
    first run learns."""

    m: int                              # true row count
    m_cap: int                          # quantized row count
    classes: List[ClassPlan]
    intprod: int
    slab_row_start: Optional[np.ndarray] = None  # int32[m_cap] slab offset
    dma_fill: str = "off"               # resolved: "off", "auto" or "on"
    vwords: int = 2                     # value words: 2 = f64, 1 = f32
    ext: Optional[ExtractPlan] = None   # windowed extraction (or None)
    device: Optional[torch.device] = None        # where ``dev`` lives
    dev: Optional[list] = None          # per class: dict of device tensors
    dev_slab_start: Optional[torch.Tensor] = None
    class_caps: Optional[Tuple[int, ...]] = None  # quantized nnz per class
    nnz_c: Optional[int] = None
    nnz_cap: Optional[int] = None
    crow_h: Optional[np.ndarray] = None  # learned per-row nnz(C) (host)
    ext_src_h: Optional[np.ndarray] = None   # int32[nnz_cap]
    cptr_h: Optional[np.ndarray] = None      # int32[m_cap + 1]
    ext_static_dev: Optional[tuple] = None   # (src, cptr) on ``device``
    ext_pf: Optional[dict] = None            # planned extraction schedules
    ext_pf_spec: Tuple = ()                  # (m_e, nst_e, nch, CH)
    ext_pf_dev: Optional[tuple] = None       # ext_pf on ``device``
    # slots that went through each tail, summed over this plan's runs
    tail_slots: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"direct": 0, "kernel": 0, "sort": 0})
    # of the kernel's, those of classes whose W is not a power of two
    # (padded in registers), summed over this plan's runs
    tail_padded_slots: int = 0
    # of the kernel's, those that one run sends to its wide path (W past
    # 8192), set by each run; and of those the slots that it reads, the
    # products of slab classes (their rows' counts) and every slot of flat
    # ones
    tail_wide_slots: int = 0
    tail_wide_live_slots: int = 0
    # the slots of the gather classes that one run sends to the
    # ``gather_front`` kernel (tensors off the CPU; 0 on the CPU), set by
    # ``upload_plan``; and of those the slots that entries cover
    # (``ent_len``'s sum)
    gather_front_slots: int = 0
    gather_front_live_slots: int = 0
    # the legacy-replan decision (pipeline.prepare_bucketed_state): this
    # plan replaced a discarded planned plan; the demoted share of that
    # judged plan (None where no plan was judged); its demoted classes
    replanned: bool = False
    replan_share: Optional[float] = None
    demoted_classes: int = 0

    def stats(self) -> dict:
        """Occupancy and padding counters, with the JAX package's keys;
        ``frontend`` names the frontend each class runs.  The port adds
        the replan decision: ``replanned``, ``replan_share`` (compared
        with ``_REPLAN_SHARE``) and ``demoted_classes``; and
        ``padded_tail_slots`` (``tail_padded_slots``),
        ``wide_tail_slots`` (``tail_wide_slots``),
        ``wide_tail_live_slots`` (``tail_wide_live_slots``),
        ``gather_front_slots`` and ``gather_front_live_slots``."""
        area = sum(c.W * c.rb * c.nchunks for c in self.classes)
        return {
            "engine": "bucketed",
            "intprod": self.intprod,
            "area_slots": area,
            "padding_ratio": round(area / max(1, self.intprod), 3),
            "nnz_c": self.nnz_c,
            "replanned": self.replanned,
            "replan_share": (None if self.replan_share is None
                             else round(self.replan_share, 3)),
            "demoted_classes": self.demoted_classes,
            "padded_tail_slots": self.tail_padded_slots,
            "wide_tail_slots": self.tail_wide_slots,
            "wide_tail_live_slots": self.tail_wide_live_slots,
            "gather_front_slots": self.gather_front_slots,
            "gather_front_live_slots": self.gather_front_live_slots,
            "classes": [
                {"W": c.W, "chunks": c.nchunks, "rows_per_chunk": c.rb,
                 "rows": int((c.rows_g >= 0).sum()),
                 "entry_cap": c.eb, "hold_passes": c.hold_passes,
                 "seg_passes": c.seg_passes, "fill": c.fill, "G": 1,
                 "frontend": c.frontend}
                for c in self.classes
            ],
        }


def _log2_bound(x: int) -> int:
    return max(1, int(x - 1).bit_length()) if x > 1 else 0


def _width_class(p: np.ndarray, min_width: int) -> np.ndarray:
    """Row width class per product count: powers of two plus 1.5x
    intermediates (8, 12, 16, 24, 32, ...)."""
    if p.size == 0:
        return p.astype(np.int64)
    pow2 = 2 ** np.ceil(np.log2(p)).astype(np.int64)
    half = (3 * pow2) // 4                      # 1.5 * previous pow2
    return np.maximum(min_width, np.where(p <= half, half, pow2))


# ---------------------------------------------------------------------------
# Fill planning (the JAX planner's run plans, verbatim)
# ---------------------------------------------------------------------------

def _plan_runs_chunk(ent_src: np.ndarray, ent_dst: np.ndarray,
                     ent_len: np.ndarray, stride: int, pad_dst: int,
                     wrows: int, epg: int):
    """Run plan of one chunk: merge entry spans into maximal contiguous
    runs, then group them (:func:`_group_runs`).  Returns (win_row
    int32[S, 2], runs int32[S, epg, 3])."""
    live = (ent_len > 0) & (ent_dst < pad_dst)
    es = ent_src[live].astype(np.int64) * stride
    ed = ent_dst[live].astype(np.int64) * stride
    el = ent_len[live].astype(np.int64) * stride
    if es.size == 0:
        return (np.zeros((1, 2), np.int32), np.zeros((1, epg, 3),
                                                     np.int32))
    # entries are in dst order; a run extends while both src and dst
    # advance contiguously (adjacent A columns hit adjacent B rows)
    new = np.ones(es.size, bool)
    new[1:] = (es[1:] != es[:-1] + el[:-1]) | (ed[1:] != ed[:-1] + el[:-1])
    starts = np.flatnonzero(new)
    rs, rd = es[starts], ed[starts]
    rl = np.add.reduceat(el, starts)
    return _group_runs(rs, rd, rl, wrows, epg)


def _group_runs(rs: np.ndarray, rd: np.ndarray, rl: np.ndarray,
                wrows: int, epg: int):
    """Split (src, dst, len) runs to the window payload cap SW =
    wrows*64, sort by source, and group into grid steps on the fixed
    half-window grid (every run of step k lies in [k*SW, k*SW +
    wrows*128)).  Shared by the expansion and the extraction planner."""
    SW = wrows * 128 // 2
    if rs.size == 0:
        return (np.zeros((1, 2), np.int32), np.zeros((1, epg, 3),
                                                     np.int32))
    npieces = (-(-rl // SW)).astype(np.int64)
    if npieces.max(initial=1) > 1:
        idx = np.repeat(np.arange(rs.size), npieces)
        within = (np.arange(idx.size)
                  - np.repeat(np.cumsum(npieces) - npieces, npieces))
        off = within * SW
        rs, rd = rs[idx] + off, rd[idx] + off
        rl = np.minimum(rl[idx] - off, SW)
    o = np.argsort(rs, kind="stable")
    rs, rd, rl = rs[o], rd[o], rl[o]
    rs_b = rs + _FILL_BIAS_WORDS
    wid = rs_b // SW
    neww = np.ones(rs.size, bool)
    neww[1:] = wid[1:] != wid[:-1]
    wstart = np.flatnonzero(neww)
    counts = np.diff(np.concatenate([wstart, [rs.size]]))
    within = np.arange(rs.size) - np.repeat(wstart, counts)
    newstep = neww | (within % epg == 0)
    sid = np.cumsum(newstep) - 1
    S = int(sid[-1]) + 1
    win_row = np.zeros((S, 2), np.int32)
    win_row[sid, 0] = (wid * (SW // 128) - 1).astype(np.int32)
    win_row[:, 1] = np.bincount(sid, minlength=S).astype(np.int32)
    runs = np.zeros((S * epg, 3), np.int32)
    flat = sid * epg + (within % epg)
    runs[flat, 0] = (rs_b - wid * SW + 128).astype(np.int32)
    runs[flat, 1] = rd.astype(np.int32)
    runs[flat, 2] = rl.astype(np.int32)
    return win_row, runs.reshape(S, epg, 3)


def _fill_wrows(W: int, stride: int) -> int:
    """Window rows for a class: at least 2x the widest possible span so
    the half-window grid always fits a run, capped at 128."""
    need = max(16, 2 * ((W * stride + 127) // 128))
    return min(128, 1 << (need - 1).bit_length())


def _pad_steps(wins: list, runss: list):
    """Stack per-chunk run plans, padded to one quantized step count."""
    S = quantize(max(w.shape[0] for w in wins))
    win_row = np.zeros((len(wins), S, 2), np.int32)
    runs = np.zeros((len(wins), S, runss[0].shape[1], 3), np.int32)
    for k, (w, r) in enumerate(zip(wins, runss)):
        win_row[k, :w.shape[0]] = w
        runs[k, :r.shape[0]] = r
    return win_row, runs


def fill_beats_gather(wins: list, slots: int) -> bool:
    """The planner's cost test for a slab of ``slots`` filled by the run
    plans ``wins`` (per chunk, int32[S, 2] win_row): the fill's cost per
    grid step, per run and per slot against the gathers' per slot."""
    steps = sum(w.shape[0] for w in wins)
    runs = sum(int(w[:, 1].sum()) for w in wins)
    fill_ns = (steps * _FILL_STEP_US * 1e3 + runs * _FILL_RUN_US * 1e3
               + slots * _FILL_NS_PER_SLOT)
    return fill_ns < slots * _GATHER_NS_PER_SLOT


def _attach_fill_plan(c: ClassPlan, stride: int, force: bool) -> None:
    """Build per-chunk run plans for a class and take the fill frontend
    if the cost model says it beats the gathers (or ``force``).  The
    stream is planar (one plane per word), so run geometry is in
    elements and one descriptor drives every plane."""
    wrows = _fill_wrows(c.W, 1)
    wins, runss = [], []
    for k in range(c.nchunks):
        w, r = _plan_runs_chunk(c.ent_src[k], c.ent_dst[k], c.ent_len[k],
                                1, c.rb * c.W, wrows, _FILL_EPG)
        wins.append(w)
        runss.append(r)
    if not (force or fill_beats_gather(wins, c.W * c.rb * c.nchunks)):
        return
    win_row, runs = _pad_steps(wins, runss)
    # per-row product count (tight packing: max over entries of dst+len)
    row_len = np.zeros((c.nchunks, c.rb), np.int32)
    for k in range(c.nchunks):
        live = c.ent_len[k] > 0
        dst = c.ent_dst[k][live].astype(np.int64)
        end = dst + c.ent_len[k][live]
        slot = dst // c.W
        np.maximum.at(row_len[k], slot, (end - slot * c.W).astype(
            np.int32))
    c.fill = True
    c.stride = stride
    c.wrows = wrows
    c.out_rows = -(-(c.rb * c.W) // 128)
    c.win_row = win_row
    c.runs = runs
    c.row_len = row_len


def estimate_cost_s(a_ptr: np.ndarray, a_col: np.ndarray,
                    b_ptr: np.ndarray, min_width: int = 8,
                    vwords: int = 2, fill: bool = False) -> float:
    """Host estimate of the bucketed engine's warm time in seconds (no
    plan built), the bucketed side of ``pipeline.choose_engine``: slots
    per width class at a per-slot cost, plus 30 % for extraction.  A
    class whose B spans average at least 16 words costs 10 ns a slot when
    ``fill`` (the state would be prepared for a CUDA device, where the
    fill frontend runs), every other class ``_GATHER_NS_PER_SLOT`` + 5 ns.
    The per-slot costs are the JAX package's TPU v5e figures, not
    measured on the H100."""
    blens = np.diff(b_ptr).astype(np.int64)
    p_ent = blens[a_col]
    cs = np.concatenate([[0], np.cumsum(p_ent)])
    p_row = cs[a_ptr[1:]] - cs[a_ptr[:-1]]
    active = p_row > 0
    if not active.any():
        return 0.0
    p = p_row[active]
    w = _width_class(p, min_width)
    vcs = np.concatenate([[0], np.cumsum(p_ent > 0)])
    vc = (vcs[a_ptr[1:]] - vcs[a_ptr[:-1]])[active]
    stride = 1 + vwords
    total = 0.0
    fill_possible = fill and int(b_ptr[-1]) * stride < 2**31
    for W in np.unique(w):
        sel = w == W
        slots = int(W) * int(sel.sum())
        avg_words = p[sel].sum() * stride / max(1, vc[sel].sum())
        is_fill = (fill_possible and W <= _FILL_WORDS_CAP // stride
                   and avg_words >= _FILL_MIN_SPAN_WORDS)
        per_slot = 10.0 if is_fill else _GATHER_NS_PER_SLOT + 5.0
        total += slots * per_slot * 1e-9
    return total * 1.3


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


def _run_heads(src: np.ndarray, aidx: np.ndarray, W: int) -> np.ndarray:
    """Slots of one chunk that start an A run: a valid slot that does not
    continue the previous slot's entry (same A index, next B source, same
    row).  Returns their positions."""
    L = src.size
    valid = src >= 0
    cont = np.zeros(L, bool)
    cont[1:] = (valid[1:] & valid[:-1] & (aidx[1:] == aidx[:-1])
                & (src[1:] == src[:-1] + 1))
    cont[np.arange(L) % W == 0] = False
    return np.flatnonzero(valid & ~cont)


def _routes(dests: list, m: int):
    """Routing masks of several networks of width ``m``, simulated a few
    MB at a time.  Returns (masks int32[len(dests), nwords, m], nstages)."""
    per = max(1, (1 << 22) // m)
    parts = [pn.plan_routes(np.stack(dests[i: i + per]))
             for i in range(0, len(dests), per)]
    return np.concatenate([p[0] for p in parts]), parts[0][1]


def attach_planned(classes: List[ClassPlan], nnz_b: int) -> None:
    """Give the planned frontend to every ``pre`` class whose chunks the
    host can schedule (the JAX planner's ``attach_planned``): per chunk, a
    windowed gather schedule of the slots' B sources and a routing network
    back to slot order, and the same for the A index of each run head
    (with the heads as hold flags) while that schedule stays dense;
    otherwise the A values stay per-slot gathers (dummy A arrays).

    Eligible: a ``pre`` class of at most ``_PF_CHUNK_CAP`` slots a chunk,
    B with at most ``_PF_TABLE_CAP_WORDS - 1300`` nonzeros, and a network
    no wider than ``4 * _PF_CHUNK_CAP``.  A class whose first chunk over
    that width is found stops being scheduled there: the JAX planner
    drops it on its widest chunk, so the plans agree.  So does a class
    with a chunk that puts more than 64 x 128 slots on one window row
    (``plan_pgather`` returns None), where the JAX planner asserts."""
    if nnz_b + 1300 > _PF_TABLE_CAP_WORDS:
        return
    for c in classes:
        if not c.pre or c.fill:
            continue
        L = c.rb * c.W
        if L > _PF_CHUNK_CAP or c.W > L:
            continue
        scheds = []
        for k in range(c.nchunks):
            src, aidx = c.slot_src[k], c.slot_aidx[k]
            pos = np.flatnonzero(src >= 0)
            bsch = pn.plan_pgather(src[pos].astype(np.int64), 0)
            if bsch is None or pn._pow2(
                    max(bsch[0].shape[0] * 1024, L, 1024)) > 4 * _PF_CHUNK_CAP:
                break
            hpos = _run_heads(src, aidx, c.W)
            asch = pn.plan_pgather(aidx[hpos].astype(np.int64), 0)
            if asch is None:
                break
            scheds.append((pos, bsch, hpos, asch))
        else:
            _attach_schedules(c, scheds, L)


def _attach_schedules(c: ClassPlan, scheds: list, L: int) -> None:
    """Pad one class's per-chunk schedules to common network widths,
    simulate their routes and stack them on the class."""
    Gb = max(s[1][0].shape[0] for s in scheds)
    Ga = max(s[3][0].shape[0] for s in scheds)
    m_b = pn._pow2(max(Gb * 1024, L, 1024))
    m_a = pn._pow2(max(Ga * 1024, L, 1024))
    # the A route when its schedule stays dense; otherwise one gather per
    # slot of the A values (a sparse, scrambled A index pads the schedule
    # and the network with it)
    a_route = m_a <= max(2 * pn._pow2(L), 2048)
    host = {k: [] for k in _PF_FIELDS}
    for pos, bsch, hpos, asch in scheds:
        for k, v in zip(("bg_wblk", "bg_rowsel", "bg_lane"),
                        pn.pad_schedule(bsch, m_b)):
            host[k].append(v)
        if a_route:
            for k, v in zip(("ag_wblk", "ag_rowsel", "ag_lane"),
                            pn.pad_schedule(asch, m_a)):
                host[k].append(v)
            fl = np.zeros(m_a, np.int32)
            fl[hpos] = 1
        else:
            host["ag_wblk"].append(np.zeros(1, np.int32))
            host["ag_rowsel"].append(np.zeros((8, 128), np.int32))
            host["ag_lane"].append(np.zeros((8, 128), np.int32))
            fl = np.zeros(1024, np.int32)
        host["flags"].append(fl)
    host["bt_masks"], nst_b = _routes(
        [pn.route_dest(b[3], m_b, pos) for pos, b, _, _ in scheds], m_b)
    if a_route:
        host["at_masks"], nst_a = _routes(
            [pn.route_dest(a[3], m_a, hpos) for _, _, hpos, a in scheds], m_a)
    else:
        m_a, nst_a = 1024, _PN_NSTAGES_1024
        host["at_masks"] = np.zeros((len(scheds), 1, 1024), np.int32)
    c.pf = True
    c.pf_host = {k: v if isinstance(v, np.ndarray) else np.stack(v)
                 for k, v in host.items()}
    c.pf_spec = (m_b, nst_b, m_a, nst_a, a_route)


def _demote_long_spans(classes: List[ClassPlan]) -> int:
    """``pre`` classes with W > 1 that the planned frontend could not
    schedule and whose entries span at least ``_DEMOTE_SPAN`` slots on
    average fall back to the gather frontend (the JAX planner's rule:
    there the hold-scan broadcasts the A value per entry, not per slot).
    Returns how many classes it demoted."""
    demoted = 0
    for c in classes:
        live = c.ent_len[c.ent_len > 0]
        span = float(live.mean()) if live.size else 0.0
        if (c.pre and not c.pf and c.W > 1 and not c.fill
                and span >= _DEMOTE_SPAN):
            c.pre = False
            c.slot_src = None
            c.slot_aidx = None
            demoted += 1
    return demoted


def replan_share(plan: "BucketPlan") -> float:
    """The share of the slots outside fill classes that the demoted
    (gather-frontend) classes hold; 0 for a plan with no such slots."""
    nf = [(c, c.W * c.rb * c.nchunks) for c in plan.classes if not c.fill]
    tot = sum(s for _, s in nf)
    esc = sum(s for c, s in nf if not c.pre and not c.pf)
    return esc / tot if tot else 0.0


def needs_replan(plan: "BucketPlan") -> bool:
    """The legacy-replan rule of the JAX pipeline: when the demoted
    classes hold at least ``_REPLAN_SHARE`` of the slots outside fill
    classes, the ``precompute=False`` plan (1.5x width grid, its own
    chunking) serves the matrix better."""
    return replan_share(plan) >= _REPLAN_SHARE


def _entries_numpy(a_ptr, a_col, b_starts, p_ent, rows_c, rb, W, nchunks,
                   eb_forced=None):
    """Per-entry descriptors of one class (the numpy twin of
    ``native.bucket_entries``): entries that reference an empty B row are
    dropped, and each entry's source is ``b_starts`` of its column.
    ``eb_forced`` pins the entry capacity (a forced plan); otherwise it is
    the quantized largest chunk's entry count."""
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
    eb = eb_forced if eb_forced is not None else (
        quantize(int(ecnt.max())) if ecnt.size and ecnt.max() else 1)
    shape = (nchunks, eb)
    ent_dst = np.full(shape, rb * W, dtype=np.int32)    # pad -> dropped
    ent_src = np.zeros(shape, dtype=np.int32)
    ent_len = np.zeros(shape, dtype=np.int32)
    ent_aidx = np.zeros(shape, dtype=np.int32)
    within = np.arange(ent_e.size, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(ecnt)[:-1]]), ecnt)
    flat = chunk * eb + within
    ent_dst.ravel()[flat] = dst.astype(np.int32)
    ent_src.ravel()[flat] = b_starts[a_col[ent_e]].astype(np.int32)
    ent_len.ravel()[flat] = pe.astype(np.int32)
    ent_aidx.ravel()[flat] = ent_e.astype(np.int32)
    return eb, (ent_dst, ent_src, ent_len, ent_aidx)


def plan_buckets(a_ptr: np.ndarray, a_col: np.ndarray,
                 b_ptr: Optional[np.ndarray], min_width: int = 2,
                 area_cap: int = 1 << 23, vwords: int = 2,
                 dma_fill: str = "off", precompute: bool = True,
                 planned: str = "off",
                 b_starts: Optional[np.ndarray] = None,
                 b_lens: Optional[np.ndarray] = None,
                 forced: Optional[dict] = None,
                 pow2_fill_widths: bool = False) -> BucketPlan:
    """Bin rows into width classes, consolidate small classes, build
    per-chunk entry descriptors (native builder when the host library is
    present and B is a CSR, numpy otherwise), and pick each class's
    frontend.

    ``vwords`` is the value width in i32 words (2 = f64, 1 = f32).
    ``dma_fill`` ("off", "auto", "on", resolved by the pipeline) lets
    classes with long B spans take the fill frontend: "auto" by the cost
    model, "on" always.  ``precompute`` gives the power-of-two width grid
    and precomputed slot arrays to every class that does not fill;
    without it (the masked engine, the distributed engines) the grid is
    ``_width_class`` from ``min_width`` and such classes run the gather
    frontend.  ``planned`` ("on" or "off", resolved by the pipeline; it
    needs ``precompute``) orders each class's rows by their first B
    source, caps non-fill chunks at ``_PF_CHUNK_CAP`` slots, gives
    schedulable ``pre`` classes the planned frontend
    (:func:`attach_planned`) and demotes the long-span rest to the gather
    frontend.

    ``b_starts`` / ``b_lens`` (int arrays over B's rows) replace the CSR
    layout ``b_ptr[:-1]`` / ``diff(b_ptr)`` that the descriptors point
    into: the distributed engines plan against gathered blocks or a halo
    payload whose row starts are no prefix sum (``b_ptr`` may then be
    None, without the planned frontend).  ``forced`` maps width -> (rb,
    nchunks, eb, fill): those classes exist (rows or none) with those
    shapes and that frontend, every row goes to the narrowest forced
    width that holds it (``ValueError`` when none does), and no class is
    consolidated, so the shards of a mesh share one class layout
    (:func:`plan_buckets_sharded`).  ``pow2_fill_widths`` (the JAX
    planner's, set under ``esc_tail="pow2"``) rounds the width class of
    every row with long B spans (the rows headed for fill classes) up to a
    power of two, before ``forced`` and consolidation apply, so that those
    classes take the pow2 slab tail.  Raises :class:`SlabOverflowError`
    when the slab needs more than int32 indexing."""
    from ..utils import native as native_lib

    m = a_ptr.shape[0] - 1
    csr_layout = b_starts is None and b_lens is None
    b_lens = (np.diff(b_ptr) if b_lens is None else b_lens).astype(np.int64)
    if b_starts is None:
        b_starts = b_ptr[:-1]
    p_ent = b_lens[a_col]                                   # per A-entry
    cs = np.concatenate([[0], np.cumsum(p_ent)])
    p_row = cs[a_ptr[1:]] - cs[a_ptr[:-1]]                  # per C row
    intprod = int(cs[-1])

    active = np.flatnonzero(p_row > 0).astype(np.int32)
    classes: List[ClassPlan] = []
    if active.size == 0 and not forced:
        m_cap = quantize(max(1, m))
        return BucketPlan(m=m, m_cap=m_cap, classes=classes,
                          intprod=intprod, dma_fill=dma_fill,
                          vwords=vwords,
                          slab_row_start=np.zeros(m_cap, np.int32))

    p = p_row[active]
    vcs = np.concatenate([[0], np.cumsum(p_ent > 0)])
    row_vcnt = (vcs[a_ptr[1:]] - vcs[a_ptr[:-1]]).astype(np.int64)
    stride = 1 + vwords
    fill_force = dma_fill == "on"
    fill_ok = (dma_fill in ("auto", "on") and vwords in (1, 2)
               and int(b_starts.max() + b_lens.max()
                       if b_starts.size else 0) * stride < 2**31)
    fill_slot_cap = _FILL_WORDS_CAP // stride
    span = p * stride / np.maximum(1, row_vcnt[active])

    wclass = _width_class(p, min_width)
    if precompute and p.size:
        # pow2 widths (the flat tail needs aligned pow2 segments); rows
        # with one product take the W = 1 direct path
        pw = 2 ** np.ceil(np.log2(np.maximum(1, p))).astype(np.int64)
        wclass = np.where(p == 1, 1, np.maximum(2, pw))
    if pow2_fill_widths and p.size:
        # rows headed for fill classes (long average spans) take a pow2
        # width, so the fill classes run the pow2 slab tail
        pw = 2 ** np.ceil(np.log2(np.maximum(1, wclass))).astype(np.int64)
        wclass = np.where(span >= _FILL_MIN_SPAN_WORDS, pw, wclass)

    if forced is not None and active.size:
        # the union's widths may be sparser than this shard's own grid:
        # each row goes up to the narrowest forced width that holds it
        fw = np.array(sorted(forced), dtype=np.int64)
        if not (wclass <= fw[-1]).all():
            raise ValueError("forced spec narrower than shard rows")
        wclass = fw[np.searchsorted(fw, wclass, side="left")]

    if forced is None:
        # class consolidation: merge a class into the next wider one
        # while the padding cost stays under the fixed per-class cost
        widths_u = sorted(int(w) for w in np.unique(wclass))
        for i, w in enumerate(widths_u[:-1]):
            if w == 1:
                continue                # keep the W = 1 direct class
            sel = wclass == w
            nxt = widths_u[i + 1]
            if nxt > fill_slot_cap >= w:
                continue                # keep a fill-capable class in cap
            fillish = (fill_ok and nxt <= fill_slot_cap
                       and float(span[sel].mean()) >= _FILL_MIN_SPAN_WORDS)
            slot_ns = 10.0 if fillish else _MERGE_SLOT_NS
            if int(sel.sum()) * (nxt - w) * slot_ns < _CLASS_MERGE_NS:
                wclass[sel] = nxt

    pf_on = precompute and planned != "off"
    groups = []
    widths = set(wclass.tolist()) | {int(w) for w in (forced or ())}
    for W in sorted(widths):
        sel = wclass == W
        rows_c = active[sel]                            # original order
        if pf_on and rows_c.size:
            # rows by their first B source, so each chunk covers a
            # contiguous slice of the B table and its schedules stay dense
            fsrc = b_ptr[a_col[a_ptr[rows_c]]]
            rows_c = rows_c[np.argsort(fsrc, kind="stable")]
        cand = False
        if forced is not None:
            # the union pins the frontend, past the shard's cost model
            cand = bool(forced[W][3]) and fill_ok and W <= fill_slot_cap
            rb, nchunks, eb_f = forced[W][:3]
        else:
            if fill_ok and W <= fill_slot_cap:
                pc = int(p[sel].sum())
                ec = int(row_vcnt[rows_c].sum())
                cand = fill_force or (pc * stride / max(1, ec)
                                      >= _FILL_MIN_SPAN_WORDS)
            cap = fill_slot_cap if cand else area_cap
            if pf_on and not cand:
                cap = min(cap, _PF_CHUNK_CAP)   # bounds the network width
            rb = max(1, min(cap // W, quantize(max(1, rows_c.size))))
            nchunks, eb_f = max(1, -(-rows_c.size // rb)), None
        nchunks = max(nchunks, -(-max(1, rows_c.size) // rb))
        groups.append((W, rows_c, rb, nchunks, cand, eb_f))
    area = sum(g[0] * g[2] * g[3] for g in groups)
    if area >= 2**31 or intprod >= 2**31:       # before any slot array
        raise SlabOverflowError(
            f"bucketed slab area {area} / intprod {intprod} exceeds int32 "
            "indexing; split the matrix (spgemm_chunked)")

    for W, rows_c, rb, nchunks, cand, eb_f in groups:
        vc = row_vcnt[rows_c]
        ecnt_max = int(np.max(np.add.reduceat(
            np.concatenate([vc, np.zeros(nchunks * rb - vc.size,
                                         np.int64)]),
            np.arange(0, nchunks * rb, rb))))
        # a forced rb may regroup rows into fuller chunks than the shard's
        # own plan had: eb grows to fit (the sharded planner re-unions)
        eb = quantize(max(1, ecnt_max))
        if eb_f is not None:
            eb = max(eb_f, eb)
        rows_pad = np.full(nchunks * rb, -1, dtype=np.int32)
        rows_pad[: rows_c.size] = rows_c
        ent = (native_lib.bucket_entries(a_ptr, a_col, b_ptr, rows_c, rb,
                                         int(W), eb, nchunks)
               if csr_layout else None)
        if ent is None:
            eb, ent = _entries_numpy(
                a_ptr, a_col, b_starts, p_ent, rows_c, rb, int(W), nchunks,
                eb_forced=eb if eb_f is not None else None)
        c = ClassPlan(W=int(W), rb=rb, nchunks=nchunks, eb=eb,
                      rows_g=rows_pad.reshape(nchunks, rb),
                      ent_dst=ent[0], ent_src=ent[1], ent_len=ent[2],
                      ent_aidx=ent[3], hold_passes=_log2_bound(W),
                      seg_passes=_log2_bound(W))
        if cand:
            _attach_fill_plan(c, stride,
                              force=fill_force or eb_f is not None)
        if precompute and not c.fill:
            _attach_slot_arrays(c)
        classes.append(c)
    demoted = 0
    if pf_on and vwords in (1, 2):
        attach_planned(classes, int(b_ptr[-1]))
        demoted = _demote_long_spans(classes)

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
                      slab_row_start=slab_row_start, dma_fill=dma_fill,
                      vwords=vwords, demoted_classes=demoted)


def class_spec(c: ClassPlan) -> tuple:
    """The shape and frontend of a class: what the shards of a mesh must
    share (the JAX ``ClassPlan.spec`` without its TPU-only fields)."""
    return (c.W, c.rb, c.nchunks, c.eb, c.hold_passes, c.seg_passes,
            c.fill, c.stride, c.wrows, c.out_rows, c.pre, c.pf, c.pf_spec)


def plan_buckets_sharded(a_ptr: np.ndarray, a_col: np.ndarray,
                         n_shards: int, rows_per_shard: int,
                         b_ptr: Optional[np.ndarray] = None,
                         min_width: int = 128, area_cap: int = 1 << 23,
                         b_starts=None, b_lens=None,
                         a_col_shards: Optional[List[np.ndarray]] = None,
                         dma_fill: str = "off", vwords: int = 2,
                         bounds: Optional[np.ndarray] = None,
                         ) -> List[BucketPlan]:
    """Per-shard bucket plans with one class layout, the port of the JAX
    ``plan_buckets_sharded`` (``mh_spgemm_tpu/ops/bucketed.py:1623``).

    Shard d owns rows ``[d*R, (d+1)*R)``, or ``[bounds[d], bounds[d+1])``,
    or, for a 2-D ``bounds`` of (lo, hi) rows, ``bounds[d]`` (the grid's
    virtual shards repeat row ranges).  Its A block is padded to R rows.
    ``b_starts`` / ``b_lens`` are one array (replicated or gathered B) or
    a list per shard (the halo payload); ``a_col_shards`` replaces each
    shard's A columns (halo-remapped).  Each shard is planned free
    (``precompute=False``, ``planned="off"``), then the class shapes and
    frontends are unioned (max rb, nchunks and eb per width; a width
    fills where any shard's plan fills it, its rb then clamped to the
    fill budget) and every shard is replanned under the union until eb
    stops growing (at most 4 rounds); the fill run plans are padded to
    one step count.  The plans then share :func:`class_spec` class for
    class."""
    R = rows_per_shard
    m = a_ptr.shape[0] - 1

    def shard_csr(d):
        if bounds is None:
            lo, hi = min(d * R, m), min((d + 1) * R, m)
        elif np.ndim(bounds) == 2:
            lo, hi = int(bounds[d][0]), int(bounds[d][1])
        else:
            lo, hi = int(bounds[d]), int(bounds[d + 1])
        ptr = (a_ptr[lo:hi + 1] - a_ptr[lo]).astype(a_ptr.dtype)
        if hi <= lo:
            ptr = np.zeros(1, a_ptr.dtype)
        ptr = np.concatenate([ptr, np.full(R + 1 - ptr.size, ptr[-1],
                                           ptr.dtype)])
        if a_col_shards is not None:
            col = a_col_shards[d]
        elif hi > lo:
            col = a_col[a_ptr[lo]: a_ptr[hi]]
        else:
            col = np.zeros(0, a_col.dtype)
        return ptr, col

    def pick(x, d):
        return x[d] if isinstance(x, (list, tuple)) else x

    def plan_all(forced):
        out = []
        for d in range(n_shards):
            ptr, col = shard_csr(d)
            out.append(plan_buckets(
                ptr, col, b_ptr, min_width=min_width, area_cap=area_cap,
                vwords=vwords, dma_fill=dma_fill, precompute=False,
                planned="off", b_starts=pick(b_starts, d),
                b_lens=pick(b_lens, d), forced=forced))
        return out

    plans = plan_all(None)
    fill_rb_cap = max(1, _FILL_WORDS_CAP // (1 + vwords))
    forced: dict = {}
    for pl_ in plans:
        for c in pl_.classes:
            rb, nch, eb, fl = forced.get(c.W, (1, 1, 1, False))
            fl = fl or c.fill
            rb = max(rb, c.rb)
            if fl:
                # a fill class keeps the fill budget (a gather-only shard
                # may have chosen a bigger chunk under the area budget)
                rb = min(rb, max(1, fill_rb_cap // c.W))
            forced[c.W] = (rb, max(nch, c.nchunks), max(eb, c.eb), fl)
    for _ in range(4):
        out = plan_all(forced)
        new_forced = {
            W: (forced[W][0],
                max(pl_.classes[i].nchunks for pl_ in out),
                max(pl_.classes[i].eb for pl_ in out),
                forced[W][3])
            for i, W in enumerate(sorted(forced))}
        if new_forced == forced:
            break
        forced = new_forced
    # one fill step count per class over the shards (zero steps copy
    # nothing)
    for i in range(len(out[0].classes)):
        if not out[0].classes[i].fill:
            continue
        S = max(p.classes[i].win_row.shape[1] for p in out)
        for p in out:
            c = p.classes[i]
            s0 = c.win_row.shape[1]
            if s0 < S:
                c.win_row = np.pad(c.win_row, ((0, 0), (0, S - s0),
                                               (0, 0)))
                c.runs = np.pad(c.runs, ((0, 0), (0, S - s0), (0, 0),
                                         (0, 0)))
    specs = {tuple(class_spec(c) for c in p.classes) for p in out}
    assert len(specs) == 1, "sharded plans must share one class layout"
    return out


_CLASS_FIELDS = ("W", "rb", "nchunks", "eb", "rows_g", "ent_dst",
                 "ent_src", "ent_len", "ent_aidx", "hold_passes",
                 "seg_passes")
_INT_FIELDS = ("W", "rb", "nchunks", "eb", "hold_passes", "seg_passes",
               "stride", "wrows", "out_rows")
_PRE_FIELDS = ("slot_src", "slot_aidx")
_FILL_FIELDS = ("stride", "wrows", "out_rows", "win_row", "runs",
                "row_len")
_PF_FIELDS = ("bg_wblk", "bg_rowsel", "bg_lane", "bt_masks", "ag_wblk",
              "ag_rowsel", "ag_lane", "at_masks", "flags")


def plan_from_arrays(fields: dict) -> BucketPlan:
    """Rebuild a plan from plain fields: ``m``, ``m_cap``, ``intprod``,
    ``slab_row_start``, optionally ``dma_fill`` and ``vwords``, and
    ``classes``, a list of dicts (for example ``vars()`` of the classes of
    a JAX package ``BucketPlan``).  A class holds every name in
    ``_CLASS_FIELDS``, plus the slot arrays when ``pre`` or the planar
    fill fields when ``fill``; without either it runs the gather
    frontend.  A planned class (``pf``) also holds ``pf_host`` and
    ``pf_spec`` (the JAX spec's interpret flag is dropped).  A grouped
    class (``G > 1``) or an interleaved fill class raises: the port does
    not run them.  The JAX ``dma_fill="interpret"`` reads as "on"."""
    classes = []
    for cf in fields["classes"]:
        if cf.get("G", 1) != 1:
            raise NotImplementedError(
                "grouped classes are a TPU-only transport device the port "
                "does not carry (ROADMAP ground rules)")
        fill = bool(cf.get("fill"))
        if fill and not cf.get("planar"):
            raise NotImplementedError(
                "the port's fill frontend takes planar streams only")
        pre = not fill and bool(cf.get("pre", cf.get("slot_src") is not None))
        names = _CLASS_FIELDS + (_FILL_FIELDS if fill else ()) + (
            _PRE_FIELDS if pre else ())
        kw = {k: cf[k] for k in names}
        for k, v in kw.items():
            kw[k] = int(v) if k in _INT_FIELDS else np.ascontiguousarray(
                v, dtype=np.int32)
        if cf.get("pf"):
            if not pre or cf.get("pf_host") is None or not cf.get("pf_spec"):
                raise ValueError("a planned class needs its slot arrays, "
                                 "pf_host and pf_spec")
            spec = tuple(cf["pf_spec"])
            m_b, nst_b, m_a, nst_a = (int(x) for x in spec[:4])
            kw.update(pf=True, pf_spec=(m_b, nst_b, m_a, nst_a,
                                        bool(spec[-1])),
                      pf_host={k: np.ascontiguousarray(cf["pf_host"][k],
                                                       dtype=np.int32)
                               for k in _PF_FIELDS})
        classes.append(ClassPlan(pre=pre, fill=fill, **kw))
    mode = fields.get("dma_fill", "off")
    return BucketPlan(
        m=int(fields["m"]), m_cap=int(fields["m_cap"]), classes=classes,
        intprod=int(fields["intprod"]),
        slab_row_start=np.ascontiguousarray(fields["slab_row_start"],
                                            dtype=np.int32),
        dma_fill="on" if mode == "interpret" else mode,
        vwords=int(fields.get("vwords", 2)))


# ---------------------------------------------------------------------------
# Fill streams
# ---------------------------------------------------------------------------

def needs_pairs(plan: BucketPlan) -> bool:
    return any(c.fill for c in plan.classes)


def pairs_wrows_max(plan: BucketPlan) -> int:
    return max((c.wrows for c in plan.classes if c.fill), default=0)


def pairs_plane_pitch(nnz: int, wrows_max: int) -> int:
    """Row pitch of one plane of the planar stream: bias + data + window
    slack, so a window read from the last run of a plane stays inside
    that plane's rows."""
    return -(-(_FILL_BIAS_WORDS + nnz) // 128) + wrows_max + rf.PAD_ROWS


def build_pairs_planar(b_col: np.ndarray, b_val: np.ndarray, vwords: int,
                       wrows_max: int) -> np.ndarray:
    """Planar stream for the fill frontend: one ``[pitch, 128]`` plane per
    word (the column, then the raw words of the value: two for f64, one
    for f32 or any other 4-byte type) stacked vertically, each with the
    bias prepad.  Returns i32[planes * pitch, 128]; the JAX package's
    ``build_pairs_planar`` with ``df=False``."""
    nnz = b_col.shape[0]
    vw = (b_val.view(np.int32).reshape(nnz, vwords) if nnz
          else np.zeros((0, vwords), np.int32))
    planes = [b_col.astype(np.int32)] + [vw[:, i] for i in range(vwords)]
    pitch = pairs_plane_pitch(nnz, wrows_max)
    out = np.zeros((len(planes) * pitch, 128), np.int32)
    flat = out.reshape(-1)
    for pidx, pl_ in enumerate(planes):
        base = pidx * pitch * 128 + _FILL_BIAS_WORDS
        flat[base: base + nnz] = pl_
    return out


def pairs_planar_device(b_col: torch.Tensor, b_val: torch.Tensor,
                        vwords: int, wrows_max: int) -> torch.Tensor:
    """:func:`build_pairs_planar` from tensors already on their device:
    the distributed engines build a shard's fill stream after the
    collective that brought its B payload (the port of the JAX
    ``pairs_device``, ``mh_spgemm_tpu/ops/bucketed.py:1042``, in the
    planar encoding; the value words are read in place).  Returns
    i32[planes * pitch, 128] on ``b_col``'s device."""
    nnz = b_col.shape[0]
    words = _words(b_val)
    if len(words) != vwords:
        raise ValueError(f"{vwords} value words planned, {len(words)} "
                         "given")
    pitch = pairs_plane_pitch(nnz, wrows_max)
    out = torch.zeros(((1 + vwords) * pitch, 128), dtype=torch.int32,
                      device=b_col.device)
    flat = out.view(-1)
    for pidx, pl_ in enumerate([b_col.to(torch.int32)] + words):
        base = pidx * pitch * 128 + _FILL_BIAS_WORDS
        flat[base: base + nnz] = pl_
    return out


# ---------------------------------------------------------------------------
# Windowed extraction planning
# ---------------------------------------------------------------------------

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
    attach_planned_extract(plan)


def attach_planned_extract(plan: BucketPlan) -> None:
    """The planned extraction's schedules (the JAX
    ``attach_static_extract``'s second half), when a class is planned:
    the slab-to-CSR gather of each output chunk of ``_PF_CHUNK_CAP`` slots
    as a ``pgather`` schedule of its slab sources and a routing network
    back to output order.  None where a chunk's network would pass
    ``4 * _PF_CHUNK_CAP`` or a chunk's schedule would put more than 64 x
    128 slots on one window row (where the JAX planner asserts)."""
    plan.ext_pf = None
    plan.ext_pf_spec = ()
    plan.ext_pf_dev = None
    if not (any(c.pf for c in plan.classes) and plan.nnz_c):
        return
    CH = _PF_CHUNK_CAP
    nch = max(1, -(-plan.nnz_cap // CH))
    scheds = []
    for i in range(nch):
        lo, hi = i * CH, min(plan.nnz_c, (i + 1) * CH)
        srcs = (plan.ext_src_h[lo:hi].astype(np.int64) if hi > lo
                else np.zeros(0, np.int64))
        sch = pn.plan_pgather(srcs, 0)
        if sch is None or pn._pow2(max(sch[0].shape[0] * 1024, CH, 1024)) \
                > 4 * _PF_CHUNK_CAP:
            return               # as the JAX planner on its widest chunk
        scheds.append(sch)
    m_e = pn._pow2(max(max(s[0].shape[0] for s in scheds) * 1024, CH, 1024))
    pads = [pn.pad_schedule(s, m_e) for s in scheds]
    masks, nst_e = _routes([pn.route_dest(s[3], m_e) for s in scheds], m_e)
    plan.ext_pf = {"wblk": np.stack([p[0] for p in pads]),
                   "rowsel": np.stack([p[1] for p in pads]),
                   "lane": np.stack([p[2] for p in pads]),
                   "masks": masks}
    plan.ext_pf_spec = (m_e, nst_e, nch, CH)


def build_extract_plan(crow: np.ndarray, slab_row_start: np.ndarray,
                       *, area: int, nplanes: int,
                       force: bool) -> Optional[ExtractPlan]:
    """Windowed-extraction plan for any engine whose output lies in
    left-packed row slabs addressed by ``slab_row_start`` (bucketed and
    masked classes, block-dense strips): one (src, dst, len) run per
    nonempty C row, split at output-chunk and window caps.  None when the
    rows are too short (average under 16 outputs, unless ``force``), the
    addressing or the memory guard would overflow, or the cost model
    prefers the gather extraction (unless ``force``)."""
    nnz_c = int(crow.sum())
    if nnz_c == 0:
        return None
    avg_slots = nnz_c / max(1, int((crow > 0).sum()))
    if not force and avg_slots < _FILL_MIN_SPAN_WORDS:
        return None
    area_pad = -(-area // 128) * 128
    nnz_cap = quantize(max(1, nnz_c))
    if (area_pad * nplanes + _FILL_BIAS_WORDS >= 2**31
            or nnz_cap * nplanes >= 2**31):
        return None
    peak_bytes = area * 12 + area * nplanes * 4 + nnz_cap * nplanes * 8
    if peak_bytes > _EXTRACT_PEAK_BYTES:
        return None
    rows = np.flatnonzero(crow > 0)
    cptr = np.concatenate([[0], np.cumsum(crow, dtype=np.int64)])
    src = slab_row_start[rows].astype(np.int64)
    dst = cptr[rows]
    ln = crow[rows].astype(np.int64)
    CAPS = _FILL_WORDS_CAP // nplanes       # output slots per chunk
    wrows = 128
    # split runs at output-chunk boundaries, then bucket by chunk
    first = dst // CAPS
    last = (dst + ln - 1) // CAPS
    npieces = (last - first + 1)
    if npieces.max(initial=1) > 1:
        idx = np.repeat(np.arange(src.size), npieces)
        within = (np.arange(idx.size)
                  - np.repeat(np.cumsum(npieces) - npieces, npieces))
        cut = (first[idx] + within) * CAPS
        lo = np.maximum(dst[idx], cut)
        hi = np.minimum(dst[idx] + ln[idx], cut + CAPS)
        src = src[idx] + (lo - dst[idx])
        ln = hi - lo
        dst = lo
    cid = dst // CAPS
    nchunks = max(1, -(-nnz_cap // CAPS))
    wins, runss, s_total, r_total = [], [], 0, 0
    order = np.argsort(cid, kind="stable")
    src, dst, ln, cid = src[order], dst[order], ln[order], cid[order]
    bounds = np.searchsorted(cid, np.arange(nchunks + 1))
    for o in range(nchunks):
        sel = slice(bounds[o], bounds[o + 1])
        w, r = _group_runs(src[sel], dst[sel] - o * CAPS, ln[sel],
                           wrows, _FILL_EPG)
        wins.append(w)
        runss.append(r)
        s_total += w.shape[0]
        r_total += int(w[:, 1].sum())
    # one descriptor drives all planes: 0.17 us of extra walk per extra
    # plane on top of the first (TPU v5e figures, like every cost here)
    fill_est = (s_total * _FILL_STEP_US * 1e3
                + r_total * (_FILL_RUN_US + 0.17 * (nplanes - 1)) * 1e3
                + nnz_c * nplanes * 0.7)
    gather_est = nnz_c * (43.0 if nplanes == 3 else 29.0)
    if fill_est >= gather_est and not force:
        return None
    win_row, runs = _pad_steps(wins, runss)
    return ExtractPlan(nplanes=nplanes, nchunks=nchunks,
                       cap_slots=CAPS, wrows=wrows,
                       area_pad=area_pad, win_row=win_row, runs=runs)


def warm_plan_from_crow(plan: BucketPlan, crow: np.ndarray) -> None:
    """Fix what the first run's readback fixes, from per-row nnz(C)
    counts: per-class capacities, nnz(C), the static extraction operands
    and, where the plan's fill mode allows it and the cost model agrees,
    the windowed extraction plan.  ``finish_bucketed`` calls it with the
    counts it reads back; given counts learned before (from the same
    matrices and config), a fresh plan's first call takes the warm
    path.  Host work only: the ``learn`` span."""
    with span("learn"):
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
        plan.ext = None
        if plan.dma_fill != "off" and plan.nnz_c:
            plan.ext = build_extract_plan(
                plan.crow_h, plan.slab_row_start,
                area=sum(c.W * c.rb * c.nchunks for c in plan.classes),
                nplanes=1 + plan.vwords, force=plan.dma_fill == "on")


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

_DEV_FIELDS = {
    "fill": ("rows_g", "ent_dst", "ent_len", "ent_aidx", "row_len",
             "win_row", "runs"),
    "pre": ("rows_g", "slot_src", "slot_aidx"),
    "planned": ("rows_g", "slot_src", "slot_aidx") + _PF_FIELDS,
    "gather": ("rows_g", "ent_dst", "ent_src", "ent_len", "ent_aidx"),
}


def _host_field(c: ClassPlan, k: str) -> np.ndarray:
    return c.pf_host[k] if k in _PF_FIELDS else getattr(c, k)


def upload_plan(plan: BucketPlan, device) -> None:
    """Copy each class's tensors (those its frontend reads) to ``device``
    once and keep them on the plan; set ``gather_front_slots`` and
    ``gather_front_live_slots`` for runs on ``device`` (0 on the CPU,
    whose tensors take the plain gather frontend)."""
    device = torch.device(device)
    if plan.dev is not None and plan.device == device:
        return
    with span("upload"):
        plan.device = device
        plan.dev = [{k: torch.as_tensor(_host_field(c, k)).to(device)
                     for k in _DEV_FIELDS[c.frontend]}
                    for c in plan.classes]
        plan.dev_slab_start = torch.as_tensor(plan.slab_row_start).to(
            device)
        plan.ext_static_dev = None
        plan.ext_pf_dev = None
        cls = ([c for c in plan.classes if c.frontend == "gather"]
               if device.type != "cpu" else [])
        plan.gather_front_slots = sum(c.nchunks * c.rb * c.W for c in cls)
        plan.gather_front_live_slots = sum(int(c.ent_len.sum())
                                           for c in cls)


def _product(AV, bv, valid):
    """Masked product in the value type (native f64 on the card)."""
    return torch.where(valid, AV * bv, torch.zeros((), dtype=bv.dtype,
                                                   device=bv.device))


def _hold_rows(starts: torch.Tensor, *values: torch.Tensor):
    """Broadcast the value at each segment start down its segment, per
    row (segments marked by ``starts``); slots before a row's first start
    keep their own value.  The JAX package's ``_hold_scan_rows`` with
    log2(W) passes, as one running max of start positions and a gather."""
    R, W = starts.shape
    pos = torch.arange(W, device=starts.device).expand(R, W)
    idx = torch.cummax(torch.where(starts, pos, -1), dim=1).values
    held = idx >= 0
    idx = idx.clamp(min=0)
    return [torch.where(held, torch.gather(v, 1, idx), v) for v in values]


def _seed(ent_dst, vals, *, rows: int, RW: int, W: int, fill=0):
    """Scatter per-entry values to their slots in ``[nchunks * rb, W]``
    (entries padded to ``rb * W`` are dropped)."""
    nch = ent_dst.shape[0]
    dev = ent_dst.device
    live = ent_dst < RW
    flat = torch.where(live, ent_dst.long()
                       + torch.arange(nch, device=dev)[:, None] * RW,
                       nch * RW).reshape(-1)
    out = torch.full((nch * RW + 1,), fill, dtype=vals.dtype, device=dev)
    out[flat] = vals.reshape(-1)
    return out[: nch * RW].view(rows, W)


def front_gather_plain(d: dict, a_val, b_col, b_val, *, W: int, rb: int):
    """Gather frontend over all chunks of a class: seed each entry's
    (B source, length, slot, A value) at its first slot, hold them down
    the entry's span, and gather B's column and value per slot (the JAX
    package's ``_front_gather`` with plain takes).  Returns (K, prod,
    valid), ``[nchunks * rb, W]``, with K 2^31-1 and prod 0 where no
    product lands."""
    ent_dst = d["ent_dst"]
    RW = rb * W
    rows = ent_dst.shape[0] * rb
    kw = dict(rows=rows, RW=RW, W=W)
    starts = _seed(ent_dst, torch.ones_like(ent_dst, dtype=torch.bool),
                   fill=False, **kw)
    src0, len0, dst_s, AV = _hold_rows(
        starts, _seed(ent_dst, d["ent_src"], **kw),
        _seed(ent_dst, d["ent_len"], **kw), _seed(ent_dst, ent_dst, **kw),
        _seed(ent_dst, a_val[d["ent_aidx"].long()], **kw))
    pos = torch.arange(RW, dtype=torch.int32, device=ent_dst.device).view(
        rb, W).repeat(ent_dst.shape[0], 1)
    off = pos - dst_s
    valid = (off >= 0) & (off < len0)
    src = torch.where(valid, src0 + off, 0).long()
    K = torch.where(valid, b_col[src], I32_MAX)
    return K, _product(AV, b_val[src], valid), valid


def front_gather(d: dict, a_val, b_col, b_val, *, W: int, rb: int):
    """Gather frontend of a class: on CUDA tensors one launch of the
    ``gather_front`` kernel (``ops/gather_front.py``), on CPU tensors its
    plain version :func:`front_gather_plain`.  Returns (K, prod, row_len):
    ``[nchunks * rb, W]`` with K 2^31-1 and prod 0 where no product
    lands, and each row's product count."""
    if a_val.device.type != "cpu":
        return gf.gather_front(d, a_val, b_col, b_val, W=W, rb=rb)
    K, prod, valid = front_gather_plain(d, a_val, b_col, b_val, W=W, rb=rb)
    return K, prod, valid.sum(dim=1, dtype=torch.int32)


def slab_planes(slab, *, nplanes: int, out_rows: int, rb: int, W: int):
    """The planes of a batched ``ragged_fill`` output (per chunk,
    ``nplanes`` planes of ``out_rows`` rows one after another), each cut
    to the chunks' ``[rb, W]`` slabs: ``nplanes`` tensors of
    ``[nchunks * rb, W]``."""
    flat = slab.view(slab.shape[0], -1)
    n = out_rows * 128
    return [flat[:, p * n: p * n + rb * W].reshape(-1, W)
            for p in range(nplanes)]


def front_fill(d: dict, a_val, pairs2d, *, W: int, rb: int, stride: int,
               out_rows: int):
    """Fill frontend over all chunks of a class (the JAX package's
    ``_front_fill``, planar branch): one ``ragged_fill`` launch streams
    every chunk's B columns and value words into its slab, the A value
    of each entry is held down its span, and validity is one comparison
    with the plan's per-row count.  Returns (K, prod, row_len): the raw
    slab columns and products, ``[nchunks * rb, W]``, undefined at and
    past each row's ``row_len``."""
    slab = rf.ragged_fill(d["win_row"], d["runs"], pairs2d,
                          out_rows=stride * out_rows, nplanes=stride,
                          src_stride_rows=pairs2d.shape[0] // stride,
                          dst_stride=out_rows * 128)
    planes = slab_planes(slab, nplanes=stride, out_rows=out_rows, rb=rb,
                         W=W)
    K = planes[0]
    if stride == 3:           # the two raw words of each f64 value
        bv = torch.stack(planes[1:], dim=-1).view(torch.float64).squeeze(-1)
    else:
        bv = planes[1].view(torch.float32).to(a_val.dtype)
    ent_dst = d["ent_dst"]
    kw = dict(rows=K.shape[0], RW=rb * W, W=W)
    starts = _seed(ent_dst, torch.ones_like(ent_dst, dtype=torch.bool),
                   fill=False, **kw)
    AV, = _hold_rows(starts, _seed(ent_dst, a_val[d["ent_aidx"].long()],
                                   **kw))
    return K.contiguous(), (AV * bv).contiguous(), d["row_len"].reshape(-1)


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


def _words(v: torch.Tensor) -> list:
    """The i32 word planes of a value array, read in place: the two words
    of each f64 (low, high) as two strided views, or the one word of an
    f32."""
    w = v.view(torch.int32)
    if v.dtype == torch.float64:
        return [w[0::2], w[1::2]]
    return [w]


def _from_words(planes: list, dtype: torch.dtype) -> torch.Tensor:
    """Values from their word planes (the inverse of :func:`_words`)."""
    if dtype == torch.float64:
        return torch.stack(planes, dim=-1).view(torch.float64).squeeze(-1)
    return planes[0].contiguous().view(torch.float32)


def front_planned(c: ClassPlan, d: dict, a_val, b_col, b_val):
    """Planned frontend over all chunks of a class (the port of
    ``_chunk_planned``, ``mh_spgemm_tpu/ops/bucketed.py:1473``): one
    ``pgather`` of B's column and value words on the class's stacked
    schedules and one ``proute`` back to slot order; for the A values one
    ``pgather`` of the run heads' words and one ``proute`` with the hold
    down each run, or, where the class has no A route, a plain gather by
    the slot's A index.  Returns flat (K, prod, valid) as
    :func:`expand_pre` does."""
    m_b, nst_b, m_a, nst_a, a_route = c.pf_spec
    L = c.rb * c.W
    valid = d["slot_src"] >= 0                              # [nchunks, L]
    g = pn.pgather([b_col] + _words(b_val), d["bg_wblk"], d["bg_rowsel"],
                   d["bg_lane"])
    r = pn.proute(g, d["bt_masks"], nst_b)[:, :, :L]
    K = torch.where(valid, r[0], I32_MAX).reshape(-1)
    bv = _from_words(list(r[1:]), b_val.dtype).reshape(-1)
    if a_route:
        ga = pn.pgather(_words(a_val), d["ag_wblk"], d["ag_rowsel"],
                        d["ag_lane"])
        ra = pn.proute(ga, d["at_masks"], nst_a, hold_w2=c.W,
                       flags=d["flags"])[:, :, :L]
        AV = _from_words(list(ra), a_val.dtype).reshape(-1)
    else:
        ai = torch.where(valid, d["slot_aidx"], 0).reshape(-1)
        AV = a_val.index_select(0, ai)
    valid = valid.reshape(-1)
    return K, _product(AV, bv, valid), valid


def seg_scan_rows(values, new, passes: int, op=torch.add):
    """Segmented inclusive scan along rows by ``op`` (a sum, or an OR of
    bit masks; ``new`` marks run starts): Hillis-Steele, ``passes``
    doublings."""
    v, f = values, new
    dist = 1
    for _ in range(passes):
        sv = torch.zeros_like(v)
        sv[:, dist:] = v[:, :-dist]
        sf = torch.ones_like(f)
        sf[:, dist:] = f[:, :-dist]
        v = torch.where(f, v, op(v, sv))
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
    run = seg_scan_rows(sV, new, seg_passes)
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


_TAIL_SPANS = {t: "tail." + t for t in ("direct", "kernel", "sort")}
_FRONT_SPANS = {f: "front." + f for f in ("fill", "planned", "pre",
                                           "gather")}


def tail_route(W: int, route: str, device_type: str) -> str:
    """The tail that a class of width W takes: ``"direct"`` for W = 1;
    ``"kernel"`` where ``route`` is "kernel" and the kernel takes W (a
    power of two up to 65536 on any device, CPU tensors running its plain
    version; on CUDA every W up to the int32 slab bound: padded in
    registers up to 8192, the wide path past it); else ``"sort"``."""
    if W == 1:
        return "direct"
    if route != "kernel":
        return "sort"
    if device_type == "cuda" or esc_tail_mod.supported_w2(W):
        return "kernel"
    return "sort"


def _flat_tail(K, prod, valid, *, W: int, rows: int, seg_passes: int,
               route: str, counts: Dict[str, int]):
    """Tail of a precomputed class (W a power of two) over flat ``[rows *
    W]`` planes, routed by :func:`tail_route`: the direct path, the
    kernel's flat form ``esc_tail_flat`` or the sort tail.  Adds the
    class's slots to ``counts`` under the route taken.  Returns (oC [L],
    oV [L], nnz_row [rows])."""
    L = rows * W
    tail = tail_route(W, route, K.device.type)
    counts[tail] += L
    if tail == "kernel":
        with span(_TAIL_SPANS[tail], W=W, w2=W,
                  path=esc_tail_mod.path_for(W)):
            return esc_tail_mod.esc_tail_flat(K, prod, w2=W)
    with span(_TAIL_SPANS[tail], W=W):
        if tail == "direct":
            return K, prod, valid.to(torch.int32)
        oC, oV, nnz_row = _chunk_tail(K.view(rows, W), prod.view(rows, W),
                                      seg_passes=seg_passes)
        return oC.reshape(L), oV.reshape(L), nnz_row


def slab_tail(K, prod, row_len, *, W: int, seg_passes: int, route: str,
              counts: Dict[str, int]):
    """Tail of a ``[rows, W]`` slab whose slots at and past ``row_len``
    are empty (the JAX package's ``_chunk_tail``), routed by
    :func:`tail_route`: the slab kernel ``esc_tail`` with ``row_len``
    (rows padded to the next power of two where W is none); otherwise the
    slots are masked and W = 1 takes the direct path, any other width the
    sort tail.  Returns flat (oC [L], oV [L], nnz_row [rows])."""
    rows = K.shape[0]
    L = rows * W
    tail = tail_route(W, route, K.device.type)
    counts[tail] += L
    if tail == "kernel":
        w2 = esc_tail_mod.pad_w2(W)
        with span(_TAIL_SPANS[tail], W=W, w2=w2,
                  path=esc_tail_mod.path_for(w2)):
            oC, oV, nnz_row = esc_tail_mod.esc_tail(K, prod, row_len, w2=w2)
            return oC.reshape(L), oV.reshape(L), nnz_row
    with span(_TAIL_SPANS[tail], W=W):
        valid = (torch.arange(W, device=K.device)[None, :]
                 < row_len.to(torch.int64)[:, None])
        K = torch.where(valid, K, I32_MAX)
        prod = torch.where(valid, prod, torch.zeros((), dtype=prod.dtype,
                                                    device=prod.device))
        if tail == "direct":
            return K.reshape(L), prod.reshape(L), valid.sum(
                dim=1, dtype=torch.int32)
        oC, oV, nnz_row = _chunk_tail(K, prod, seg_passes=seg_passes)
        return oC.reshape(L), oV.reshape(L), nnz_row


def class_front(c: ClassPlan, d: dict, a_val, b_col, b_val, pairs2d):
    """The frontend of class ``c`` over all its chunks, in its
    ``front.<frontend>`` span; its output feeds :func:`class_tail`."""
    with span(_FRONT_SPANS[c.frontend], W=c.W):
        if c.fill:
            return front_fill(d, a_val, pairs2d, W=c.W, rb=c.rb,
                              stride=c.stride, out_rows=c.out_rows)
        if c.pf:
            return front_planned(c, d, a_val, b_col, b_val)
        if c.pre:
            return expand_pre(d["slot_src"], d["slot_aidx"], a_val, b_col,
                              b_val)
        return front_gather(d, a_val, b_col, b_val, W=c.W, rb=c.rb)


def class_tail(c: ClassPlan, front, *, route: str,
               counts: Dict[str, int]):
    """The tail of class ``c`` on its frontend's output; returns the
    class slab ``(cols [L], vals [L], nnz_row [rows])``, left-packed per
    row."""
    rows = c.nchunks * c.rb
    if c.pre:
        return _flat_tail(*front, W=c.W, rows=rows, seg_passes=c.seg_passes,
                          route=route, counts=counts)
    return slab_tail(*front, W=c.W, seg_passes=c.seg_passes, route=route,
                     counts=counts)


def bucketed_main(plan: BucketPlan, a_val, b_col, b_val, pairs2d=None, *,
                  route: str):
    """Main stage over every class; returns the per-class slabs
    ``[(cols [L], vals [L], nnz_row [rows])]``, left-packed per row.
    ``pairs2d`` is the planar fill stream (needed when a class fills).
    Adds the slots of the classes that the kernel padded to
    ``plan.tail_padded_slots``, and sets ``plan.tail_wide_slots`` to the
    slots that took its wide path and ``plan.tail_wide_live_slots`` to
    those of them that it read."""
    slabs = []
    wide = live = 0
    for c, d in zip(plan.classes, plan.dev):
        slabs.append(class_tail(
            c, class_front(c, d, a_val, b_col, b_val, pairs2d),
            route=route, counts=plan.tail_slots))
        if tail_route(c.W, route, a_val.device.type) == "kernel":
            slots = c.nchunks * c.rb * c.W
            if c.W & (c.W - 1):
                plan.tail_padded_slots += slots
            if esc_tail_mod.path_for(esc_tail_mod.pad_w2(c.W)) == "wide":
                wide += slots
                # a slab row's slots past its count are never loaded
                live += slots if c.pre else int(c.ent_len.sum())
    plan.tail_wide_slots = wide
    plan.tail_wide_live_slots = live
    return slabs


def bucketed_counts(plan: BucketPlan, slabs):
    """Per-row nnz(C) scattered from the class slabs, its prefix sum, and
    per-class totals.  Returns (crow int32[m_cap], cptr int32[m_cap+1],
    totals int64[classes])."""
    dev = plan.device
    m = plan.m_cap
    crow = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    totals = []
    for d, (_, _, nnz_row) in zip(plan.dev, slabs):
        rows_g = d["rows_g"]
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


def bucketed_extract_planned(slabs, ext_dev: tuple, spec: tuple, *,
                             nnz_cap: int, nnz_c: int):
    """Planned extraction (the port of ``bucketed_extract_planned``,
    ``mh_spgemm_tpu/ops/bucketed.py:1845``): one ``pgather`` of the class
    slabs' column and value words (the values read in place) on every
    output chunk's schedule and one ``proute`` to output order, all
    chunks in one call each.  Returns (col, val), ``nnz_cap`` long, zero
    past ``nnz_c``."""
    m_e, nst_e, nch, CH = spec
    wblk, rowsel, lane, masks = ext_dev
    vals = _flat([s[1] for s in slabs])
    g = pn.pgather([_flat([s[0] for s in slabs])] + _words(vals), wblk,
                   rowsel, lane)
    r = pn.proute(g, masks, nst_e)[:, :, :CH].reshape(g.shape[0], -1)
    r = r[:, :nnz_cap]
    ok = torch.arange(nnz_cap, device=r.device) < nnz_c
    ccol = torch.where(ok, r[0], 0)
    cval = torch.where(ok, _from_words(list(r[1:]), vals.dtype),
                       torch.zeros((), dtype=vals.dtype, device=r.device))
    return ccol, cval


def extract_stream(slabs, ext: ExtractPlan) -> torch.Tensor:
    """The windowed extraction's planar source stream: [bias | column
    plane | value word planes], each plane ``ext.area_pad`` words, then
    the window slack; i32[rows, 128]."""
    cols = _flat([s[0].reshape(-1) for s in slabs])
    vals = _flat([s[1].reshape(-1) for s in slabs])
    area = cols.numel()
    words = vals.view(torch.int32).view(area, -1)
    if words.shape[1] != ext.nplanes - 1:
        raise ValueError(f"{ext.nplanes - 1} value words planned, "
                         f"{words.shape[1]} given")
    nrows = ((_FILL_BIAS_WORDS + ext.nplanes * ext.area_pad) // 128
             + ext.wrows + rf.PAD_ROWS)
    stream = torch.empty(nrows * 128, dtype=torch.int32, device=cols.device)
    base = _FILL_BIAS_WORDS
    stream[:base] = 0
    for p in range(ext.nplanes):
        lo = base + p * ext.area_pad
        stream[lo: lo + area] = cols if p == 0 else words[:, p - 1]
        stream[lo + area: lo + ext.area_pad] = 0
    stream[base + ext.nplanes * ext.area_pad:] = 0
    return stream.view(nrows, 128)


def _ext_dev(ext: ExtractPlan, device) -> tuple:
    if ext.dev is None or ext.device != device:
        ext.device = device
        ext.dev = (torch.as_tensor(ext.win_row).to(device),
                   torch.as_tensor(ext.runs).to(device))
    return ext.dev


def bucketed_extract_windowed(slabs, ext: ExtractPlan, *, nnz_cap: int,
                              nnz_c):
    """Windowed extraction (the port of ``bucketed_extract_mosaic``,
    ``mh_spgemm_tpu/ops/bucketed.py:2179``): each C row's packed slab
    span is copied into the CSR arrays by ``ragged_fill`` runs, one
    launch over all output chunks, one run per row and plane.  The value
    planes are the raw words of the value type, so the copy is exact (the
    JAX package's Dekker split and its overflow fallback have no cause
    here).  ``nnz_c`` (an int, or a device scalar such as ``cptr[m]``)
    bounds the valid outputs; returns (col, val), ``nnz_cap`` long."""
    dev = slabs[0][0].device
    win_row, runs = _ext_dev(ext, dev)
    stream = extract_stream(slabs, ext)
    cap_rows = ext.nplanes * ext.cap_slots // 128
    ws = rf.ragged_fill(win_row, runs, stream, out_rows=cap_rows,
                        nplanes=ext.nplanes,
                        src_stride_rows=ext.area_pad // 128,
                        dst_stride=ext.cap_slots)
    w = ws.view(ext.nchunks, -1)
    cap = ext.cap_slots
    ccol = w[:, :cap].reshape(-1)[:nnz_cap]
    if ext.nplanes == 3:            # the two raw words of each f64 value
        cval = torch.stack([w[:, cap: 2 * cap], w[:, 2 * cap: 3 * cap]],
                           dim=-1).view(-1)[: 2 * nnz_cap].view(
                               torch.float64)
    else:
        cval = w[:, cap: 2 * cap].reshape(-1)[:nnz_cap].view(torch.float32)
    if isinstance(nnz_c, int):
        ccol[nnz_c:] = 0
        cval[nnz_c:] = 0
        return ccol, cval
    good = torch.arange(nnz_cap, device=dev) < nnz_c
    return (torch.where(good, ccol, 0),
            torch.where(good, cval, torch.zeros((), dtype=cval.dtype,
                                                device=dev)))


def run_bucketed(plan: BucketPlan, a_val, b_col, b_val, pairs2d=None, *,
                 route: str):
    """Cold main stage: slabs plus their row counts.  Returns (crow,
    cptr, totals, slabs)."""
    upload_plan(plan, a_val.device)
    with span("main"):
        slabs = bucketed_main(plan, a_val, b_col, b_val, pairs2d,
                              route=route)
        crow, cptr, totals = bucketed_counts(plan, slabs)
    return crow, cptr, totals, slabs


def extract_warm(plan: BucketPlan, slabs):
    """Extraction of a warm plan (nnz(C) known on the host), in the JAX
    package's order of preference: the windowed copy when the plan has
    one, else the planned extraction when it has that, else the static
    gather.  Returns (ccol, cval)."""
    if plan.ext is not None:
        with span("extract.windowed"):
            return bucketed_extract_windowed(slabs, plan.ext,
                                             nnz_cap=plan.nnz_cap,
                                             nnz_c=plan.nnz_c)
    if plan.ext_pf is not None:
        with span("extract.planned"):
            return bucketed_extract_planned(
                slabs, planned_extract_dev(plan), plan.ext_pf_spec,
                nnz_cap=plan.nnz_cap, nnz_c=plan.nnz_c)
    with span("extract.static"):
        return bucketed_extract_static(slabs, static_dev(plan)[0],
                                       nnz_c=plan.nnz_c)


def planned_extract_dev(plan: BucketPlan) -> tuple:
    """The planned extraction's schedules (wblk, rowsel, lane, masks) on
    the plan's device, uploaded once."""
    if plan.ext_pf_dev is None:
        plan.ext_pf_dev = tuple(
            torch.as_tensor(plan.ext_pf[k]).to(plan.device)
            for k in ("wblk", "rowsel", "lane", "masks"))
    return plan.ext_pf_dev


def static_dev(plan: BucketPlan) -> tuple:
    """The host-evaluated extraction operands (src, cptr) on the plan's
    device, uploaded once."""
    if plan.ext_static_dev is None:
        plan.ext_static_dev = (
            torch.as_tensor(plan.ext_src_h).to(plan.device),
            torch.as_tensor(plan.cptr_h).to(plan.device))
    return plan.ext_static_dev


def run_bucketed_fused(plan: BucketPlan, a_val, b_col, b_val, pairs2d=None,
                       *, route: str):
    """Warm path (the plan knows nnz(C)): main stage then extraction,
    queued back to back with no host sync between them.  Returns (cptr,
    ccol, cval)."""
    assert plan.nnz_cap is not None, "fused path needs a warm plan"
    upload_plan(plan, a_val.device)
    slabs = bucketed_main(plan, a_val, b_col, b_val, pairs2d, route=route)
    ccol, cval = extract_warm(plan, slabs)
    return static_dev(plan)[1], ccol, cval


def finish_bucketed(plan: BucketPlan, main_out):
    """Extraction after a cold main stage.  The first run fetches the
    per-row counts (the one host sync), fixes the output capacity and
    evaluates the warm extraction operands, the windowed plan among
    them."""
    crow, cptr, _, slabs = main_out
    if plan.class_caps is None:
        warm_plan_from_crow(plan, crow[: plan.m].cpu().numpy())
    with span("extract.cold"):
        if plan.ext is not None:
            ccol, cval = bucketed_extract_windowed(
                slabs, plan.ext, nnz_cap=plan.nnz_cap,
                nnz_c=cptr[plan.m_cap])
        else:
            ccol, cval = bucketed_extract(slabs, plan.dev_slab_start, cptr,
                                          m=plan.m_cap,
                                          nnz_cap=plan.nnz_cap)
    return cptr, ccol, cval
