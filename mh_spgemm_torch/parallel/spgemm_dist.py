"""Distributed SpGEMM: row-partitioned C = A @ B over a mesh of shards —
the port of ``mh_spgemm_tpu/parallel/spgemm_dist.py`` (its bucketed
engine, and the flat ESC engine of ``engine="esc"``).

A and C are row-partitioned over the ``rows`` axis (work-balanced: equal
intermediate products per shard).  B is replicated, row-sharded and
gathered (``all_gather``), row-sharded with each shard fetching only the
B rows its A block references through one host-planned ``all_to_all``
(``ragged``, and ``ragged_overlap``, which splits each shard's rows into
local-only and halo rows), or block-partitioned over a rows x cols grid
(``grid2d``).  Each shard runs the bucketed engine (gather or fill
frontend, the ESC tail, the extraction) on its row block under class
plans that share one layout over the mesh (``plan_buckets_sharded``);
the host trims and concatenates the shards' capacity blocks.  Under
``engine="esc"`` A is split into equal row blocks, and each shard runs
the fused expand-sort-compress engine (``ops/numeric.esc_segments``) on
B replicated, gathered or ragged-fetched.

Execution is bulk-synchronous, what ``shard_map`` amounts to on a
virtual mesh: each stage runs shard by shard, and the collectives are the
barriers between stages.  In one process the collectives are torch
copies (``all_gather``, and ``all_to_all`` under ``comm_backend="xla"``,
the counterpart of XLA's collectives), or one launch of the
``halo_exchange`` kernel under ``comm_backend="pallas"``, which moves every
shard's blocks (``ops/remote_fetch.py``).  A mesh that spans processes
(``mesh.init_multihost``) runs each process's own shards and crosses
processes in ``parallel/comm.py`` (gloo on CPU shards, CUDA IPC on the
card); every process plans every shard and returns the whole C.  The card
computes in native f64, so values cross the exchange as their raw words
(the JAX package's Dekker split has no cause here).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SpGEMMConfig, check_supported, fill_mode
from ..csr import CSR
from ..errors import ShapeMismatchError, SpGEMMError, require
from ..ops import bucketed as bucketed_ops
from ..ops import numeric as numeric_ops
from ..ops import remote_fetch
from ..ops.shapes import quantize
from ..pipeline import _NP_DTYPES
from . import comm
from .mesh import COLS, ROWS, Mesh

# The overlap decision's constants, the JAX package's (TPU v5e and host
# CPU figures, not measured on the H100): ns per slot, ms of fixed cost
# per class, and the exchange's GB/s, on an accelerator mesh and on a
# CPU mesh.
_OVERLAP_SLOT_NS = {True: 5.0, False: 8.0}
_OVERLAP_CLASS_MS = {True: 0.3, False: 1.0}
_OVERLAP_GBS = {True: 45.0, False: 10.0}


@dataclasses.dataclass
class RowPartition:
    """Host-side padded row partition of a CSR matrix: shard d owns rows
    [bounds[d], bounds[d+1]) (default: equal-row split); arrays are
    padded to the max per-shard row/nnz counts so every shard sees one
    shape."""

    n_shards: int
    rows_per_shard: int        # row capacity R = max shard row count
    nnz_cap: int
    ptr: np.ndarray    # int32[D, R+1] local (0-based) row pointers
    col: np.ndarray    # int32[D, cap]
    val: np.ndarray    # float[D, cap]
    nnz: np.ndarray    # int32[D] true local nnz
    bounds: np.ndarray = None  # int64[D+1] owned global row ranges


def balance_bounds(A: CSR, B: CSR, n_shards: int) -> np.ndarray:
    """Work-balanced row bounds: split A's rows so every shard owns about
    equal intermediate products (sum of referenced B-row lengths), not
    equal rows, so the shards' shared class layout is not padded to one
    heavy shard's shapes.  Returns int64[D+1] with bounds[0] = 0,
    bounds[D] = M, monotone (empty shards where fewer than D heavy rows
    exist)."""
    blens = np.diff(B.ptr).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(blens[A.col])])
    p_cum = cs[A.ptr]                       # intprod prefix per row bound
    total = int(p_cum[-1])
    targets = (np.arange(1, n_shards, dtype=np.int64)
               * total) // n_shards
    inner = np.searchsorted(p_cum[1:-1], targets, side="left")
    bounds = np.concatenate([[0], inner, [A.M]]).astype(np.int64)
    return np.maximum.accumulate(bounds)


def partition_rows(A: CSR, n_shards: int, value_dtype=None,
                   bounds: Optional[np.ndarray] = None) -> RowPartition:
    """``bounds`` (int[D+1], default equal-row split): shard d owns rows
    [bounds[d], bounds[d+1]); every shard's arrays are padded to the max
    shard's row/nnz counts."""
    if bounds is None:
        R0 = -(-A.M // n_shards)
        # trailing shards own no rows when (D-1)*ceil(M/D) >= M
        bounds = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * R0,
                            A.M)
    R = max(1, int(np.max(np.diff(bounds))))
    caps = [int(A.ptr[bounds[d + 1]] - A.ptr[bounds[d]])
            for d in range(n_shards)]
    cap = max(1, max(caps))
    ptr = np.zeros((n_shards, R + 1), dtype=np.int32)
    col = np.zeros((n_shards, cap), dtype=np.int32)
    val = np.zeros((n_shards, cap), dtype=value_dtype or A.val.dtype)
    nnz = np.zeros((n_shards,), dtype=np.int32)
    for d in range(n_shards):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        if hi <= lo:
            continue                       # empty shard: all-zero block
        base = A.ptr[lo]
        local = A.ptr[lo:hi + 1] - base
        ptr[d, :hi - lo + 1] = local
        ptr[d, hi - lo + 1:] = local[-1]
        k = int(local[-1])
        col[d, :k] = A.col[base:base + k]
        val[d, :k] = A.val[base:base + k]
        nnz[d] = k
    return RowPartition(n_shards=n_shards, rows_per_shard=R, nnz_cap=cap,
                        ptr=ptr, col=col, val=val, nnz=nnz,
                        bounds=np.asarray(bounds, dtype=np.int64))


@dataclasses.dataclass
class RaggedFetchPlan:
    """Host-planned exchange: which B rows each shard sends where.  Shard
    d needs exactly the B rows its local A columns name, so the exchange
    is one ``all_to_all`` of host-planned blocks, its traffic the needed
    halo instead of all of B."""

    r_cap: int                 # max rows any (src, dst) pair exchanges
    v_cap: int                 # max nonzeros any (src, dst) pair exchanges
    n_cap: int                 # max distinct needed rows per shard
    send_src: np.ndarray       # int32[D, D, v_cap] idx into local b arrays
    recv_start: np.ndarray     # int32[D, n_cap] start in recv payload
    recv_len: np.ndarray       # int32[D, n_cap]
    a_col_remap: np.ndarray    # int32[D, a_cap] local A cols -> needed idx


def plan_ragged_fetch(A: CSR, B: CSR, apart: RowPartition,
                      bpart: RowPartition) -> RaggedFetchPlan:
    """The exchange plan; the payload address space of shard d is
    ``[its local B block (bcap words) | D blocks of v_cap words]``."""
    D = bpart.n_shards

    def b_owner(rows):
        """Owning B shard of each global row (bounds-aware)."""
        return np.searchsorted(bpart.bounds[1:], rows, side="right")

    needed = []            # per dst shard: sorted unique needed global rows
    for d in range(D):
        lo, hi = int(apart.bounds[d]), int(apart.bounds[d + 1])
        cols = A.col[A.ptr[lo]:A.ptr[hi]] if hi > lo else \
            np.zeros(0, np.int32)
        needed.append(np.unique(cols).astype(np.int64))
    blens = np.diff(B.ptr).astype(np.int64)

    # v_cap counts remote pairs only: a shard's own rows are read from its
    # local block, so the exchange carries just the halo
    r_cap = v_cap = n_cap = 1
    for d in range(D):
        n_cap = max(n_cap, needed[d].size)
        src = b_owner(needed[d])
        for s in range(D):
            if s == d:
                continue
            rows = needed[d][src == s]
            r_cap = max(r_cap, rows.size)
            v_cap = max(v_cap, int(blens[rows].sum()) if rows.size else 0)
    r_cap, v_cap, n_cap = quantize(r_cap), quantize(v_cap), quantize(n_cap)

    bcap = bpart.nnz_cap
    a_cap = apart.col.shape[1]
    send_src = np.zeros((D, D, v_cap), dtype=np.int32)
    recv_start = np.zeros((D, n_cap), dtype=np.int32)
    recv_len = np.zeros((D, n_cap), dtype=np.int32)
    a_col_remap = np.zeros((D, a_cap), dtype=np.int32)
    for d in range(D):
        nd = needed[d]
        src = b_owner(nd)
        for s in range(D):
            sel = np.flatnonzero(src == s)
            rows = nd[sel]
            if rows.size == 0:
                continue   # nothing owned by s is needed (or s is empty)
            lens = blens[rows]
            recv_len[d, sel] = lens.astype(np.int32)
            s_base = B.ptr[int(bpart.bounds[s])]
            if s == d:
                # local rows: direct offsets into the local padded block
                recv_start[d, sel] = (B.ptr[rows] - s_base).astype(
                    np.int32)
                continue
            offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
            local_start = (B.ptr[rows] - s_base).astype(np.int64)
            total = int(lens.sum())
            flat = np.repeat(local_start - offs, lens) + np.arange(
                total, dtype=np.int64)
            send_src[s, d, :total] = flat.astype(np.int32)
            recv_start[d, sel] = (bcap + src[sel] * v_cap + offs
                                  ).astype(np.int32)
        # remap local A cols to needed-row indices
        lo, hi = int(apart.bounds[d]), int(apart.bounds[d + 1])
        if hi > lo:
            k = int(A.ptr[hi] - A.ptr[lo])
            cols = A.col[A.ptr[lo]:A.ptr[lo] + k].astype(np.int64)
            a_col_remap[d, :k] = np.searchsorted(nd, cols).astype(np.int32)
    return RaggedFetchPlan(r_cap=r_cap, v_cap=v_cap, n_cap=n_cap,
                           send_src=send_src, recv_start=recv_start,
                           recv_len=recv_len, a_col_remap=a_col_remap)


def plan_col_blocks(B: CSR, dc: int):
    """Column-balanced partition of B into ``dc`` column blocks, each a
    column-sliced CSR with global column ids (so per-row output segments
    from increasing blocks concatenate into ascending CSR order).
    Returns (cbounds int64[dc+1], ptrs, cols, vals lists)."""
    counts = np.bincount(B.col, minlength=B.N).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    targets = (np.arange(1, dc, dtype=np.int64) * B.nnz) // dc
    inner = np.searchsorted(cum[1:-1], targets, side="left")
    cbounds = np.maximum.accumulate(
        np.concatenate([[0], inner, [B.N]]).astype(np.int64))
    blk = np.searchsorted(cbounds[1:], B.col, side="right")
    rows = np.repeat(np.arange(B.M, dtype=np.int64), np.diff(B.ptr))
    ptrs, colss, valss = [], [], []
    for c in range(dc):
        selm = blk == c
        cnt = np.bincount(rows[selm], minlength=B.M)
        ptrs.append(np.concatenate([[0], np.cumsum(cnt)])
                    .astype(np.int64))
        colss.append(B.col[selm].astype(np.int32))
        valss.append(B.val[selm])
    return cbounds, ptrs, colss, valss


# ---------------------------------------------------------------------------
# Per-shard lists
# ---------------------------------------------------------------------------

def _each(fn, *lists) -> list:
    """``fn`` over the shards of zipped per-shard lists; None where the
    first list has None (a shard another process owns)."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*lists)]


def _part(lists, k: int) -> list:
    """Part k of each shard's tuple (None stays None)."""
    return [None if x is None else x[k] for x in lists]


# ---------------------------------------------------------------------------
# The shard program
# ---------------------------------------------------------------------------

def _shard_bucketed_kernel(plan, a_val, b_col, b_val, pairs, *, m_cap: int,
                           nnz_cap: int, rows_local: int, route: str):
    """One shard's bucketed SpGEMM on its row block (the port of
    ``_shard_bucketed_kernel``, ``spgemm_dist.py:205``): the main stage
    over the plan's classes, then the extraction into ``nnz_cap``-long
    column and value blocks.  ``plan`` lives on the shard's device and
    addresses the layout of ``b_col`` / ``b_val`` (replicated CSR,
    gathered blocks or halo payload); ``pairs`` is the planar fill stream
    in the same address space.  Returns (crow [rows_local], ccol, cval,
    nnz) on the shard's device."""
    dev = a_val.device
    if not plan.classes:                     # no products anywhere
        return (torch.zeros(rows_local, dtype=torch.int32, device=dev),
                torch.zeros(nnz_cap, dtype=torch.int32, device=dev),
                torch.zeros(nnz_cap, dtype=a_val.dtype, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    slabs = bucketed_ops.bucketed_main(plan, a_val, b_col, b_val, pairs,
                                       route=route)
    crow, cptr, _ = bucketed_ops.bucketed_counts(plan, slabs)
    ccol, cval = bucketed_ops.bucketed_extract(
        slabs, plan.dev_slab_start, cptr, m=m_cap, nnz_cap=nnz_cap)
    return crow[:rows_local], ccol, cval, cptr[m_cap]


def _collect(outs, mesh: Mesh):
    """The shards' outputs on the host: crow int32[D, R], and each shard's
    columns and values trimmed to its nnz.  Each process fetches its own
    shards' pieces; across processes they are gathered over gloo (the
    JAX package's ``process_allgather``), so every process holds all."""
    local = {}
    for d, o in enumerate(outs):
        if o is not None:
            n = int(o[3])
            local[d] = (o[0].cpu().numpy(), o[1][:n].cpu().numpy(),
                        o[2][:n].cpu().numpy())
    every = comm.gather_local(mesh, local)
    D = len(outs)
    return (np.stack([every[d][0] for d in range(D)]),
            [every[d][1] for d in range(D)], [every[d][2] for d in range(D)])


def _assemble(A: CSR, B: CSR, outs, bounds: np.ndarray, mesh: Mesh) -> CSR:
    """Host assembly: each shard's rows (its crow block is padded to R
    rows; ``bounds`` are the owned row ranges) and its trimmed columns
    and values, concatenated."""
    crow, cols, vals = _collect(outs, mesh)
    crow_nnz = np.concatenate(
        [crow[d, :int(bounds[d + 1] - bounds[d])]
         for d in range(len(outs))]).astype(np.int64)
    cptr = np.zeros(A.M + 1, dtype=np.int64)
    np.cumsum(crow_nnz, out=cptr[1:])
    require(cptr[-1] < 2**31, SpGEMMError, "nnz(C) exceeds int32")
    return CSR(M=A.M, N=B.N, ptr=cptr.astype(np.int32),
               col=np.concatenate(cols).astype(np.int32),
               val=np.concatenate(vals))


def _assemble2d(A: CSR, B: CSR, Dr: int, Dc: int, outs, bounds,
                mesh: Mesh) -> CSR:
    """Host assembly for the 2-D grid: row r's CSR entries are the
    concatenation over c of shard (r, c)'s packed segment for that row
    (blocks carry global column ids, so the order is ascending)."""
    crow_all, cols_all, vals_all = _collect(outs, mesh)
    R = crow_all.shape[1]
    crow = crow_all.reshape(Dr, Dc, R)
    seg = np.zeros((A.M, Dc), np.int64)
    for r in range(Dr):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        if hi > lo:
            seg[lo:hi] = crow[r, :, : hi - lo].T
    crow_total = seg.sum(axis=1)
    total_nnz = int(crow_total.sum())
    require(total_nnz < 2**31, SpGEMMError, "nnz(C) exceeds int32")
    cptr = np.zeros(A.M + 1, dtype=np.int64)
    np.cumsum(crow_total, out=cptr[1:])
    seg_dst = cptr[:-1, None] + np.concatenate(
        [np.zeros((A.M, 1), np.int64), np.cumsum(seg, axis=1)[:, :-1]],
        axis=1)
    cols = np.zeros(total_nnz, np.int32)
    vals = np.zeros(total_nnz, vals_all[0].dtype)
    for r in range(Dr):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        if hi <= lo:
            continue
        for c in range(Dc):
            lens = crow[r, c, : hi - lo].astype(np.int64)
            n = int(lens.sum())
            if n == 0:
                continue
            dst0 = np.repeat(seg_dst[lo:hi, c], lens)
            within = (np.arange(n, dtype=np.int64)
                      - np.repeat(np.cumsum(lens) - lens, lens))
            cols[dst0 + within] = cols_all[r * Dc + c][:n]
            vals[dst0 + within] = vals_all[r * Dc + c][:n]
    return CSR(M=A.M, N=B.N, ptr=cptr.astype(np.int32), col=cols,
               val=vals)


def _rows_in(plan) -> np.ndarray:
    """Bool[m_cap]: rows that appear in any class of the plan."""
    out = np.zeros(plan.m_cap, bool)
    for c in plan.classes:
        rows = c.rows_g.reshape(-1)
        out[rows[rows >= 0]] = True
    return out


def _product_cap(A: CSR, blens: np.ndarray, bounds) -> int:
    """Quantized largest shard product count (an nnz(C_shard) bound)."""
    per_nnz = blens[A.col]
    caps = [int(per_nnz[A.ptr[int(lo)]:A.ptr[int(hi)]].sum()) if hi > lo
            else 0 for lo, hi in zip(bounds[:-1], bounds[1:])]
    total = quantize(max(1, max(caps)))
    require(total < 2**31, SpGEMMError,
            "per-shard product stream exceeds int32")
    return total


def _upload(plans, mesh: Mesh) -> None:
    """Each local shard's plan to its device."""
    for d, (p, dev) in enumerate(zip(plans, mesh.devices)):
        if mesh.is_local(d):
            bucketed_ops.upload_plan(p, dev)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def spgemm_dist(A: CSR, B: Optional[CSR], mesh: Mesh,
                config: SpGEMMConfig = DEFAULT_CONFIG,
                b_strategy: str = "allgather",
                state: Optional[dict] = None,
                engine: str = "bucketed") -> CSR:
    """Distributed C = A @ B (B=None -> B=A, or A^T under config.aat) on
    ``mesh`` (``parallel.mesh``), the bucketed engine on every shard.

    ``b_strategy``:
      * ``"replicate"`` — B on every shard (no collectives).
      * ``"allgather"`` — B row-sharded; each shard gathers every block.
      * ``"ragged"`` — B row-sharded; each shard fetches only the rows
        its A block references through one host-planned exchange:
        ``all_to_all`` under ``config.comm_backend="xla"``, the
        ``halo_exchange`` kernel under ``"pallas"`` (column and value
        words packed into one exchange).
      * ``"ragged_overlap"`` — ragged with each shard's local-only rows
        as a stage of their own (the exchange could overlap it); a
        plan-time model falls back to ``"ragged"`` where the split does
        not pay, unless ``MHSPGEMM_FORCE_OVERLAP=1``.
      * ``"grid2d"`` — B block-partitioned over a rows x cols mesh
        (:func:`..parallel.mesh.make_grid_mesh`); each shard gathers its
        column block over ``rows``.

    A given ``state`` dict keeps the program and its operands on the
    shards' devices after the first call (and a multi-process mesh's
    exchange buffers and IPC views); later calls with it skip planning
    and upload.  The state also records ``plan_s`` (host
    planning seconds), ``exchanged_words`` (words the shards receive in
    one call's collectives, a shard's own block included) and ``plans``.
    A shard plan past int32 indexing (a ``ValueError``) falls back to
    row-chunked execution.

    ``engine="esc"`` runs the flat expand-sort-compress engine on every
    shard instead (:func:`_spgemm_dist_esc`; ``replicate``,
    ``allgather`` and ``ragged``), the robust fallback and differential
    check of the bucketed path.

    Across processes (after ``parallel.mesh.init_multihost``, on a mesh
    from ``make_row_mesh`` / ``make_grid_mesh``): every process calls
    with the full host A (and B), the same config and the same
    environment (``MHSPGEMM_FORCE_OVERLAP`` included), as in the JAX
    package.  Each plans every shard, checks at the cold call that all
    planned the same (``SpGEMMError`` otherwise), runs only its own
    shards, and returns the whole C; the collectives cross processes
    (``parallel/comm.py``).  Every engine, strategy and backend,
    ``dma_fill``, the warm state and the overflow fallback work there as
    in one process."""
    route = check_supported(config)
    if B is None:
        B = A.transpose() if (config.aat and not A.is_symmetric) else A
    require(A.N == B.M, ShapeMismatchError, "A.N must equal B.M")
    require(engine in ("bucketed", "esc"), SpGEMMError,
            f"unknown engine {engine!r}")

    if state is not None and state.get("fn") is not None:
        # warm state: skip planning and upload, rerun the shard program
        outs = state["fn"](*state["args"])
        if state.get("grid"):
            Dr, Dc = state["grid"]
            return _assemble2d(A, B, Dr, Dc, outs, state["bounds"], mesh)
        return _assemble(A, B, outs, state["bounds"], mesh)

    if engine == "esc":
        return _spgemm_dist_esc(A, B, mesh, config, b_strategy, state)
    try:
        if b_strategy == "grid2d":
            return _spgemm_dist_grid2d(A, B, mesh, config, route, state)
        if b_strategy == "ragged_overlap":
            return _spgemm_dist_ragged_overlap(A, B, mesh, config, route,
                                               state)
        return _spgemm_dist_bucketed(A, B, mesh, config, b_strategy, state)
    except ValueError:
        # a shard's padded slab overflowed int32: split into row chunks,
        # each chunk re-partitioned over the whole mesh
        return _dist_chunked(A, B, mesh, config, b_strategy)


def _shard_esc_kernel(a_ptr, a_col, a_val, a_nnz, b_lens_g, b_starts_g,
                      b_col, b_val, *, total: int, max_group: int):
    """One shard's fused ESC SpGEMM on its row block (the port of
    ``_shard_esc_kernel``, ``spgemm_dist.py:133``).  ``b_lens_g`` /
    ``b_starts_g`` describe every B row that ``a_col`` names as a segment
    of ``b_col`` / ``b_val`` (replicated CSR, gathered blocks or halo
    payload).  Returns (crow [R], col [total], val [total], nnz) on the
    shard's device."""
    ac = a_col.long()
    res = numeric_ops.esc_segments(a_ptr, a_val, b_starts_g[ac],
                                   b_lens_g[ac], a_nnz, b_col, b_val,
                                   total, total, max_group)
    return res.crow_nnz, res.col_cap, res.val_cap, res.nnz_total


def _spgemm_dist_esc(A: CSR, B: CSR, mesh: Mesh, config: SpGEMMConfig,
                     b_strategy: str, state: Optional[dict]) -> CSR:
    """The flat ESC engine over the mesh (``spgemm_dist.py:384-513``): an
    equal-row partition of A, B replicated, gathered or ragged-fetched,
    and every shard's ESC at the largest shard's product count.  The
    ragged exchange is the torch-copy ``all_to_all`` whatever
    ``comm_backend`` says, as the JAX package's ESC branch always uses
    ``lax.all_to_all``."""
    t0 = time.perf_counter()
    D = mesh.size
    np_dt = _NP_DTYPES[config.vdtype]
    vwords = 2 if np_dt == np.float64 else 1
    part = partition_rows(A, D, value_dtype=np_dt)
    R = part.rows_per_shard
    blens = np.diff(B.ptr).astype(np.int64)
    per_nnz = blens[A.col]
    caps = []
    for d in range(D):
        lo, hi = min(d * R, A.M), min((d + 1) * R, A.M)
        caps.append(int(per_nnz[A.ptr[lo]:A.ptr[hi]].sum())
                    if hi > lo else 0)
    total = max(1, max(caps))
    require(total < 2**31, SpGEMMError,
            "per-shard product stream exceeds int32")
    a_row_nnz = np.diff(A.ptr)
    max_group = max(1, int(a_row_nnz.max()) if a_row_nnz.size else 1)
    kern = functools.partial(_shard_esc_kernel, total=total,
                             max_group=max_group)
    a_col = part.col

    if b_strategy == "replicate":
        comm.check_same(mesh, "ESC shards", A, B, part)
        b_ptr = comm.replicate(B.ptr.astype(np.int32), mesh)
        b_col = comm.replicate(B.col.astype(np.int32), mesh)
        b_val = comm.replicate(B.val.astype(np_dt), mesh)

        def payload(b_ptr, b_col, b_val):
            return (_each(lambda p: p[1:] - p[:-1], b_ptr),
                    _each(lambda p: p[:-1], b_ptr), b_col, b_val)

        b_args = (b_ptr, b_col, b_val)
        words = 0
    elif b_strategy == "allgather":
        bpart = partition_rows(B, D, value_dtype=np_dt)
        comm.check_same(mesh, "ESC shards", A, B, part, bpart)
        RB, bcap = bpart.rows_per_shard, bpart.nnz_cap
        gather = comm.Gather(mesh, _each(
            lambda *x: x, comm.put(bpart.ptr, mesh),
            comm.put(bpart.col, mesh), comm.put(bpart.val, mesh)))

        def starts_lens(p):
            # every shard reassembles B from the blocks
            p = p.reshape(D, RB + 1)
            lens = (p[:, 1:] - p[:, :-1]).reshape(-1)[:B.M]
            starts = (p[:, :-1] + (torch.arange(
                D, dtype=torch.int32, device=p.device) * bcap)[:, None]
            ).reshape(-1)[:B.M]
            return lens, starts

        def payload():
            g = gather()
            sl = _each(starts_lens, _part(g, 0))
            return _part(sl, 0), _part(sl, 1), _part(g, 1), _part(g, 2)

        b_args = ()
        words = D * D * (RB + 1 + bcap * (1 + vwords))
    elif b_strategy == "ragged":
        bpart = partition_rows(B, D, value_dtype=np_dt)
        fp = plan_ragged_fetch(A, B, part, bpart)
        comm.check_same(mesh, "ESC shards", A, B, part, bpart, fp)
        a_col = fp.a_col_remap
        exchange = comm.Exchange(mesh)

        def payload(b_col_l, b_val_l, send_src, recv_start, recv_len):
            # per-destination blocks (host-planned indices), one exchange
            got = exchange(_each(lambda c, v, s: (c[s], v[s]), b_col_l,
                                 b_val_l, send_src))
            # payload address space: [local block | halo from each shard]
            return (recv_len, recv_start,
                    _each(lambda c, r: torch.cat([c, r[0].reshape(-1)]),
                          b_col_l, got),
                    _each(lambda v, r: torch.cat([v, r[1].reshape(-1)]),
                          b_val_l, got))

        b_args = (comm.put(bpart.col, mesh), comm.put(bpart.val, mesh),
                  comm.put(fp.send_src.astype(np.int64), mesh),
                  comm.put(fp.recv_start, mesh),
                  comm.put(fp.recv_len, mesh))
        words = D * D * (1 + vwords) * fp.v_cap
    else:
        raise SpGEMMError(f"unknown b_strategy {b_strategy!r}")
    a_args = (comm.put(part.ptr, mesh), comm.put(a_col, mesh),
              comm.put(part.val, mesh), comm.put(part.nnz, mesh))
    plan_s = time.perf_counter() - t0

    def program(a_ptr, a_col, a_val, a_nnz, *b_args):
        lens, starts, bc, bv = payload(*b_args)
        return _each(kern, a_ptr, a_col, a_val, a_nnz, lens, starts, bc, bv)

    args = a_args + b_args
    outs = program(*args)
    if state is not None:
        state.update(fn=program, args=args, R=R, total=total,
                     bounds=part.bounds, plans=None, plan_s=plan_s,
                     exchanged_words=words)
    return _assemble(A, B, outs, part.bounds, mesh)


def _dist_setup(A: CSR, B: CSR, D: int, config: SpGEMMConfig):
    """What every 1-D strategy plans first: the work-balanced partition,
    the product capacity and the planner's keywords."""
    np_dt = _NP_DTYPES[config.vdtype]
    bounds = balance_bounds(A, B, D)
    part = partition_rows(A, D, value_dtype=np_dt, bounds=bounds)
    blens = np.diff(B.ptr).astype(np.int64)
    total = _product_cap(A, blens, bounds)
    vwords = 2 if np_dt == np.float64 else 1
    return np_dt, bounds, part, blens, total, vwords


def _spgemm_dist_bucketed(A: CSR, B: CSR, mesh: Mesh,
                          config: SpGEMMConfig, b_strategy: str,
                          state: Optional[dict]) -> CSR:
    """Bucketed engine over the mesh (``spgemm_dist.py:516``): per-shard
    class plans of one layout, B replicated, gathered or ragged-fetched,
    per-shard main stage and extraction."""
    t0 = time.perf_counter()
    route = check_supported(config)
    D = mesh.size
    devs = list(mesh.devices)
    np_dt, bounds, part, blens, total, vwords = _dist_setup(A, B, D, config)
    R = part.rows_per_shard
    plan_kw = dict(min_width=config.min_bucket_width,
                   area_cap=config.bucket_area_cap,
                   dma_fill=fill_mode(config, devs[0]), vwords=vwords,
                   bounds=bounds)
    pallas = config.comm_backend == "pallas"

    if b_strategy == "replicate":
        plans = bucketed_ops.plan_buckets_sharded(
            A.ptr, A.col, D, R, b_ptr=B.ptr, **plan_kw)
        words = 0
        fetch = None
    elif b_strategy == "allgather":
        bpart = partition_rows(B, D, value_dtype=np_dt)
        RB, bcap = bpart.rows_per_shard, bpart.nnz_cap
        own = np.arange(B.M) // RB
        starts_g = (own * bcap + (B.ptr[:-1] - B.ptr[own * RB])
                    ).astype(np.int64)
        plans = bucketed_ops.plan_buckets_sharded(
            A.ptr, A.col, D, R, b_starts=starts_g, b_lens=blens, **plan_kw)
        words = D * D * bcap * (1 + vwords)
        fetch = bpart
    elif b_strategy == "ragged":
        bpart = partition_rows(B, D, value_dtype=np_dt)
        fp = plan_ragged_fetch(A, B, part, bpart)
        a_cols = [fp.a_col_remap[d][: int(part.nnz[d])] for d in range(D)]
        plans = bucketed_ops.plan_buckets_sharded(
            A.ptr, A.col, D, R,
            b_starts=[fp.recv_start[d].astype(np.int64) for d in range(D)],
            b_lens=[fp.recv_len[d].astype(np.int64) for d in range(D)],
            a_col_shards=a_cols, **plan_kw)
        words = D * D * (1 + vwords) * (
            -(-fp.v_cap // 128) * 128 if pallas else fp.v_cap)
        fetch = (bpart, fp)
    else:
        raise SpGEMMError(f"unknown b_strategy {b_strategy!r}")
    comm.check_same(mesh, "shard plans", A, B, part, plans, fetch)
    plan_s = time.perf_counter() - t0

    use_fill = bucketed_ops.needs_pairs(plans[0])
    wrows_max = bucketed_ops.pairs_wrows_max(plans[0])
    _upload(plans, mesh)
    a_val = comm.put(part.val, mesh)
    kern = functools.partial(_shard_bucketed_kernel, m_cap=plans[0].m_cap,
                             nnz_cap=total, rows_local=R, route=route)

    def fill_streams(bc, bv):
        return (_each(lambda c, v: bucketed_ops.pairs_planar_device(
            c, v, vwords, wrows_max), bc, bv) if use_fill else [None] * D)

    if b_strategy == "replicate":
        b_col = comm.replicate(B.col.astype(np.int32), mesh)
        b_val = comm.replicate(B.val.astype(np_dt), mesh)
        # replicated B: the fill stream is shard-independent, built once
        # on the host
        pairs = (comm.replicate(bucketed_ops.build_pairs_planar(
            B.col, B.val.astype(np_dt), vwords, wrows_max), mesh)
            if use_fill else [None] * D)

        def payload(b_col, b_val, pairs):
            return b_col, b_val, pairs

        args = (b_col, b_val, pairs)
    elif b_strategy == "allgather":
        gather = comm.Gather(mesh, _each(lambda c, v: (c, v),
                                         comm.put(bpart.col, mesh),
                                         comm.put(bpart.val, mesh)))

        def payload():
            g = gather()
            bc, bv = _part(g, 0), _part(g, 1)
            return bc, bv, fill_streams(bc, bv)

        args = ()
    else:                                       # ragged
        vdtype = config.vdtype
        exchange = comm.Exchange(mesh, kernel=pallas)

        def payload(b_col_l, b_val_l, send_src):
            pc = _each(lambda c, s: c[s], b_col_l, send_src)   # [D, v_cap]
            pv = _each(lambda v, s: v[s], b_val_l, send_src)
            if pallas:
                # one halo_exchange launch: columns and the values' raw
                # words packed side by side
                recv = remote_fetch.exchange_planes(
                    _each(lambda c, v: [c] + [
                        w.reshape(c.shape) for w in
                        bucketed_ops._words(v.reshape(-1))], pc, pv),
                    n_devices=D, exchange=exchange.planes)
                rc = _part(recv, 0)
                rv = _each(lambda r: bucketed_ops._from_words(r[1:], vdtype),
                           recv)
            else:
                got = exchange(_each(lambda c, v: (c, v), pc, pv))
                rc, rv = _part(got, 0), _part(got, 1)
            # payload address space: [local block | halo from each shard]
            bc = _each(lambda c, r: torch.cat([c, r.reshape(-1)]),
                       b_col_l, rc)
            bv = _each(lambda v, r: torch.cat([v, r.reshape(-1)]),
                       b_val_l, rv)
            return bc, bv, fill_streams(bc, bv)

        args = (comm.put(bpart.col, mesh), comm.put(bpart.val, mesh),
                comm.put(fp.send_src.astype(np.int64), mesh))

    def program(a_val, *payload_args):
        bc, bv, pairs = payload(*payload_args)
        return [None if a is None else kern(p, a, c, v, q)
                for p, a, c, v, q in zip(plans, a_val, bc, bv, pairs)]

    args = (a_val,) + args
    outs = program(*args)
    if state is not None:
        state.update(fn=program, args=args, R=R, total=total,
                     bounds=bounds, plans=plans, plan_s=plan_s,
                     exchanged_words=words)
    return _assemble(A, B, outs, bounds, mesh)


def _spgemm_dist_ragged_overlap(A: CSR, B: CSR, mesh: Mesh,
                                config: SpGEMMConfig, route: str,
                                state: Optional[dict]) -> CSR:
    """Plan and run the overlapped ragged path (``spgemm_dist.py:792``):
    per shard, the rows whose every reference is local run as stage 1
    against the shard's own B block, the halo rows as stage 2 against the
    ``[local | halo]`` payload after the exchange; one merged extraction.
    The stages run in order (a second stream for stage 1 beside the
    exchange is ROADMAP Queue 2b work)."""
    t0 = time.perf_counter()
    D = mesh.size
    devs = list(mesh.devices)
    np_dt, bounds, part, blens, total, vwords = _dist_setup(A, B, D, config)
    R = part.rows_per_shard
    bpart = partition_rows(B, D, value_dtype=np_dt)
    fp = plan_ragged_fetch(A, B, part, bpart)
    n_cap = fp.recv_len.shape[1]

    # per shard: split rows into local-only and halo rows; each stage's
    # column arrays send the other stage's entries to a zero-length
    # sentinel row (so they fall out of that stage's classes)
    loc_cols, halo_cols = [], []
    loc_starts, loc_lens, halo_starts, halo_lens = [], [], [], []
    for d in range(D):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        k = int(A.ptr[hi] - A.ptr[lo]) if hi > lo else 0
        cols = A.col[A.ptr[lo]:A.ptr[lo] + k].astype(np.int64)
        is_remote = np.searchsorted(bpart.bounds[1:], cols,
                                    side="right") != d
        row_of = np.repeat(np.arange(max(hi - lo, 0)),
                           np.diff(A.ptr[lo:hi + 1])) if hi > lo else \
            np.zeros(0, np.int64)
        halo_row = np.zeros(max(hi - lo, 1), bool)
        if k:
            np.maximum.at(halo_row, row_of, is_remote)
        ent_is_halo = halo_row[row_of] if k else np.zeros(0, bool)
        base = B.ptr[int(bpart.bounds[d])]
        loc_cols.append(np.where(ent_is_halo, B.M, cols).astype(np.int32))
        loc_starts.append(np.concatenate([B.ptr[:-1] - base, [0]]))
        loc_lens.append(np.concatenate([blens, [0]]))
        halo_starts.append(np.concatenate(
            [fp.recv_start[d].astype(np.int64), [0]]))
        halo_lens.append(np.concatenate(
            [fp.recv_len[d].astype(np.int64), [0]]))
        hc = np.where(ent_is_halo, fp.a_col_remap[d][:k], n_cap)
        halo_cols.append(hc.astype(np.int32))
    plan_kw = dict(min_width=config.min_bucket_width,
                   area_cap=config.bucket_area_cap,
                   dma_fill=fill_mode(config, devs[0]), vwords=vwords,
                   bounds=bounds)
    plans_l = bucketed_ops.plan_buckets_sharded(
        A.ptr, A.col, D, R, b_starts=loc_starts, b_lens=loc_lens,
        a_col_shards=loc_cols, **plan_kw)
    plans_h = bucketed_ops.plan_buckets_sharded(
        A.ptr, A.col, D, R, b_starts=halo_starts, b_lens=halo_lens,
        a_col_shards=halo_cols, **plan_kw)

    # Plan-time overlap-vs-ragged decision, the JAX package's timeline
    # model:  overlap ~ max(comm, stage1) + stage2 + (ncl + nch) * F,
    # ragged ~ comm + single_stage + ncr * F; overlap only where it wins.
    # "Accelerator" is a CUDA mesh here (the TPU there); the constants
    # are the JAX package's, not measured on the H100.
    def _area(plans):
        return sum(c.W * c.rb * c.nchunks for c in plans[0].classes)

    rag_cols = [fp.a_col_remap[d][: len(loc_cols[d])].astype(np.int32)
                for d in range(D)]
    plans_r = bucketed_ops.plan_buckets_sharded(
        A.ptr, A.col, D, R, b_starts=halo_starts, b_lens=halo_lens,
        a_col_shards=rag_cols, **plan_kw)
    accel = devs[0].type == "cuda"
    slot_ns = _OVERLAP_SLOT_NS[accel]
    fixed_ms = _OVERLAP_CLASS_MS[accel]
    comm_ms = (float(fp.recv_len.sum(axis=1).max(initial=0))
               * (1 + vwords) * 4 / (_OVERLAP_GBS[accel] * 1e6)
               if D > 1 else 0.0)
    s1, s2, sr = (_area(p) * slot_ns * 1e-6
                  for p in (plans_l, plans_h, plans_r))
    est_overlap = max(comm_ms, s1) + s2 + (
        len(plans_l[0].classes) + len(plans_h[0].classes)) * fixed_ms
    est_ragged = comm_ms + sr + len(plans_r[0].classes) * fixed_ms
    # MHSPGEMM_FORCE_OVERLAP=1 pins the overlap path (tests; A/B runs)
    if (est_overlap >= est_ragged
            and os.environ.get("MHSPGEMM_FORCE_OVERLAP") != "1"):
        return _spgemm_dist_bucketed(A, B, mesh, config, "ragged", state)

    comm.check_same(mesh, "overlap shard plans", A, B, part, bpart, fp,
                    plans_l, plans_h)
    plan_s = time.perf_counter() - t0
    m_cap = plans_l[0].m_cap
    area1 = _area(plans_l)
    # merged slab offsets: halo-stage slabs follow the local stage's in
    # the extraction's concatenated view; a row belongs to one stage
    slab_start = np.stack([
        plans_l[d].slab_row_start
        + np.where(_rows_in(plans_h[d]),
                   plans_h[d].slab_row_start + area1, 0)
        for d in range(D)]).astype(np.int32)
    use_fill_l = bucketed_ops.needs_pairs(plans_l[0])
    use_fill_h = bucketed_ops.needs_pairs(plans_h[0])
    wrows_l = bucketed_ops.pairs_wrows_max(plans_l[0])
    wrows_h = bucketed_ops.pairs_wrows_max(plans_h[0])
    _upload(plans_l, mesh)
    _upload(plans_h, mesh)
    local = comm.local_shards(mesh)
    # stage 1's fill streams: each shard's local block, built on the host
    # and on the device before the exchange
    pairs_l = ([torch.from_numpy(bucketed_ops.build_pairs_planar(
        bpart.col[d], bpart.val[d], vwords, wrows_l)).to(devs[d])
        if d in local else None for d in range(D)] if use_fill_l
        else [None] * D)
    args = (comm.put(part.val, mesh), comm.put(slab_start, mesh),
            comm.put(bpart.col, mesh), comm.put(bpart.val, mesh),
            comm.put(fp.send_src.astype(np.int64), mesh), pairs_l)
    exchange = comm.Exchange(mesh)

    def program(a_val, slab_start, b_col_l, b_val_l, send_src, pairs_l):
        got = exchange(_each(lambda c, v, s: (c[s], v[s]), b_col_l,
                             b_val_l, send_src))
        outs = [None] * D
        for d in local:
            dev = devs[d]
            slabs1 = bucketed_ops.bucketed_main(
                plans_l[d], a_val[d], b_col_l[d], b_val_l[d], pairs_l[d],
                route=route)
            bc = torch.cat([b_col_l[d], got[d][0].reshape(-1)])
            bv = torch.cat([b_val_l[d], got[d][1].reshape(-1)])
            pairs_h = (bucketed_ops.pairs_planar_device(bc, bv, vwords,
                                                        wrows_h)
                       if use_fill_h else None)
            slabs2 = bucketed_ops.bucketed_main(
                plans_h[d], a_val[d], bc, bv, pairs_h, route=route)
            crow = (bucketed_ops.bucketed_counts(plans_l[d], slabs1)[0]
                    + bucketed_ops.bucketed_counts(plans_h[d], slabs2)[0])
            cptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                              torch.cumsum(crow, 0, dtype=torch.int32)])
            ccol, cval = bucketed_ops.bucketed_extract(
                slabs1 + slabs2, slab_start[d], cptr, m=m_cap,
                nnz_cap=total)
            outs[d] = (crow[:R], ccol, cval, cptr[m_cap])
        return outs

    outs = program(*args)
    if state is not None:
        state.update(fn=program, args=args, R=R, total=total,
                     bounds=bounds, plans=(plans_l, plans_h), plan_s=plan_s,
                     exchanged_words=D * D * fp.v_cap * (1 + vwords))
    return _assemble(A, B, outs, bounds, mesh)


def _spgemm_dist_grid2d(A: CSR, B: CSR, mesh: Mesh, config: SpGEMMConfig,
                        route: str, state: Optional[dict]) -> CSR:
    """2-D block-partitioned SpGEMM over a (rows x cols) mesh
    (``spgemm_dist.py:1009``): shard (r, c) computes C[rows_r,
    colrange_c] from A's row block r and B's column block c.  B starts
    block-partitioned (column-sliced over ``cols``, row-sharded over
    ``rows``) and each shard gathers its column block over ``rows``
    inside its cols group."""
    t0 = time.perf_counter()
    require(COLS in mesh.shape, SpGEMMError,
            "b_strategy='grid2d' needs a mesh from make_grid_mesh")
    Dr, Dc = mesh.shape[ROWS], mesh.shape[COLS]
    devs = list(mesh.devices)
    np_dt = _NP_DTYPES[config.vdtype]
    bounds = balance_bounds(A, B, Dr)
    part = partition_rows(A, Dr, value_dtype=np_dt, bounds=bounds)
    R = part.rows_per_shard
    cbounds, bptrs, bcols, bvals = plan_col_blocks(B, Dc)
    vwords = 2 if np_dt == np.float64 else 1

    # B transport blocks: column block c row-sharded over the rows shards
    RB = -(-B.M // Dr)
    bcap2 = 1
    for c in range(Dc):
        for r in range(Dr):
            lo, hi = min(r * RB, B.M), min((r + 1) * RB, B.M)
            bcap2 = max(bcap2, int(bptrs[c][hi] - bptrs[c][lo]))
    bcap2 = quantize(bcap2)
    tb_col = np.zeros((Dr * Dc, bcap2), np.int32)
    tb_val = np.zeros((Dr * Dc, bcap2), np_dt)
    b_starts_c, b_lens_c = [], []
    own = np.minimum(np.arange(B.M, dtype=np.int64) // RB, Dr - 1)
    for c in range(Dc):
        for r in range(Dr):
            lo, hi = min(r * RB, B.M), min((r + 1) * RB, B.M)
            s, e = int(bptrs[c][lo]), int(bptrs[c][hi])
            tb_col[r * Dc + c, : e - s] = bcols[c][s:e]
            tb_val[r * Dc + c, : e - s] = bvals[c][s:e].astype(np_dt)
        # the address space every shard of cols group c sees after the
        # gather over rows: block r at offset r * bcap2
        starts = (own * bcap2
                  + (bptrs[c][:-1] - bptrs[c][np.minimum(own * RB, B.M)]))
        b_starts_c.append(starts.astype(np.int64))
        b_lens_c.append(np.diff(bptrs[c]).astype(np.int64))

    # shard d = r * Dc + c: A row range r, B column block c
    vbounds = np.array([[int(bounds[r]), int(bounds[r + 1])]
                        for r in range(Dr) for c in range(Dc)],
                       dtype=np.int64)
    plans = bucketed_ops.plan_buckets_sharded(
        A.ptr, A.col, Dr * Dc, R,
        b_starts=[b_starts_c[d % Dc] for d in range(Dr * Dc)],
        b_lens=[b_lens_c[d % Dc] for d in range(Dr * Dc)],
        min_width=config.min_bucket_width,
        area_cap=config.bucket_area_cap,
        dma_fill=fill_mode(config, devs[0]), vwords=vwords, bounds=vbounds)
    use_fill = bucketed_ops.needs_pairs(plans[0])
    wrows_max = bucketed_ops.pairs_wrows_max(plans[0])

    caps = []
    for r in range(Dr):
        lo, hi = int(bounds[r]), int(bounds[r + 1])
        acols = A.col[A.ptr[lo]:A.ptr[hi]]
        for c in range(Dc):
            caps.append(int(b_lens_c[c][acols].sum()) if hi > lo else 0)
    total2 = quantize(max(1, max(caps)))
    require(total2 < 2**31, SpGEMMError,
            "per-shard product stream exceeds int32")
    comm.check_same(mesh, "grid shard plans", A, B, part, plans, tb_col,
                    tb_val)
    plan_s = time.perf_counter() - t0

    _upload(plans, mesh)
    kern = functools.partial(_shard_bucketed_kernel, m_cap=plans[0].m_cap,
                             nnz_cap=total2, rows_local=R, route=route)
    # each shard gathers its cols group's column block over the rows axis
    gather = comm.Gather(
        mesh, _each(lambda c, v: (c, v), comm.put(tb_col, mesh),
                    comm.put(tb_val, mesh)),
        groups=[[r * Dc + d % Dc for r in range(Dr)]
                for d in range(Dr * Dc)])

    def shard(plan, a_val, g):
        bc, bv = g
        pairs = (bucketed_ops.pairs_planar_device(bc, bv, vwords, wrows_max)
                 if use_fill else None)
        return kern(plan, a_val, bc, bv, pairs)

    def program(a_val):
        return [None if a is None else shard(p, a, g)
                for p, a, g in zip(plans, a_val, gather())]

    args = (comm.put(np.repeat(part.val, Dc, axis=0), mesh),)
    outs = program(*args)
    if state is not None:
        state.update(fn=program, args=args, R=R, total=total2,
                     bounds=bounds, grid=(Dr, Dc), plans=plans,
                     plan_s=plan_s,
                     exchanged_words=Dr * Dc * Dr * bcap2 * (1 + vwords))
    return _assemble2d(A, B, Dr, Dc, outs, bounds, mesh)


def _dist_chunked(A: CSR, B: CSR, mesh: Mesh, config: SpGEMMConfig,
                  b_strategy: str, budget: int = 1 << 27) -> CSR:
    """Row-chunked distributed fallback: where one shard's padded plan
    would overflow int32, split A into global row ranges of at most
    ``budget`` intermediate products, run each over the whole mesh, and
    concatenate (the distributed analogue of ``spgemm_chunked``)."""
    blens = np.diff(B.ptr).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(blens[A.col])])
    p_cum = cs[A.ptr]
    bounds = [0]
    while bounds[-1] < A.M:
        lo = bounds[-1]
        hi = int(np.searchsorted(p_cum, p_cum[lo] + budget,
                                 side="right")) - 1
        bounds.append(max(hi, lo + 1))
    ptr = np.zeros(A.M + 1, np.int64)
    cols, vals = [], []
    base = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sub = CSR(M=hi - lo, N=A.N,
                  ptr=(A.ptr[lo:hi + 1] - A.ptr[lo]).astype(np.int32),
                  col=A.col[A.ptr[lo]:A.ptr[hi]],
                  val=A.val[A.ptr[lo]:A.ptr[hi]])
        Cp = _spgemm_dist_bucketed(sub, B, mesh, config, b_strategy, None)
        ptr[lo + 1: hi + 1] = Cp.ptr[1:].astype(np.int64) + base
        cols.append(Cp.col)
        vals.append(Cp.val)
        base += Cp.nnz
    require(base < 2**31, SpGEMMError, "nnz(C) exceeds int32")
    return CSR(M=A.M, N=B.N, ptr=ptr.astype(np.int32),
               col=(np.concatenate(cols) if cols else
                    np.zeros(0, np.int32)),
               val=(np.concatenate(vals) if vals else
                    np.zeros(0, _NP_DTYPES[config.vdtype])))
