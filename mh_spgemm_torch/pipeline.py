"""Pipeline drivers of the PyTorch port: the bucketed engine end to end
(``spgemm_bucketed``), its row-chunked fallback for product streams past
int32 indexing (``spgemm_chunked``), the block-dense engine
(``spgemm_blockdense``), the class-based masked engine
(``spgemm_masked``), the per-matrix engine choice of ``mode="auto"``
(``choose_engine``), the DeviceCSR-level engines (``spgemm`` with a
reusable ``SpGEMMPlan``: the product-granularity masked pipeline and the
fused ESC engine, with the reference's seven-phase accounting), and the
CSR-in / CSR-out ``spgemm_host``.

Every entry point runs on the card (``device=None`` means ``"cuda"``,
and a given ``state`` keeps the device it was prepared for)
unless the caller names another device, and raises when CUDA is
absent; it never carries on on the CPU by itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import (DEFAULT_CONFIG, SpGEMMConfig, check_supported,
                     fill_mode, planned_mode)
from .csr import CSR, DeviceCSR
from .errors import DeviceError, ShapeMismatchError, SpGEMMError, require
from .ops import blockdense as blockdense_ops
from .ops import bucketed as bucketed_ops
from .ops import mask as mask_ops
from .ops import masked_classes as masked_ops
from .ops import numeric as numeric_ops
from .ops import symbolic as symbolic_ops
from .ops.shapes import quantize, quantize_pow2
from .timing import PhaseTimer, Timing, device_fence, span

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}
_INT32_MAX = 2**31 - 1

_FENCE_ON = True


class no_fence:
    """Context: the engines skip their end-of-call synchronize, so a
    benchmark loop queues its calls back to back and synchronizes once
    (``bench/driver.run_matrix``)."""

    def __enter__(self):
        global _FENCE_ON
        self._prev = _FENCE_ON
        _FENCE_ON = False
        return self

    def __exit__(self, *exc):
        global _FENCE_ON
        _FENCE_ON = self._prev
        return False


def _fence(device) -> None:
    if _FENCE_ON:
        device_fence(device)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass
class BucketedState:
    """Cached per-(A, B) state: the bucket plan (with its device tensors
    and learned capacities) and the operands on the device, the planar
    fill stream of B among them when a class fills.  ``planned`` is the
    resolved ``planned`` setting the plan was made under, and
    ``replanned`` says that the legacy-replan rule replaced its planned
    plan."""

    plan: bucketed_ops.BucketPlan
    device: torch.device
    route: str                  # "kernel" or "sort" (config.esc_tail)
    planned: str = "off"        # resolved: "on" or "off"
    replanned: bool = False
    a_val: Optional[torch.Tensor] = None
    b_col: Optional[torch.Tensor] = None
    b_val: Optional[torch.Tensor] = None
    pairs: Optional[torch.Tensor] = None


def _vwords(config: SpGEMMConfig) -> int:
    return 2 if config.vdtype == torch.float64 else 1


def _require_fill(planned: str, config: SpGEMMConfig, device) -> None:
    """A warm call runs a plan only under the ``dma_fill`` it was made
    for: the fill classes, tile fills and windowed extraction are fixed
    in the plan."""
    require(planned == fill_mode(config, device), SpGEMMError,
            f"state was prepared under dma_fill={planned!r}, not "
            f"{fill_mode(config, device)!r}")


def _require_planned(state: BucketedState, config: SpGEMMConfig) -> None:
    """A warm call runs a plan only under the ``planned`` setting it was
    made for: the planned classes and extraction are fixed in the plan."""
    want = planned_mode(config, state.device)
    require(state.planned == want, SpGEMMError,
            f"state was prepared under planned={state.planned!r}, not "
            f"{want!r}")


def prepare_bucketed_state(A: CSR, B: CSR,
                           config: SpGEMMConfig = DEFAULT_CONFIG,
                           device=None) -> BucketedState:
    """Host-side planning for the bucketed engine (the ``state=None``
    branch of :func:`spgemm_bucketed`): precomputed-slot classes on the
    power-of-two grid; fill classes where ``config.dma_fill`` resolves
    for ``device`` to allow them (:func:`config.fill_mode`); and, where
    ``config.planned`` resolves to "on" (:func:`config.planned_mode`), the
    planned frontend and the long-span demotion, then the JAX pipeline's
    legacy-replan rule (:func:`ops.bucketed.needs_replan`): a plan whose
    demoted classes dominate is made again with ``precompute=False`` (the
    1.5x grid from ``config.min_bucket_width``, gather or fill classes).
    ``config.min_bucket_width`` shapes no other plan."""
    route = check_supported(config)
    dev = resolve_device(device)
    planned = planned_mode(config, dev)
    vwords = _vwords(config)
    # esc_tail="pow2" also rounds fill-class widths up to a power of two
    # where values travel as f32 words, as the JAX pipeline does
    kw = dict(min_width=config.min_bucket_width,
              area_cap=config.bucket_area_cap, vwords=vwords,
              dma_fill=fill_mode(config, dev),
              pow2_fill_widths=config.esc_tail == "pow2" and vwords == 1)
    with span("plan"):
        with span("plan.first"):
            plan = bucketed_ops.plan_buckets(A.ptr, A.col, B.ptr,
                                             precompute=True,
                                             planned=planned, **kw)
        replanned = planned != "off" and bucketed_ops.needs_replan(plan)
        if planned != "off":
            plan.replan_share = bucketed_ops.replan_share(plan)
        if replanned:
            judged = plan
            with span("plan.replan"):
                plan = bucketed_ops.plan_buckets(A.ptr, A.col, B.ptr,
                                                 precompute=False,
                                                 planned="off", **kw)
            plan.replanned = True
            plan.replan_share = judged.replan_share
            plan.demoted_classes = judged.demoted_classes
    return BucketedState(plan=plan, device=dev, route=route,
                         planned=planned, replanned=replanned)


def _upload_operands(state, A: CSR, B: CSR, vdtype: torch.dtype) -> None:
    """Values, B's columns and (for a plan with fill classes) B's planar
    fill stream on the state's device, once."""
    np_dt = _NP_DTYPES[vdtype]
    dev = state.device
    plan = state.plan
    with span("upload"):
        state.a_val = torch.from_numpy(A.val.astype(np_dt)).to(dev)
        state.b_val = torch.from_numpy(B.val.astype(np_dt)).to(dev)
        state.b_col = torch.from_numpy(
            np.ascontiguousarray(B.col, dtype=np.int32)).to(dev)
        if bucketed_ops.needs_pairs(plan):
            state.pairs = torch.from_numpy(bucketed_ops.build_pairs_planar(
                B.col, B.val.astype(np_dt), plan.vwords,
                bucketed_ops.pairs_wrows_max(plan))).to(dev)
    bucketed_ops.upload_plan(plan, dev)      # its own span when it copies


def spgemm_bucketed(A: CSR, B: CSR,
                    config: SpGEMMConfig = DEFAULT_CONFIG,
                    timing: Optional[Timing] = None,
                    state: Optional[BucketedState] = None,
                    device=None) -> tuple[DeviceCSR, BucketedState]:
    """Bucketed ESC SpGEMM, C = A @ B.  Returns (C on the device,
    reusable state).  The first call per (A, B) plans on the host and
    fetches nnz(C) per row once; a call with the returned ``state`` takes
    the warm path (main stage and extraction with no sync between)."""
    require(A.N == B.M, ShapeMismatchError, "A.N must equal B.M")
    route = check_supported(config)
    with span("bucketed"):
        with PhaseTimer.phase(timing, "symbolic_binning"):
            if state is None:
                state = prepare_bucketed_state(A, B, config, device)
            elif device is not None:
                require(resolve_device(device) == state.device, SpGEMMError,
                        "state was prepared for another device")
            require(state.route == route, SpGEMMError,
                    "state was prepared under another esc_tail setting")
            _require_fill(state.plan.dma_fill, config, state.device)
            _require_planned(state, config)
            plan = state.plan
        dev = state.device

        with PhaseTimer.phase(timing, "mem_alloc"):
            if state.a_val is None:
                _upload_operands(state, A, B, config.vdtype)

        if A.nnz == 0 or B.nnz == 0 or not plan.classes:
            C = DeviceCSR(M=A.M, N=B.N,
                          ptr=torch.zeros(A.M + 1, dtype=torch.int32,
                                          device=dev),
                          col=torch.zeros(0, dtype=torch.int32, device=dev),
                          val=torch.zeros(0, dtype=config.vdtype, device=dev),
                          nnz_true=0)
            return C, state

        if plan.class_caps is not None and not config.profile:
            with PhaseTimer.phase(timing, "calculate_c_nnz"):
                cptr, ccol, cval = bucketed_ops.run_bucketed_fused(
                    plan, state.a_val, state.b_col, state.b_val, state.pairs,
                    route=state.route)
            with PhaseTimer.phase(timing, "numeric"):
                _fence(dev)
            return DeviceCSR(M=A.M, N=B.N, ptr=cptr, col=ccol, val=cval,
                             nnz_true=plan.nnz_c), state

        with PhaseTimer.phase(timing, "calculate_c_nnz"):
            main_out = bucketed_ops.run_bucketed(
                plan, state.a_val, state.b_col, state.b_val, state.pairs,
                route=state.route)
            if config.profile:
                _fence(dev)                # split main vs extraction exactly

        with PhaseTimer.phase(timing, "malloc_c_col_val"):
            cptr, ccol, cval = bucketed_ops.finish_bucketed(plan, main_out)

        with PhaseTimer.phase(timing, "numeric"):
            _fence(dev)
        return DeviceCSR(M=A.M, N=B.N, ptr=cptr, col=ccol, val=cval,
                         nnz_true=plan.nnz_c), state


def spgemm_chunked(A: CSR, B: CSR,
                   config: SpGEMMConfig = DEFAULT_CONFIG,
                   timing: Optional[Timing] = None,
                   max_products: int = 1 << 28, device=None) -> CSR:
    """Row-chunked bucketed SpGEMM for product streams past int32
    indexing: split A into row ranges of at most ``max_products``
    products, run each through :func:`spgemm_bucketed`, and concatenate
    the CSR pieces.  A range whose padded slab still overflows is split
    again at half the budget."""
    require(A.N == B.M, ShapeMismatchError, "A.N must equal B.M")
    check_supported(config)
    dev = resolve_device(device)
    blens = np.diff(B.ptr).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(blens[A.col])])
    p_cum = cs[A.ptr]                      # products before each row

    def _run_range(lo: int, hi: int, budget: int, out: list) -> None:
        sub = CSR(M=hi - lo, N=A.N,
                  ptr=(A.ptr[lo:hi + 1] - A.ptr[lo]).astype(np.int32),
                  col=A.col[A.ptr[lo]:A.ptr[hi]],
                  val=A.val[A.ptr[lo]:A.ptr[hi]])
        try:
            Cd, _ = spgemm_bucketed(sub, B, config=config, timing=timing,
                                    device=dev)
        except bucketed_ops.SlabOverflowError:
            require(hi - lo > 1, SpGEMMError,
                    "a single row's padded product slab exceeds int32 "
                    "indexing")
            mid = int(np.searchsorted(
                p_cum, p_cum[lo] + max(1, budget // 2),
                side="right")) - 1
            mid = min(max(mid, lo + 1), hi - 1)
            _run_range(lo, mid, budget // 2, out)
            _run_range(mid, hi, budget // 2, out)
            return
        out.append(Cd.host())

    bounds = [0]
    while bounds[-1] < A.M:
        lo = bounds[-1]
        hi = int(np.searchsorted(p_cum, p_cum[lo] + max_products,
                                 side="right")) - 1
        bounds.append(max(hi, lo + 1))     # always advance >= one row
    pieces: list = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        _run_range(lo, hi, max_products, pieces)
    ptrs, cols, vals = [np.zeros(1, np.int32)], [], []
    base = 0
    for Cp in pieces:
        ptrs.append(Cp.ptr[1:].astype(np.int64) + base)
        cols.append(Cp.col)
        vals.append(Cp.val)
        base += Cp.nnz
    require(base < 2**31, SpGEMMError, "nnz(C) exceeds int32")
    return CSR(M=A.M, N=B.N,
               ptr=np.concatenate(ptrs).astype(np.int32),
               col=(np.concatenate(cols) if cols else
                    np.zeros(0, np.int32)),
               val=(np.concatenate(vals) if vals else
                    np.zeros(0, _NP_DTYPES[config.vdtype])))


@dataclasses.dataclass
class BlockDenseState:
    """Cached per-(A, B) state of the block-dense engine: the plan, which
    also keeps the densified operands once the first call has made
    them."""

    plan: blockdense_ops.BlockPlan
    device: torch.device
    vdtype: torch.dtype


def _blockdense_route(config: SpGEMMConfig) -> str:
    """``"kernel"`` when the block-dense values ride the streaming pair
    kernels (always in f32, and in f64 unless ``ozaki="off"``), else
    ``"bmm"``.  Native f64 needs no error certificate, so ``"kernel"``
    is the JAX package's certified Ozaki route in every routing
    decision, on every device."""
    if config.vdtype == torch.float32 or config.ozaki != "off":
        return "kernel"
    return "bmm"


def _pair_budget(config: SpGEMMConfig) -> int:
    """Block-pair budget: the streaming pair kernels keep no
    ``[npairs, 128, 128]`` intermediate in device memory, so they take a
    much longer stream than the gather + batched-matmul route, which
    materialises it."""
    return 1 << 18 if _blockdense_route(config) == "kernel" else 16384


def prepare_blockdense_state(A: CSR, B: CSR,
                             config: SpGEMMConfig = DEFAULT_CONFIG,
                             device=None) -> BlockDenseState:
    """Host planning for the block-dense engine (the ``state=None``
    branch of :func:`spgemm_blockdense`)."""
    check_supported(config)
    dev = resolve_device(device)
    plan = blockdense_ops.plan_blockdense(
        A.ptr, A.col, B.ptr, B.col, A.M, A.N, B.N,
        max_pairs=_pair_budget(config))
    require(plan is not None, SpGEMMError,
            "block-dense plan infeasible (empty, a pair stream over the "
            "budget, or a strip slab past int32); use mode='bucketed'")
    plan.route = _blockdense_route(config)
    plan.dma_fill = fill_mode(config, dev)     # windowed extraction gate
    return BlockDenseState(plan=plan, device=dev, vdtype=config.vdtype)


def spgemm_blockdense(A: CSR, B: CSR,
                      config: SpGEMMConfig = DEFAULT_CONFIG,
                      timing: Optional[Timing] = None,
                      state: Optional[BlockDenseState] = None,
                      device=None) -> tuple[DeviceCSR,
                                            Optional[BlockDenseState]]:
    """Block-dense SpGEMM, C = A @ B as dense 128 x 128 block products
    over the nonzero block-pair stream (ops/blockdense.py).  Returns (C
    on the device, reusable state); an empty operand gives the empty C
    and the state it was given.  The first call per (A, B) plans,
    densifies and fetches nnz(C) per row once; a call with the returned
    ``state`` runs with no host sync."""
    require(A.N == B.M, ShapeMismatchError, "A.N must equal B.M")
    check_supported(config)

    if A.nnz == 0 or B.nnz == 0:
        dev = state.device if state is not None else resolve_device(device)
        C = DeviceCSR(M=A.M, N=B.N,
                      ptr=torch.zeros(A.M + 1, dtype=torch.int32,
                                      device=dev),
                      col=torch.zeros(0, dtype=torch.int32, device=dev),
                      val=torch.zeros(0, dtype=config.vdtype, device=dev),
                      nnz_true=0)
        return C, state

    with PhaseTimer.phase(timing, "symbolic_binning"):
        if state is None:
            state = prepare_blockdense_state(A, B, config, device)
        elif device is not None:
            require(resolve_device(device) == state.device, SpGEMMError,
                    "state was prepared for another device")
        require(state.vdtype == config.vdtype
                and state.plan.route == _blockdense_route(config),
                SpGEMMError,
                "state was prepared under another value_dtype or ozaki "
                "setting")
        _require_fill(state.plan.dma_fill, config, state.device)
        plan = state.plan
    dev = state.device

    with PhaseTimer.phase(timing, "mem_alloc"):
        a_val = b_val = None
        if plan.dev is None or "a_dense" not in plan.dev:
            blockdense_ops.upload_blockplan(plan, dev)
            np_dt = _NP_DTYPES[config.vdtype]
            a_val = torch.from_numpy(A.val.astype(np_dt)).to(dev)
            b_val = torch.from_numpy(B.val.astype(np_dt)).to(dev)

    with PhaseTimer.phase(timing, "calculate_c_nnz"):
        main_out = blockdense_ops.run_blockdense(plan, a_val, b_val)
        if config.profile:
            _fence(dev)                # split main vs extraction exactly

    with PhaseTimer.phase(timing, "malloc_c_col_val"):
        cptr, ccol, cval = blockdense_ops.finish_blockdense(plan, main_out)

    with PhaseTimer.phase(timing, "numeric"):
        _fence(dev)
    return DeviceCSR(M=A.M, N=B.N, ptr=cptr, col=ccol, val=cval,
                     nnz_true=plan.nnz_c), state


@dataclasses.dataclass
class MaskedState:
    """Cached per-(A, B) state of the masked engine: the bucket plan
    (``precompute=False``), the per-class tile-slab extras, B's tile
    counts and tile stream on the host, and the operands on the device
    once the first call has uploaded them."""

    plan: bucketed_ops.BucketPlan
    extras: list
    tiles_per_row: np.ndarray
    device: torch.device
    vdtype: torch.dtype
    tile_pairs: Optional[np.ndarray] = None
    ops: Optional[dict] = None


def prepare_masked_state(A: CSR, B: CSR,
                         config: SpGEMMConfig = DEFAULT_CONFIG,
                         device=None) -> MaskedState:
    """Host planning for the masked engine (the ``state=None`` branch of
    :func:`spgemm_masked`): the bucketed planner with ``precompute=False``
    (the 1.5x width grid from ``config.min_bucket_width``; gather or fill
    classes) and the tile-slab extras."""
    check_supported(config)
    dev = resolve_device(device)
    fill = fill_mode(config, dev)
    plan = bucketed_ops.plan_buckets(
        A.ptr, A.col, B.ptr, min_width=config.min_bucket_width,
        area_cap=config.bucket_area_cap, vwords=_vwords(config),
        dma_fill=fill, precompute=False)
    tpr, extras, tile_pairs = masked_ops.plan_masked_extras(
        plan, A.ptr, A.col, B.ptr, B.col, dma_fill=fill)
    return MaskedState(plan=plan, extras=extras, tiles_per_row=tpr,
                       device=dev, vdtype=config.vdtype,
                       tile_pairs=tile_pairs)


def spgemm_masked(A: CSR, B: CSR,
                  config: SpGEMMConfig = DEFAULT_CONFIG,
                  timing: Optional[Timing] = None,
                  state: Optional[MaskedState] = None,
                  device=None) -> tuple[DeviceCSR, MaskedState]:
    """Masked SpGEMM, C = A @ B, on the class machinery
    (ops/masked_classes.py): B's 32-column tile bitmap, an exact OR /
    popcount symbolic stage per row class, then the numeric stage.
    Returns (C on the device, reusable state).  The first call plans,
    uploads and fetches nnz(C) per row once; a call with the returned
    ``state`` runs main stage and extraction with no sync between."""
    require(A.N == B.M, ShapeMismatchError, "A.N must equal B.M")
    check_supported(config)
    with PhaseTimer.phase(timing, "symbolic_binning"):
        if state is None:
            state = prepare_masked_state(A, B, config, device)
        elif device is not None:
            require(resolve_device(device) == state.device, SpGEMMError,
                    "state was prepared for another device")
        require(state.vdtype == config.vdtype, SpGEMMError,
                "state was prepared under another value_dtype")
        _require_fill(state.plan.dma_fill, config, state.device)
        plan = state.plan
    dev = state.device

    if A.nnz == 0 or B.nnz == 0 or not plan.classes:
        C = DeviceCSR(M=A.M, N=B.N,
                      ptr=torch.zeros(A.M + 1, dtype=torch.int32,
                                      device=dev),
                      col=torch.zeros(0, dtype=torch.int32, device=dev),
                      val=torch.zeros(0, dtype=config.vdtype, device=dev),
                      nnz_true=0)
        return C, state

    # B's tile bitmap (excluded from the total, like the reference)
    with PhaseTimer.phase(timing, "form_mask_matrix_b"):
        if state.ops is None:
            state.ops = masked_ops.upload_operands(
                A, B, plan, state.extras, state.tiles_per_row,
                state.tile_pairs, config.vdtype, dev)

    if plan.class_caps is not None and not config.profile:
        with PhaseTimer.phase(timing, "calculate_c_nnz"):
            cptr, ccol, cval = masked_ops.masked_fused(plan, state.extras,
                                                       state.ops)
        with PhaseTimer.phase(timing, "numeric"):
            _fence(dev)
        return DeviceCSR(M=A.M, N=B.N, ptr=cptr, col=ccol, val=cval,
                         nnz_true=plan.nnz_c), state

    with PhaseTimer.phase(timing, "calculate_c_nnz"):
        main_out = masked_ops.masked_main(plan, state.extras, state.ops)
        if config.profile:
            _fence(dev)                # split main vs extraction exactly

    with PhaseTimer.phase(timing, "malloc_c_col_val"):
        cptr, ccol, cval = bucketed_ops.finish_bucketed(plan, main_out)

    with PhaseTimer.phase(timing, "numeric"):
        _fence(dev)
    return DeviceCSR(M=A.M, N=B.N, ptr=cptr, col=ccol, val=cval,
                     nnz_true=plan.nnz_c), state


# ---------------------------------------------------------------------------
# DeviceCSR-level engines: the product-granularity masked pipeline and ESC
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpGEMMPlan:
    """Host sizes discovered during a run of :func:`spgemm`.  A call with
    a plan whose sizes are known reads nothing back from the device and
    synchronizes only at its phase fences (none under
    :class:`no_fence`)."""

    m: int
    n: int
    nnz_a: int
    nnz_b: int
    max_group: int
    total_tiles: Optional[int] = None
    t_prime: Optional[int] = None
    intprod: Optional[int] = None
    nnz_c: Optional[int] = None
    tc: Optional[int] = None


def spgemm(A: DeviceCSR, B: DeviceCSR,
           config: SpGEMMConfig = DEFAULT_CONFIG,
           timing: Optional[Timing] = None,
           plan: Optional[SpGEMMPlan] = None) -> DeviceCSR:
    """C = A @ B on the operands' device (CUDA tensors run on the card,
    CPU tensors on the CPU).  Returns a DeviceCSR whose tensors may be
    capacity-padded; ``M`` / ``nnz_true`` carry the logical sizes and
    ``host()`` trims.  ``mode="masked"`` runs the product-granularity
    masked pipeline, every other mode the fused ESC engine: the bucketed
    and block-dense engines plan from host CSR data
    (:func:`spgemm_host` routes them)."""
    require(A.N == B.M, ShapeMismatchError, "A.N must equal B.M")
    if config.mode == "masked":
        return _spgemm_masked(A, B, config, timing, plan)
    if config.mode in ("esc", "bucketed", "blockdense", "auto"):
        return _spgemm_esc(A, B, config, timing, plan)
    raise SpGEMMError(f"unknown mode {config.mode!r}")


def make_plan(A: DeviceCSR, B: DeviceCSR) -> SpGEMMPlan:
    """A fresh plan: the shapes and the scan pass bound (the longest A
    row, rounded up to a power of two; reads ``A.ptr`` back)."""
    a_row_nnz = np.diff(A.ptr.cpu().numpy())
    max_group = int(a_row_nnz.max()) if a_row_nnz.size else 1
    return SpGEMMPlan(m=A.M, n=B.N, nnz_a=A.nnz, nnz_b=B.nnz,
                      max_group=quantize_pow2(max_group))


def _empty_c(A: DeviceCSR, B: DeviceCSR, config: SpGEMMConfig) -> DeviceCSR:
    dev = A.device
    return DeviceCSR(M=A.M, N=B.N,
                     ptr=torch.zeros(A.M + 1, dtype=torch.int32, device=dev),
                     col=torch.zeros(0, dtype=torch.int32, device=dev),
                     val=torch.zeros(0, dtype=config.vdtype, device=dev),
                     nnz_true=0)


def _spgemm_masked(A: DeviceCSR, B: DeviceCSR, config: SpGEMMConfig,
                   timing: Optional[Timing],
                   plan: Optional[SpGEMMPlan]) -> DeviceCSR:
    """The paper's two-stage pipeline at product granularity: B's mask
    matrix, the exact symbolic stage (tile OR and popcount), then
    mask-guided accumulation.  A cold call reads the mask stage's and the
    symbolic stage's totals back once each; a warm plan reads nothing."""
    dev = A.device
    with PhaseTimer.phase(timing, "mem_alloc"):
        if plan is None:
            plan = make_plan(A, B)
        a_val = A.val.to(config.vdtype)
        b_val = B.val.to(config.vdtype)
        _fence(dev)

    if A.nnz == 0 or B.nnz == 0:
        return _empty_c(A, B, config)

    # B's mask matrix (excluded from the total, like the reference)
    warm = plan.t_prime is not None and plan.nnz_c is not None
    with PhaseTimer.phase(timing, "form_mask_matrix_b"):
        st = mask_ops.mask_stage(B.ptr, B.col, A.ptr, A.col)
        if not warm:
            totals = st.totals.cpu().numpy()
            plan.total_tiles = int(totals[0])
            plan.t_prime = int(totals[1])
            plan.intprod = int(totals[2])
            require(plan.t_prime < _INT32_MAX, SpGEMMError,
                    "symbolic stream exceeds int32; use the chunked "
                    "pipeline")
            require(plan.intprod < _INT32_MAX, SpGEMMError,
                    "product stream exceeds int32; use the chunked "
                    "pipeline")
            # the numeric stage holds several product-long arrays: past
            # this budget the bucketed engine is the path
            require(plan.intprod <= config.masked_max_products,
                    SpGEMMError,
                    f"product stream {plan.intprod} exceeds the masked "
                    "engine's memory budget; use mode='bucketed'/'auto'")

    if plan.t_prime == 0:
        return _empty_c(A, B, config)

    with PhaseTimer.phase(timing, "symbolic_binning"):
        t_prime_cap = quantize(plan.t_prime)

    with PhaseTimer.phase(timing, "calculate_c_nnz"):
        sym = symbolic_ops.symbolic(A.ptr, A.col, st.mask, t_prime_cap,
                                    plan.max_group)
        if not warm:
            _fence(dev)

    with PhaseTimer.phase(timing, "malloc_c_col_val"):
        if not warm:
            sym_totals = sym.totals.cpu().numpy()
            plan.nnz_c = int(sym_totals[0])
            plan.tc = int(sym_totals[1])

    if plan.nnz_c == 0:
        return _empty_c(A, B, config)

    with PhaseTimer.phase(timing, "numeric_binning"):
        nnz_c_cap = quantize(plan.nnz_c)
        tc_cap = quantize(plan.tc)
        intprod_cap = quantize(plan.intprod)

    with PhaseTimer.phase(timing, "numeric"):
        cs, cval = numeric_ops.finish_masked(
            A.ptr, A.col, a_val, B.ptr, B.col, b_val, st.mask, sym,
            intprod_cap, tc_cap, nnz_c_cap)
        _fence(dev)

    return DeviceCSR(M=A.M, N=B.N, ptr=cs.cptr, col=cs.ccol, val=cval,
                     nnz_true=plan.nnz_c)


def _spgemm_esc(A: DeviceCSR, B: DeviceCSR, config: SpGEMMConfig,
                timing: Optional[Timing],
                plan: Optional[SpGEMMPlan]) -> DeviceCSR:
    """Fused expand-sort-compress: no mask matrix, one sort at column
    granularity.  A cold call reads ``A.ptr``, B's row lengths and
    nnz(C) back; a plan that knows ``intprod`` and ``nnz_c`` reads
    nothing."""
    dev = A.device
    with PhaseTimer.phase(timing, "mem_alloc"):
        if plan is None:
            plan = make_plan(A, B)
        a_val = A.val.to(config.vdtype)
        b_val = B.val.to(config.vdtype)
        _fence(dev)

    if A.nnz == 0 or B.nnz == 0:
        return _empty_c(A, B, config)

    with PhaseTimer.phase(timing, "symbolic_binning"):
        if plan.intprod is None:
            blens = np.diff(B.ptr.cpu().numpy()).astype(np.int64)
            a_col = A.col[: A.nnz].cpu().numpy()
            plan.intprod = int(blens[a_col].sum())
        require(plan.intprod < _INT32_MAX, SpGEMMError,
                "product stream exceeds int32; use the chunked pipeline")

    if plan.intprod == 0:
        return _empty_c(A, B, config)

    with PhaseTimer.phase(timing, "numeric"):
        total_cap = quantize(plan.intprod)
        cap = quantize(plan.nnz_c) if plan.nnz_c is not None else total_cap
        res = numeric_ops.numeric_esc(
            A.ptr, A.col, a_val, B.ptr, B.col, b_val,
            total_cap, cap, plan.max_group)
        _fence(dev)

    with PhaseTimer.phase(timing, "malloc_c_col_val"):
        if plan.nnz_c is None:
            plan.nnz_c = int(res.nnz_total)

    return DeviceCSR(M=A.M, N=B.N, ptr=res.cptr, col=res.col_cap,
                     val=res.val_cap, nnz_true=plan.nnz_c)


def choose_engine(A: CSR, B: CSR, config: SpGEMMConfig,
                  device=None) -> str:
    """``"blockdense"`` or ``"bucketed"`` for C = A @ B on ``device`` (the
    card when None), by the JAX package's host cost models (TPU v5e
    constants, not yet measured on the H100): the bucketed estimate
    (``ops/bucketed.estimate_cost_s``, which prices long-span classes at
    the fill frontend's cost on a CUDA device, where the JAX package does
    so on the TPU) against a sampled block-dense estimate, and, only when
    that is within 3x, against the exact block-dense plan's cost."""
    check_supported(config)
    with span("route"):
        on_cuda = torch.device("cuda" if device is None else device).type \
            == "cuda"
        bkt_s = bucketed_ops.estimate_cost_s(
            A.ptr, A.col, B.ptr, min_width=config.min_bucket_width,
            vwords=_vwords(config), fill=on_cuda)
        oz = _blockdense_route(config) == "kernel"
        est = blockdense_ops.estimate_blockdense_cost(
            A.ptr, A.col, B.ptr, B.col, A.M, A.N, config.vdtype, ozaki=oz)
        if est > 3.0 * bkt_s:
            return "bucketed"
        plan = blockdense_ops.plan_blockdense(
            A.ptr, A.col, B.ptr, B.col, A.M, A.N, B.N,
            max_pairs=_pair_budget(config))
        cost = blockdense_ops.blockdense_cost(plan, config.vdtype, ozaki=oz)
        return "blockdense" if cost < bkt_s else "bucketed"


def spgemm_host(A: CSR, B: Optional[CSR] = None,
                config: SpGEMMConfig = DEFAULT_CONFIG,
                timing: Optional[Timing] = None, device=None) -> CSR:
    """CSR in, CSR out.  ``B=None`` computes C = A @ A, or A @ A^T under
    ``config.aat``.  ``mode="auto"`` picks the engine per matrix
    (:func:`choose_engine`); ``mode="esc"`` uploads padded operands and
    runs :func:`spgemm`.  The bucketed engine falls back to
    :func:`spgemm_chunked` when the slab needs more than int32
    indexing."""
    check_supported(config)
    dev = resolve_device(device)
    with span("spgemm_host"):
        if B is None:
            B = A.transpose() if (config.aat and not A.is_symmetric) else A
        mode = config.mode
        if mode == "auto":
            mode = choose_engine(A, B, config, device=dev)
        if mode in ("blockdense", "masked"):
            run = spgemm_blockdense if mode == "blockdense" else spgemm_masked
            C, _ = run(A, B, config=config, timing=timing, device=dev)
            return C.host()
        if mode == "esc":
            dA = A.device(config.vdtype, pad=True, device=dev)
            dB = B.device(config.vdtype, pad=True, device=dev) \
                if B is not A else dA
            return spgemm(dA, dB, config=config, timing=timing).host()
        try:
            C, _ = spgemm_bucketed(A, B, config=config, timing=timing,
                                   device=dev)
        except bucketed_ops.SlabOverflowError:
            return spgemm_chunked(A, B, config=config, timing=timing,
                                  device=dev)
        return C.host()
