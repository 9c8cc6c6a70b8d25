"""Pipeline drivers of the PyTorch port: the bucketed engine end to end
(``spgemm_bucketed``), its row-chunked fallback for product streams past
int32 indexing (``spgemm_chunked``), and the CSR-in / CSR-out
``spgemm_host``.

Every entry point runs on the card (``device=None`` means ``"cuda"``)
unless the caller names another device, and raises when CUDA is
absent; it never carries on on the CPU by itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SpGEMMConfig, check_supported
from .csr import CSR, DeviceCSR
from .errors import DeviceError, ShapeMismatchError, SpGEMMError, require
from .ops import bucketed as bucketed_ops
from .timing import PhaseTimer, Timing, device_fence

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


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
    and learned capacities) and the operands on the device."""

    plan: bucketed_ops.BucketPlan
    device: torch.device
    route: str                  # "kernel" or "sort" (config.esc_tail)
    a_val: Optional[torch.Tensor] = None
    b_col: Optional[torch.Tensor] = None
    b_val: Optional[torch.Tensor] = None


def _vwords(config: SpGEMMConfig) -> int:
    return 2 if config.vdtype == torch.float64 else 1


def prepare_bucketed_state(A: CSR, B: CSR,
                           config: SpGEMMConfig = DEFAULT_CONFIG,
                           device=None) -> BucketedState:
    """Host-side planning for the bucketed engine (the ``state=None``
    branch of :func:`spgemm_bucketed`).  ``config.min_bucket_width`` has
    no effect here: precomputed plans use power-of-two widths, as in the
    JAX package."""
    route = check_supported(config)
    plan = bucketed_ops.plan_buckets(
        A.ptr, A.col, B.ptr, area_cap=config.bucket_area_cap,
        vwords=_vwords(config))
    return BucketedState(plan=plan, device=resolve_device(device),
                         route=route)


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
    timing = timing if timing is not None else Timing()
    route = check_supported(config)
    with PhaseTimer.phase(timing, "symbolic_binning"):
        if state is None:
            state = prepare_bucketed_state(A, B, config, device)
        elif device is not None:
            require(resolve_device(device) == state.device, SpGEMMError,
                    "state was prepared for another device")
        require(state.route == route, SpGEMMError,
                "state was prepared under another esc_tail setting")
        plan = state.plan
    dev = state.device

    with PhaseTimer.phase(timing, "mem_alloc"):
        if state.a_val is None:
            np_dt = _NP_DTYPES[config.vdtype]
            state.a_val = torch.from_numpy(A.val.astype(np_dt)).to(dev)
            state.b_val = torch.from_numpy(B.val.astype(np_dt)).to(dev)
            state.b_col = torch.from_numpy(
                np.ascontiguousarray(B.col, dtype=np.int32)).to(dev)
            bucketed_ops.upload_plan(plan, dev)

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
                plan, state.a_val, state.b_col, state.b_val,
                route=state.route)
        with PhaseTimer.phase(timing, "numeric"):
            device_fence(dev)
        return DeviceCSR(M=A.M, N=B.N, ptr=cptr, col=ccol, val=cval,
                         nnz_true=plan.nnz_c), state

    with PhaseTimer.phase(timing, "calculate_c_nnz"):
        main_out = bucketed_ops.run_bucketed(
            plan, state.a_val, state.b_col, state.b_val, route=state.route)
        if config.profile:
            device_fence(dev)          # split main vs extraction exactly

    with PhaseTimer.phase(timing, "malloc_c_col_val"):
        cptr, ccol, cval = bucketed_ops.finish_bucketed(plan, main_out)

    with PhaseTimer.phase(timing, "numeric"):
        device_fence(dev)
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
    timing = timing if timing is not None else Timing()
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


def spgemm_host(A: CSR, B: Optional[CSR] = None,
                config: SpGEMMConfig = DEFAULT_CONFIG,
                timing: Optional[Timing] = None, device=None) -> CSR:
    """CSR in, CSR out.  ``B=None`` computes C = A @ A, or A @ A^T under
    ``config.aat``.  Falls back to :func:`spgemm_chunked` when the slab
    needs more than int32 indexing."""
    check_supported(config)
    dev = resolve_device(device)
    if B is None:
        B = A.transpose() if (config.aat and not A.is_symmetric) else A
    try:
        C, _ = spgemm_bucketed(A, B, config=config, timing=timing,
                               device=dev)
    except bucketed_ops.SlabOverflowError:
        return spgemm_chunked(A, B, config=config, timing=timing,
                              device=dev)
    return C.host()
