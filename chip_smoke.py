#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch version.
2. Builds the CUDA kernel (``mh_spgemm_torch/csrc/esc_tail.cu``) with
   nvcc for sm_90a into ``build/`` and prints the build time.
3. Kernel phase: ``esc_tail_flat`` against its plain PyTorch version on
   the card for w2 in {2, 8, 256, 2048, 8192, 32768, 65536}, f64 and
   f32, on duplicate-heavy, empty and all-same-key segments.  Keys and
   counts must match exactly, values within 1e-9 (f64) / 1e-4 (f32)
   absolute-or-relative.
4. Main-path phase: ``spgemm_host`` and ``spgemm_bucketed`` (one cold
   call, then warm calls reusing the state) under the default config on
   the full-size stand-ins scircuit, cage12 and webbase-1M; every C must
   equal the scipy oracle within 1e-9, and the kernel's launch count,
   set to 0 before this phase, must have grown.  Prints per matrix the
   warm ms per SpGEMM (CUDA events), GFLOPS = 2 * intprod / ms, nnz(C),
   the class widths and the slots each tail took.
5. Stage phase: for each stand-in, the device time of a warm call's
   frontend (gathers and product), tails and static extraction, each
   timed alone (CUDA events).
6. Times the kernel on cage12's W=256 class as the main path feeds it
   (CUDA events, warm, many launches) beside its plain version and
   ``torch.sort`` of the same keys, and computes its bound.
7. Prints ``{"kernels": [...]}`` and, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line.  It exits non-zero at once where CUDA is not available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, 700 W
FP64_FLOPS = 34e12              # H100 SXM data sheet, FP64 (non-tensor)
W2S = (2, 8, 256, 2048, 8192, 32768, 65536)
MATRICES = ("scircuit", "cage12", "webbase-1M")
WARM_CALLS = 20
I32_MAX = 2**31 - 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tail_inputs(w2: int, nseg: int, seed: int):
    """Duplicate-heavy keys, one empty and one all-same-key segment,
    random valid lengths; invalid slots carry 2^31-1 and value 0."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, w2 // 4), (nseg, w2)).astype(np.int32)
    n = rng.integers(0, w2 + 1, nseg)
    n[0] = 0
    keys[1] = 7
    n[1] = w2
    keys[np.arange(w2)[None, :] >= n[:, None]] = I32_MAX
    vals = rng.standard_normal((nseg, w2))
    vals[keys == I32_MAX] = 0.0
    return keys.reshape(-1), vals.reshape(-1)


def kernel_phase(torch, et, dev) -> dict:
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    tols = {torch.float64: 1e-9, torch.float32: 1e-4}
    for dtype in (torch.float64, torch.float32):
        for w2 in W2S:
            nseg = max(4, (1 << 20) // w2)
            k, v = tail_inputs(w2, nseg, seed=w2)
            keys = torch.from_numpy(k).to(dev)
            vals = torch.from_numpy(v).to(dtype).to(dev)
            oK, oV, cnt = et.esc_tail_flat(keys, vals, w2=w2)
            torch.cuda.synchronize()
            pK, pV, pc = et.esc_tail_flat_plain(keys, vals, w2=w2)
            check(torch.equal(oK, pK), f"keys differ at w2={w2} {dtype}")
            check(torch.equal(cnt, pc), f"counts differ at w2={w2} {dtype}")
            err = (oV - pV).abs()
            ok = err <= tols[dtype] * torch.clamp(pV.abs(), min=1.0)
            check(bool(ok.all()), f"values differ at w2={w2} {dtype}: "
                  f"max abs err {float(err.max())}")
            errs[dtype] = max(errs[dtype], float(err.max()))
            print(f"kernel w2={w2:6d} {str(dtype):14s} slots={k.size:8d} "
                  f"max_abs_err={float(err.max()):.3e} ok", flush=True)
    return errs


def main_path_phase(torch, mt, et, dev) -> dict:
    """Drive the main path on every stand-in; the kernel's launch count
    is set to 0 just before and read just after.  Returns the states."""
    from mh_spgemm_torch.io.suites import load_matrix
    from mh_spgemm_torch.pipeline import spgemm_bucketed
    kept = {}
    et.esc_tail_flat.launches = 0
    for name in MATRICES:
        t0 = time.perf_counter()
        A = load_matrix(name)
        ref = mt.oracle_spgemm(A, A)
        setup_s = time.perf_counter() - t0
        intprod = A.intprod(A)
        torch.cuda.reset_peak_memory_stats()
        C = mt.spgemm_host(A, device=dev)
        check(C.equals(ref, tol=1e-9), f"{name}: spgemm_host != oracle")
        t0 = time.perf_counter()
        Cd, state = spgemm_bucketed(A, A, device=dev)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(Cd.host().equals(ref, tol=1e-9), f"{name}: cold != oracle")
        plan = state.plan
        per_call = dict(plan.tail_slots)      # this plan ran once (cold)
        out = {}

        def warm():
            out["C"], _ = spgemm_bucketed(A, A, state=state)

        ms = cuda_ms(warm, WARM_CALLS, warmup=1)
        check(out["C"].host().equals(ref, tol=1e-9),
              f"{name}: warm != oracle")
        row = {
            "matrix": name, "rows": A.M, "nnz_a": A.nnz,
            "intprod": intprod, "nnz_c": ref.nnz,
            "warm_ms": ms, "gflops": mt.gflops(intprod, ms),
            "cold_ms": cold_ms, "setup_s": setup_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "widths": [c.W for c in plan.classes],
            "slots_per_call": per_call,
        }
        print("main " + json.dumps(row), flush=True)
        kept[name] = state
        del Cd, C, out
    launches = et.esc_tail_flat.launches
    check(launches > 0, "esc_tail_flat was not launched on the main path")
    return kept, launches


def breakdown_phase(bk, states: dict) -> None:
    """Device time of a warm call's three stages, each timed alone over
    all classes: the frontend (gathers and product), the tails (the
    kernel, plus the direct W = 1 path and the wide-sort tail) and the
    static extraction."""
    for name, state in states.items():
        plan = state.plan
        ops = (state.a_val, state.b_col, state.b_val)
        counts = {"direct": 0, "kernel": 0, "sort": 0}

        def front():
            return [bk.expand_pre(ss, sa, *ops) for _, ss, sa in plan.dev]

        fronts = front()

        def tails():
            return [bk._flat_tail(K, p, v, W=c.W, rows=c.nchunks * c.rb,
                                  seg_passes=c.seg_passes,
                                  route=state.route, counts=counts)
                    for c, (K, p, v) in zip(plan.classes, fronts)]

        slabs = tails()
        ext_src, _ = plan.ext_static_dev
        row = {"matrix": name,
               "frontend_ms": cuda_ms(front, 10),
               "tail_ms": cuda_ms(tails, 10),
               "extract_ms": cuda_ms(
                   lambda: bk.bucketed_extract_static(
                       slabs, ext_src, nnz_c=plan.nnz_c), 10)}
        print("stages " + json.dumps(row), flush=True)


def time_kernel(torch, et, bk, state) -> dict:
    plan = state.plan
    i = max(range(len(plan.classes)),
            key=lambda j: plan.classes[j].W * plan.classes[j].rb
            * plan.classes[j].nchunks * (plan.classes[j].W > 1))
    c = plan.classes[i]
    _, ss, sa = plan.dev[i]
    K, prod, _ = bk.expand_pre(ss, sa, state.a_val, state.b_col,
                               state.b_val)
    w2 = c.W
    slots = K.numel()
    ms = cuda_ms(lambda: et.esc_tail_flat(K, prod, w2=w2), 20)
    plain_ms = cuda_ms(lambda: et.esc_tail_flat_plain(K, prod, w2=w2), 3,
                       warmup=1)
    lib_ms = cuda_ms(lambda: torch.sort(K.view(-1, w2), dim=1), 20)
    _, _, cnt = et.esc_tail_flat_plain(K, prod, w2=w2)
    valid = int((K < I32_MAX).sum())
    adds = valid - int(cnt.sum())             # additions the tail must do
    nbytes = slots * (4 + 8) * 2 + cnt.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / FP64_FLOPS * 1e3
    print(f"timing esc_tail_flat on cage12 W={w2} slots={slots}: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sort "
          f"{lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({nbytes} B, {adds} adds)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "w2": w2, "slots": slots}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mh_spgemm_torch as mt
    from mh_spgemm_torch import _build
    from mh_spgemm_torch.ops import bucketed as bk
    from mh_spgemm_torch.ops import esc_tail as et

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.build("esc_tail")
    print(f"build esc_tail.cu: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds['esc_tail']:.2f} s)", flush=True)
    for line in _build.build_log.get("esc_tail", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas", line.strip())

    errs = kernel_phase(torch, et, dev)
    states, launches = main_path_phase(torch, mt, et, dev)
    breakdown_phase(bk, states)
    t = time_kernel(torch, et, bk, states["cage12"])
    kernels = {"kernels": [{
        "name": "esc_tail_flat", "route": "cuda",
        "source": "mh_spgemm_torch/csrc/esc_tail.cu",
        "replaces": "mh_spgemm_tpu/ops/esc_tail.py:234",
        "launches": launches,
        "max_abs_err": errs[torch.float64],
        "max_abs_err_f32": errs[torch.float32],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "timed_w2": t["w2"], "timed_slots": t["slots"]}]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
