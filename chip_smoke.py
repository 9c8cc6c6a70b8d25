#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch version.
2. Builds both CUDA sources (``mh_spgemm_torch/csrc/esc_tail.cu`` and
   ``pair_matmul.cu``) with nvcc for sm_90a into ``build/``, one nvcc
   per source, started together; prints the build times and the
   registers and spills ptxas reports.
3. Kernel phase: ``esc_tail_flat`` against its plain PyTorch version on
   the card for w2 in {2, 8, 256, 2048, 8192, 32768, 65536}, f64 and
   f32, on duplicate-heavy, empty and all-same-key segments (keys and
   counts exact, values within 1e-9 (f64) / 1e-4 (f32)
   absolute-or-relative); ``pair_matmul_f64`` and ``pair_matmul_f32``
   against their plain versions on a synthetic stream (segments of 1 to
   64 pairs, dead pairs, C blocks with no pair) and on pdb1HYS's own
   pair stream (f64 within 1e-9 absolute-or-relative; f32 within 1e-4 of
   the magnitude of the summed terms, the same pair product over |a| and
   |b|: two f32 summation orders of up to 8192 random-sign terms differ
   by more than 1e-4 absolute where the sum cancels to near zero);
   ``block_gather`` against
   ``index_select`` for f64, f32 and int32 (exact).
4. Bucketed phase: ``spgemm_host`` and ``spgemm_bucketed`` (one cold
   call, then warm calls reusing the state) under the default config on
   the full-size stand-ins scircuit, cage12 and webbase-1M; every C must
   equal the scipy oracle within 1e-9, and the tail kernel's launch
   count, set to 0 before this phase, must have grown.  Prints per
   matrix the engine ``choose_engine`` picks, the warm ms per SpGEMM
   (CUDA events), GFLOPS = 2 * intprod / ms, nnz(C), the class widths and
   the slots each tail took; then each stage of a warm call timed alone.
5. Block-dense phase on the full-size stand-ins pdb1HYS and pwtk:
   ``spgemm_blockdense`` cold, warm calls reusing the state, and
   ``spgemm_host`` under ``mode="auto"``; every C must equal the oracle
   within 1e-9, and both pair kernels' launch counts, set to 0 before
   this phase, must have grown.  Prints the engine ``choose_engine``
   picks, warm ms, GFLOPS, nnz(C), pairs, C blocks, peak memory, and each
   stage timed alone (densify, value pair matmul, pattern pair matmul,
   strips, extraction).
6. Kernel timing: ``esc_tail_flat`` on cage12's W=256 class, and the
   pair matmuls and ``block_gather`` at pwtk's shapes (CUDA events,
   warm, many launches), each beside its plain version, one PyTorch call
   computing the same function (``torch.sort``, ``torch.bmm`` of the
   pre-gathered pairs, ``torch.index_select``) and its bound.
7. CLI phase: ``python -m mh_spgemm_torch pdb1HYS --check --stats --json
   --iters 3`` in a subprocess must exit 0, pass its check on the
   block-dense engine, and print nothing of JAX.
8. Prints ``{"kernels": [...]}``, the card's name and power limit, and,
   as the last line, ``{"ok": true, "device": {...}}``.

Each phase prints its seconds.  Any failed check raises, so the script
exits non-zero and prints no result line.  It exits non-zero at once
where CUDA is not available.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, 700 W
FP64_FLOPS = 34e12              # H100 SXM data sheet, FP64 (non-tensor)
FP64_TC_FLOPS = 67e12           # H100 SXM data sheet, FP64 tensor core
FP32_FLOPS = 67e12              # H100 SXM data sheet, FP32 (non-tensor)
W2S = (2, 8, 256, 2048, 8192, 32768, 65536)
MATRICES = ("scircuit", "cage12", "webbase-1M")
BD_MATRICES = ("pdb1HYS", "pwtk")
SOURCES = ("esc_tail", "pair_matmul")
WARM_CALLS = 20
BD_WARM_CALLS = 10
I32_MAX = 2**31 - 1
BS = 128


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
        engine = mt.choose_engine(A, A, mt.SpGEMMConfig(mode="auto"))
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
            "matrix": name, "auto_engine": engine, "rows": A.M,
            "nnz_a": A.nnz, "intprod": intprod, "nnz_c": ref.nnz,
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


def build_phase(_build) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(_build.build, SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(SOURCES)} "
          "sources in parallel", flush=True)
    for src in SOURCES:
        print(f"build {src}.cu: nvcc {_build.build_seconds[src]:.2f} s")
        for line in _build.build_log.get(src, "").splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print("ptxas", line.strip())


def pair_stream(rng, nab: int, nbb: int, ncb: int):
    """Segments of 1 to 64 pairs in C-block order, about 10 % dead
    pairs, one C block whose pairs are all dead, and C blocks with no
    pair."""
    lens = rng.integers(1, 65, ncb)
    lens[rng.random(ncb) < 0.15] = 0
    lens[0] = 0
    lens[1] = 64
    cb = np.repeat(np.arange(ncb), lens).astype(np.int32)
    live = (rng.random(cb.size) > 0.1).astype(np.int32)
    live[cb == 2] = 0
    return (rng.integers(0, nab, cb.size).astype(np.int32),
            rng.integers(0, nbb, cb.size).astype(np.int32), cb, live)


def check_pair_kernel(torch, pm, a, b, stream, ncb: int, label: str):
    """Kernel against its plain version on the same card tensors; C
    blocks without a live pair must be zero.  Returns the max abs
    error."""
    f64 = a.dtype == torch.float64
    fn = pm.pair_matmul_f64 if f64 else pm.pair_matmul_f32
    out = fn(a, b, *stream, ncb=ncb)
    torch.cuda.synchronize()
    ref = pm.pair_matmul_plain(a, b, *stream, ncb=ncb)
    err = (out - ref).abs()
    if f64:
        bound = 1e-9 * torch.clamp(ref.abs(), min=1.0)
    else:
        scale = pm.pair_matmul_plain(a.abs(), b.abs(), *stream, ncb=ncb)
        bound = 1e-4 * torch.clamp(scale, min=1.0)
    check(bool((err <= bound).all()),
          f"{fn.__name__} differs on {label}: max abs err "
          f"{float(err.max())}")
    cb, live = stream[2], stream[3]
    dead = torch.ones(ncb, dtype=torch.bool, device=a.device)
    dead[cb[live != 0].long()] = False
    check(not bool(out[dead].any()), f"{fn.__name__}: empty C blocks "
          f"are not zero on {label}")
    e = float(err.max()) if err.numel() else 0.0
    print(f"kernel {fn.__name__} {label}: pairs={stream[0].numel()} "
          f"ncb={ncb} max_abs_err={e:.3e} ok", flush=True)
    return e


def pair_kernel_phase(torch, pm, tbd, pdb, dev) -> dict:
    """Both pair matmuls on a synthetic stream and on pdb1HYS's own
    pair stream, and block_gather against index_select."""
    errs = {"pair_matmul_f64": 0.0, "pair_matmul_f32": 0.0}
    rng = np.random.default_rng(2)
    ncb = 200
    stream = [torch.from_numpy(x).to(dev)
              for x in pair_stream(rng, 300, 250, ncb)]
    for dtype in (torch.float64, torch.float32):
        a = torch.from_numpy(rng.standard_normal((300, BS, BS))).to(
            dtype).to(dev)
        b = torch.from_numpy(rng.standard_normal((250, BS, BS))).to(
            dtype).to(dev)
        name = "pair_matmul_f64" if dtype == torch.float64 \
            else "pair_matmul_f32"
        errs[name] = max(errs[name], check_pair_kernel(
            torch, pm, a, b, stream, ncb, "synthetic"))
    plan = tbd.plan_blockdense(pdb.ptr, pdb.col, pdb.ptr, pdb.col, pdb.M,
                               pdb.N, pdb.N, max_pairs=1 << 18)
    tbd.upload_blockplan(plan, dev)
    d = plan.dev
    val = torch.from_numpy(pdb.val).to(dev)
    ad, ap = tbd.densify(d["a_blk"], d["a_pos"], val, nblk=plan.nab)
    bd, bp = tbd.densify(d["b_blk"], d["b_pos"], val, nblk=plan.nbb)
    stream = (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"])
    errs["pair_matmul_f64"] = max(errs["pair_matmul_f64"], check_pair_kernel(
        torch, pm, ad, bd, stream, plan.ncb, "pdb1HYS values"))
    errs["pair_matmul_f32"] = max(errs["pair_matmul_f32"], check_pair_kernel(
        torch, pm, ap, bp, stream, plan.ncb, "pdb1HYS patterns"))
    for dtype in (torch.float64, torch.float32, torch.int32):
        table = torch.from_numpy(rng.integers(-2**20, 2**20, (64, BS, BS))
                                 ).to(dtype).to(dev)
        idx = torch.from_numpy(rng.integers(0, 64, 500).astype(np.int32)
                               ).to(dev)
        out = pm.block_gather(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(out, table.index_select(0, idx.long())),
              f"block_gather differs from index_select ({dtype})")
        print(f"kernel block_gather {str(dtype):14s} blocks=500 exact ok",
              flush=True)
    errs["block_gather"] = 0.0
    return errs


def blockdense_phase(torch, mt, pm, mats: dict, dev):
    """Drive the block-dense engine on every stand-in; the pair kernels'
    launch counts are set to 0 just before and read just after.  Returns
    (states, launches)."""
    from mh_spgemm_torch.pipeline import spgemm_blockdense
    kept, refs = {}, {}
    for name, A in mats.items():
        t0 = time.perf_counter()
        refs[name] = mt.oracle_spgemm(A, A)
        print(f"oracle {name}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    for fn in (pm.pair_matmul_f64, pm.pair_matmul_f32, pm.block_gather):
        fn.launches = 0
    for name, A in mats.items():
        ref = refs[name]
        intprod = A.intprod(A)
        t0 = time.perf_counter()
        engine = mt.choose_engine(A, A, mt.SpGEMMConfig(mode="auto"))
        choose_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Cd, state = spgemm_blockdense(A, A, device=dev)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(Cd.host().equals(ref, tol=1e-9), f"{name}: cold != oracle")
        out = {}

        def warm():
            out["C"], _ = spgemm_blockdense(A, A, state=state)

        ms = cuda_ms(warm, BD_WARM_CALLS, warmup=1)
        check(out["C"].host().equals(ref, tol=1e-9),
              f"{name}: warm != oracle")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del Cd, out
        C = mt.spgemm_host(A, config=mt.SpGEMMConfig(mode="auto"),
                           device=dev)
        check(C.equals(ref, tol=1e-9), f"{name}: auto != oracle")
        plan = state.plan
        row = {"matrix": name, "auto_engine": engine,
               "choose_engine_s": choose_s, "rows": A.M, "nnz_a": A.nnz,
               "intprod": intprod, "nnz_c": ref.nnz, "pairs": plan.npairs,
               "a_blocks": plan.nab, "c_blocks": plan.ncb,
               "strip_classes": [(s.nj, s.nrows_blk) for s in plan.strips],
               "warm_ms": ms, "gflops": mt.gflops(intprod, ms),
               "cold_ms": cold_ms, "peak_mem_gb": peak}
        print("blockdense " + json.dumps(row), flush=True)
        kept[name] = state
        del C
    launches = {fn.__name__: fn.launches for fn in
                (pm.pair_matmul_f64, pm.pair_matmul_f32, pm.block_gather)}
    check(launches["pair_matmul_f64"] > 0 and launches["pair_matmul_f32"] > 0,
          f"the pair kernels were not launched: {launches}")
    return kept, launches


def blockdense_stages(torch, pm, tbd, mats: dict, states: dict, dev):
    """Device time of each stage of a block-dense call, timed alone:
    densify (cold calls only), the value and the pattern pair matmul,
    the strips, and the extraction."""
    for name, state in states.items():
        plan = state.plan
        d = plan.dev
        stream = (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"])
        val = torch.from_numpy(mats[name].val).to(dev)

        def dens():
            tbd.densify(d["a_blk"], d["a_pos"], val, nblk=plan.nab)
            tbd.densify(d["b_blk"], d["b_pos"], val, nblk=plan.nbb)

        def vals():
            return pm.pair_matmul_f64(d["a_dense"], d["b_dense"], *stream,
                                      ncb=plan.ncb)

        def pats():
            return pm.pair_matmul_f32(d["a_pat"], d["b_pat"], *stream,
                                      ncb=plan.ncb)

        cv, cp = vals(), pats()
        specs = tuple((s.nj, s.nrows_blk) for s in plan.strips)

        def strips():
            return tbd._blockdense_strips(d, cv, cp, specs, plan.m,
                                          by_end_pair=False)

        main_out = strips()
        row = {"matrix": name, "densify_ms": cuda_ms(dens, 3),
               "values_ms": cuda_ms(vals, 5), "patterns_ms": cuda_ms(pats, 5),
               "strips_ms": cuda_ms(strips, 3),
               "extract_ms": cuda_ms(
                   lambda: tbd.finish_blockdense(plan, main_out), 5)}
        print("bdstages " + json.dumps(row), flush=True)
        del cv, cp, main_out


def time_pair_kernels(torch, pm, tbd, state) -> dict:
    """The pair matmuls and block_gather at pwtk's shapes, warm."""
    plan = state.plan
    d = plan.dev
    stream = (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"])
    G, ncb = plan.npairs, plan.ncb
    res = {}
    for name, fn, a, b, peak in (
            ("pair_matmul_f64", pm.pair_matmul_f64, d["a_dense"],
             d["b_dense"], FP64_TC_FLOPS),
            ("pair_matmul_f32", pm.pair_matmul_f32, d["a_pat"], d["b_pat"],
             FP32_FLOPS)):
        ms = cuda_ms(lambda: fn(a, b, *stream, ncb=ncb), 10)
        plain_ms = cuda_ms(lambda: pm.pair_matmul_plain(a, b, *stream,
                                                        ncb=ncb), 2,
                           warmup=1)
        ga = a.index_select(0, d["pair_a"])
        gb = b.index_select(0, d["pair_b"])
        lib_ms = cuda_ms(lambda: torch.bmm(ga, gb), 10)
        del ga, gb
        # every pair is live; each A and B block a pair names is read
        # once, each C block written once, the four streams read once
        flops = 2 * G * BS ** 3
        nblk = (int(torch.unique(d["pair_a"]).numel())
                + int(torch.unique(d["pair_b"]).numel()) + ncb)
        nbytes = nblk * BS * BS * a.element_size() + 4 * G * 4
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ns_elem = ms * 1e6 / (G * BS * BS)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "ns_per_pair_elem": ns_elem, "tflops": flops / ms / 1e9}
        print(f"timing {name} on pwtk ({G} pairs, {ncb} C blocks): "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, torch.bmm of the gathered pairs "
              f"{lib_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
              f"({flops} flop, {nbytes} B); {ns_elem:.4f} ns per dense "
              f"pair element", flush=True)
    print(f"routing constant _per_elem_s (TPU v5e, unchanged): f64 on the "
          f"pair kernel {tbd._per_elem_s(torch.float64, True) * 1e9:.1f} "
          f"ns, f32 {tbd._per_elem_s(torch.float32, True) * 1e9:.1f} ns "
          "per dense pair element", flush=True)
    table, idx = d["a_dense"], d["pair_a"]
    ms = cuda_ms(lambda: pm.block_gather(table, idx), 10)
    plain_ms = cuda_ms(lambda: pm.block_gather_plain(table, idx), 10)
    lib_ms = cuda_ms(lambda: torch.index_select(table, 0, idx), 10)
    # each distinct table block that idx names is read once, each
    # gathered block written once
    nread = int(torch.unique(idx).numel())
    nbytes = (nread + G) * BS * BS * table.element_size() + 4 * G
    res["block_gather"] = {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms,
                           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "bound_by": "bytes"}
    print(f"timing block_gather on pwtk's A blocks by pair ({G} blocks of "
          f"{BS}x{BS} f64 from {nread} distinct): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms, bound "
          f"{res['block_gather']['bound_ms']:.4f} ms ({nbytes} B)",
          flush=True)
    return res


def cli_phase() -> dict:
    """The CLI in a subprocess on pdb1HYS: exit 0, check passes on the
    block-dense engine, and nothing of JAX in its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mh_spgemm_torch", "pdb1HYS", "--check",
           "--stats", "--json", "--iters", "3"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        print("cli", line)
    check(proc.returncode == 0, f"CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][0])
    check(res.get("check") == "pass", "CLI check did not pass")
    check(res["stats"]["engine"] == "blockdense",
          f"CLI ran the {res['stats']['engine']} engine")
    text = (proc.stdout + proc.stderr).lower()
    check("jax" not in text and "mh_spgemm_tpu" not in text,
          "the CLI's output mentions JAX")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mh_spgemm_torch as mt
    from mh_spgemm_torch import _build
    from mh_spgemm_torch.io.suites import load_matrix
    from mh_spgemm_torch.ops import blockdense as tbd
    from mh_spgemm_torch.ops import bucketed as bk
    from mh_spgemm_torch.ops import esc_tail as et
    from mh_spgemm_torch.ops import pair_matmul as pm

    # the plain versions and the library yardstick compute in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    clock = [t_start]

    def done(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    build_phase(_build)
    done("build")
    bd_mats = {name: load_matrix(name) for name in BD_MATRICES}
    done("load block-dense stand-ins")
    errs = kernel_phase(torch, et, dev)
    perrs = pair_kernel_phase(torch, pm, tbd, bd_mats["pdb1HYS"], dev)
    done("kernels")
    states, launches = main_path_phase(torch, mt, et, dev)
    done("bucketed")
    breakdown_phase(bk, states)
    t = time_kernel(torch, et, bk, states["cage12"])
    del states
    done("bucketed stages and esc_tail_flat timing")
    bd_states, bd_launches = blockdense_phase(torch, mt, pm, bd_mats, dev)
    done("block-dense")
    blockdense_stages(torch, pm, tbd, bd_mats, bd_states, dev)
    pt = time_pair_kernels(torch, pm, tbd, bd_states["pwtk"])
    del bd_states
    done("block-dense stages and pair-kernel timing")
    cli = cli_phase()
    done("cli")
    replaces = {"pair_matmul_f32": "mh_spgemm_tpu/ops/pallas_gather.py:108",
                "pair_matmul_f64": "mh_spgemm_tpu/ops/ozaki.py:201",
                "block_gather": "mh_spgemm_tpu/ops/pallas_gather.py:43"}
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
        "timed_w2": t["w2"], "timed_slots": t["slots"]}] + [{
            "name": name, "route": "cuda",
            "source": "mh_spgemm_torch/csrc/pair_matmul.cu",
            "replaces": replaces[name],
            "launches": bd_launches[name], "max_abs_err": perrs[name],
            "ms": pt[name]["ms"], "plain_ms": pt[name]["plain_ms"],
            "bound_ms": pt[name]["bound_ms"],
            "bound_by": pt[name]["bound_by"],
            "library_ms": pt[name]["library_ms"],
            "timed_on": "pwtk"}
            for name in ("pair_matmul_f32", "pair_matmul_f64",
                         "block_gather")]}
    print(json.dumps({"cli_gflops": cli["gflops"],
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
