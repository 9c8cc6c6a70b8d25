"""Benchmark driver of the PyTorch port: the CLI of
``mh_spgemm_tpu/bench/driver.py`` (the reference's ``src/main.cu``
protocol) on one CUDA card.

* The intermediate-product count is computed on the host before any
  device work; GFLOPS = 2 * intprod / (total ms * 1e6).
* Timing: ``warmup`` calls (the first plans, builds the kernels and
  learns nnz(C)), then ``iters`` calls queued back to back with no
  synchronize between them, one synchronize, and the wall time over
  ``iters``.  The phase fields then hold host-side time, and the
  remainder of the measured time is folded into ``numeric``.  Under
  ``--profile`` every call synchronizes between its phases instead.
* A failure prints the reference's ``failed`` line and scores 0 GFLOPS;
  :func:`main` returns 1 when any matrix failed or any check did not
  pass.

    python -m mh_spgemm_torch pdb1HYS --check --stats
    python -m mh_spgemm_torch matrix.mtx --device cpu --mode blockdense
    python -m mh_spgemm_torch scircuit --mode masked --check
    python -m mh_spgemm_torch scircuit --mode esc --check
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

from ..baseline import timed_oracle_spgemm
from ..config import SpGEMMConfig, check_supported
from ..csr import CSR
from ..io.mmio import extract_matrix_name, read_mtx
from ..timing import Timing, device_fence, gflops


@dataclasses.dataclass
class BenchResult:
    name: str
    m: int
    n: int
    nnz_a: int
    nnz_c: int
    intprod: int
    timing: Timing
    gflops: float
    nnzc_per_s: float
    ok: Optional[bool] = None          # oracle comparison, if run
    oracle_ms: Optional[float] = None
    oracle_gflops: Optional[float] = None
    stats: Optional[dict] = None       # engine occupancy counters
    torch_ms: Optional[float] = None   # torch CPU sparse product (--torch)
    torch_gflops: Optional[float] = None
    failed: bool = False
    error: Optional[str] = None        # the exception text of a failure
    digest: Optional[dict] = None      # device result digest (digest=True)

    def as_dict(self) -> dict:
        d = {
            "name": self.name, "M": self.m, "N": self.n,
            "nnz_A": self.nnz_a, "nnz_C": self.nnz_c,
            "intprod": self.intprod, "gflops": self.gflops,
            "nnzc_per_s": self.nnzc_per_s,
            "phases_ms": self.timing.as_dict(),
        }
        if self.ok is not None:
            d["check"] = "pass" if self.ok else "error"
        if self.oracle_gflops is not None:
            d["oracle_ms"] = self.oracle_ms
            d["oracle_gflops"] = self.oracle_gflops
        if self.torch_gflops is not None:
            d["torch_ms"] = self.torch_ms
            d["torch_gflops"] = self.torch_gflops
        if self.stats is not None:
            d["stats"] = self.stats
        if self.error is not None:
            d["error"] = self.error
        return d


def run_matrix(A: CSR, name: str, config: SpGEMMConfig,
               iters: int = 3, warmup: int = 2,
               check: bool = False, verbose: bool = True,
               torch_baseline: bool = False, device=None,
               mode: Optional[str] = None, state=None,
               digest: bool = False) -> BenchResult:
    """Benchmark C = A @ B (B = A, or A^T under ``config.aat``) on one
    matrix, on ``device`` (the card when None).

    ``mode`` and ``state`` let a caller that has chosen the engine and
    prepared its state (for example warmed from the plan cache,
    ``bench/plan_cache.py``) skip planning; the engine updates ``state``
    in place.  ``digest=True`` records ``baseline.digest_device`` of C
    (``BenchResult.digest``), which the suite runner checks against the
    oracle's digest."""
    from .. import pipeline as pl

    B = A.transpose() if (config.aat and not A.is_symmetric) else A
    intprod = A.intprod(B)
    if verbose:
        print(f"Matrix {name} ({A.M} , {B.N}) nnz:{A.nnz}")
        print(f"SpGEMM intermediate result = {intprod}")

    C = None
    bench_timing = Timing()
    try:
        check_supported(config)
        dev = pl.resolve_device(device)
        if mode is None:
            mode = config.mode
        if mode == "auto":
            mode = pl.choose_engine(A, B, config, device=dev)
            if verbose:
                print(f"auto engine: {mode}")
        if mode == "esc":
            # device operands and a plan that knows intprod: the timed
            # calls read only nnz(C) back, on the first warm-up
            dA = A.device(config.vdtype, pad=True, device=dev)
            dB = B.device(config.vdtype, pad=True, device=dev) \
                if B is not A else dA
            plan = pl.make_plan(dA, dB)
            plan.intprod = intprod

            def one(t):
                nonlocal C
                C = pl.spgemm(dA, dB, config=config, timing=t, plan=plan)
        else:
            run = {"bucketed": pl.spgemm_bucketed,
                   "blockdense": pl.spgemm_blockdense,
                   "masked": pl.spgemm_masked}[mode]

            def one(t):
                nonlocal C, state
                C, state = run(A, B, config=config, timing=t, state=state,
                               device=dev)

        for _ in range(warmup):
            one(Timing())
        if not config.profile:
            device_fence(dev)                   # drain before timing
            t0 = time.perf_counter()
            with pl.no_fence():
                for _ in range(iters):
                    t = Timing()
                    one(t)
                    bench_timing += t
            device_fence(dev)
            total_ms = (time.perf_counter() - t0) * 1e3
            bench_timing /= max(1, iters)
            bench_timing.numeric += max(
                0.0, total_ms / max(1, iters) - bench_timing.total())
        else:
            for _ in range(iters):
                t = Timing()
                one(t)
                bench_timing += t
            bench_timing /= max(1, iters)
    except Exception as e:  # the reference prints "failed", 0 GFLOPS
        print(f"MH-SpGEMM failed!!! ({type(e).__name__}: {e})")
        return BenchResult(name=name, m=A.M, n=B.N, nnz_a=A.nnz, nnz_c=0,
                           intprod=intprod, timing=bench_timing, gflops=0.0,
                           nnzc_per_s=0.0, ok=False if check else None,
                           failed=True, error=f"{type(e).__name__}: {e}")

    nnz_c = C.nnz
    total_ms = bench_timing.total()
    gf = gflops(intprod, total_ms)
    nnzc_rate = nnz_c / (total_ms * 1e-3) if total_ms > 0 else 0.0
    if verbose:
        print(f"C.nnz = {nnz_c}")
        bench_timing.print_step_time()
        print(f"MH-SpGEMM runtime is {total_ms:.3f}ms, Gflops is {gf:.2f}")

    res = BenchResult(name=name, m=A.M, n=B.N, nnz_a=A.nnz, nnz_c=nnz_c,
                      intprod=intprod, timing=bench_timing, gflops=gf,
                      nnzc_per_s=nnzc_rate)
    if state is not None:               # the ESC engine has no plan stats
        res.stats = state.plan.stats()
        if intprod and total_ms > 0:
            res.stats["ns_per_product"] = round(total_ms * 1e6 / intprod,
                                                2)
    if digest:
        from ..baseline import digest_device
        res.digest = digest_device(C)
    if check:
        C_ref, oracle_ms = timed_oracle_spgemm(A, B)
        res.oracle_ms = oracle_ms
        res.oracle_gflops = gflops(intprod, oracle_ms)
        res.ok = C.host().equals(C_ref, tol=config.tolerance, verbose=True)
        if verbose:
            print(f"oracle(scipy): {oracle_ms:.3f}ms, Gflops is "
                  f"{res.oracle_gflops:.2f}")
            print("pass" if res.ok else "error")
    if torch_baseline:
        from ..baseline import torch_spgemm
        _, torch_ms = torch_spgemm(A, B)
        res.torch_ms = torch_ms
        res.torch_gflops = gflops(intprod, torch_ms)
        if verbose:
            print(f"torch-cpu: {torch_ms:.3f}ms, Gflops is "
                  f"{res.torch_gflops:.2f}")
    return res


def append_csv(path: str, value: float) -> None:
    """Append one GFLOPS value to a CSV file (the reference's WRITE)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{value:.2f}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mh-spgemm-torch",
        description="SpGEMM benchmark of the PyTorch port on one CUDA "
                    "card (reference CLI parity)")
    p.add_argument("matrix", nargs="?",
                   help=".mtx path or suite matrix name")
    p.add_argument("--suite", action="store_true",
                   help="run the 16-matrix suite")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "bucketed", "blockdense", "masked",
                            "esc"])
    p.add_argument("--dtype", default="float64",
                   choices=["float64", "float32"])
    p.add_argument("--aat", action="store_true", help="C = A @ A^T")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--check", action="store_true",
                   help="verify against the scipy oracle (CHECK_RESULT)")
    p.add_argument("--write", metavar="CSV",
                   help="append GFLOPS to CSV (WRITE flag)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per matrix")
    p.add_argument("--torch", action="store_true",
                   help="also run and time torch's CPU sparse CSR product")
    p.add_argument("--stats", action="store_true",
                   help="print the engine's occupancy counters")
    p.add_argument("--profile", action="store_true",
                   help="synchronize between phases for exact attribution")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    tol = 1e-9 if args.dtype == "float64" else 1e-4
    config = SpGEMMConfig(mode=args.mode, value_dtype=args.dtype,
                          aat=args.aat, tolerance=tol,
                          profile=args.profile)

    from ..io import suites
    names = suites.SIXTEEN_MATRICES if args.suite else [args.matrix]
    if not names or names[0] is None:
        p.error("give a matrix path/name or --suite")

    rc = 0
    for name in names:
        print("-" * 26 + "SpGEMM Start!!!" + "-" * 26)
        try:
            if os.path.exists(name):
                A = read_mtx(name)
                label = extract_matrix_name(name)
            elif "/" in name or name.endswith(".mtx"):
                raise FileNotFoundError(f"no such matrix file: {name}")
            else:
                A = suites.load_matrix(name)
                label = name
            res = run_matrix(A, label, config, iters=args.iters,
                             check=args.check, verbose=not args.json,
                             torch_baseline=args.torch, device=args.device)
            if args.json:
                print(json.dumps(res.as_dict()))
            if args.stats and res.stats is not None:
                print("engine stats:", json.dumps(res.stats))
            if args.write:
                append_csv(args.write, res.gflops)
            if res.failed or res.ok is False:
                rc = 1
        except Exception as e:
            print(f"{name}: FAILED ({type(e).__name__}: {e})")
            rc = 1
        print("-" * 26 + "SpGEMM   End!!!" + "-" * 26)
    return rc


if __name__ == "__main__":
    sys.exit(main())
