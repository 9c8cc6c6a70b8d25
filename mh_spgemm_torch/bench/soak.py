"""Structured 400-case soak of the PyTorch port: every case of the
catalog (``bench/structured.py``) through the five engines of
``spgemm_host`` against ``oracle_spgemm`` under ``CSR.equals(tol=1e-9)``
(the port's counterpart of the JAX package's
``scripts/soak_structured.py``).

    python -m mh_spgemm_torch.bench.soak [--fast] [--family F] [--device cpu]

Prints one JSON report: cases, runs per engine, failures as
``family/i/engine``, exception texts, the launches of the kernels on the
soak's path and seconds; exits 1 when any run failed.  It writes no file.

On the card each family runs in a subprocess of its own (:data:`JOBS` at
a time): a device-side assert poisons the CUDA context of its process, and
would turn every later case into a failure that tells nothing.  The
three cases that showed the repaired faults also run, cold and warm,
under the setting that showed them (:data:`REPAIRED`).  On the CPU
(``--device cpu``) everything runs in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

from . import structured

ENGINES = ("bucketed", "blockdense", "masked", "esc", "auto")
# (family, index, config fields): the masked engine on a B wider than it
# is tall, and the planned planner on chunks that would clone a window
# row 64 times or more
REPAIRED = (("rect_tall", 0, {"mode": "masked"}),
            ("diag_full_row", 6, {"planned": "on"}),
            ("rect_tall", 9, {"planned": "on"}))
# the kernels the soak's engines reach (chip_smoke holds the other two)
KERNELS = ("esc_tail_flat", "esc_tail", "ragged_fill", "pgather", "proute",
           "pair_matmul_f32", "pair_matmul_f64")
TOL = 1e-9
JOBS = 4                    # family subprocesses at a time on the card


def kernel_launches() -> dict:
    """Each soak kernel's launch count in this process."""
    from ..ops import esc_tail, pair_matmul, planned, ragged_fill
    mods = {"esc_tail_flat": esc_tail, "esc_tail": esc_tail,
            "ragged_fill": ragged_fill, "pgather": planned,
            "proute": planned, "pair_matmul_f32": pair_matmul,
            "pair_matmul_f64": pair_matmul}
    return {k: getattr(mods[k], k).launches for k in KERNELS}


def family_cases(family: str, fast: bool = False) -> List[Tuple[str, int]]:
    """A family's cases (every 10th under ``fast``)."""
    return [(family, i) for i in
            range(0, structured.FAMILIES[family][1], 10 if fast else 1)]


def run_cases(cases: Iterable[Tuple[str, int]], device=None,
              engines: Tuple[str, ...] = ENGINES) -> dict:
    """Each case through each engine (``spgemm_host`` under the default
    config with that ``mode``, on ``device``: the card when None) against
    the scipy oracle.  Returns {cases, runs, failures, errors,
    launches, seconds}; ``launches`` counts this call's launches."""
    from ..baseline import oracle_spgemm
    from ..config import SpGEMMConfig
    from ..pipeline import spgemm_host

    t0 = time.perf_counter()
    before = kernel_launches()
    fails, errors, n = [], [], 0
    runs = dict.fromkeys(engines, 0)
    for fam, i in cases:
        A, B = structured.make_case(fam, i)
        ref = oracle_spgemm(A, B)
        for mode in engines:
            runs[mode] += 1
            try:
                C = spgemm_host(A, None if B is A else B,
                                config=SpGEMMConfig(mode=mode),
                                device=device)
                ok = C.equals(ref, tol=TOL)
            except Exception as e:  # noqa: BLE001 - every fault is data
                ok = False
                errors.append(f"{fam}/{i}/{mode}: {type(e).__name__}: {e}")
            if not ok:
                fails.append(f"{fam}/{i}/{mode}")
        n += 1
    after = kernel_launches()
    return {"cases": n, "runs": runs, "failures": fails, "errors": errors,
            "launches": {k: after[k] - before[k] for k in KERNELS},
            "seconds": time.perf_counter() - t0}


def run_repaired(device=None, value_dtype: str = "float64") -> dict:
    """The :data:`REPAIRED` cases, cold and then warm through the state
    the cold call returned, against the oracle (1e-9 in f64, 1e-4 in
    f32).  Returns the same report as :func:`run_cases`, with one run per
    call."""
    from ..baseline import oracle_spgemm
    from ..config import SpGEMMConfig
    from ..pipeline import spgemm_bucketed, spgemm_masked

    tol = TOL if value_dtype == "float64" else 1e-4
    t0 = time.perf_counter()
    before = kernel_launches()
    fails, errors, runs = [], [], {}
    for fam, i, fields in REPAIRED:
        cfg = SpGEMMConfig(value_dtype=value_dtype, **fields)
        run = spgemm_masked if cfg.mode == "masked" else spgemm_bucketed
        label = f"{cfg.mode}/planned={cfg.planned}"
        A, B = structured.make_case(fam, i)
        ref = oracle_spgemm(A, B)
        state = None
        for call in ("cold", "warm"):
            runs[label] = runs.get(label, 0) + 1
            try:
                C, state = run(A, B, config=cfg, state=state, device=device)
                ok = C.host().equals(ref, tol=tol)
            except Exception as e:  # noqa: BLE001
                ok = False
                errors.append(f"{fam}/{i}/{label}/{call}: "
                              f"{type(e).__name__}: {e}")
            if not ok:
                fails.append(f"{fam}/{i}/{label}/{call}")
    after = kernel_launches()
    return {"cases": len(REPAIRED), "runs": runs, "failures": fails,
            "errors": errors,
            "launches": {k: after[k] - before[k] for k in KERNELS},
            "seconds": time.perf_counter() - t0}


def _child(name: str, args: List[str], root: str, timeout: float) -> dict:
    """One ``--run-family`` / ``--run-repaired`` subprocess; a crash or
    timeout is one failure that names the family (or ``repaired``)."""
    cmd = [sys.executable, "-m", "mh_spgemm_torch.bench.soak"] + args
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                           timeout=timeout)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT")]
    except subprocess.TimeoutExpired:
        p, line = None, []
    if not line:
        rc = p.returncode if p is not None else "timeout"
        return {"cases": 0, "runs": {}, "launches": {}, "seconds": 0.0,
                "failures": [f"{name}/crashed rc={rc}"],
                "errors": [p.stderr[-2000:]] if p is not None else []}
    return json.loads(line[-1][len("RESULT"):])


def _merge(parts: dict, seconds: float, device: str) -> dict:
    """One report from the per-family parts and the repaired cases' part
    (kept apart under ``repaired``); launches sum over all."""
    fams = {k: v for k, v in parts.items() if k != "repaired"}
    runs = dict.fromkeys(ENGINES, 0)
    for p in fams.values():
        for k, v in p["runs"].items():
            runs[k] += v
    report = {
        "metric": "structured_soak", "device": device,
        "cases": sum(p["cases"] for p in fams.values()),
        "engines": list(ENGINES), "runs": runs,
        "failures": [f for p in parts.values() for f in p["failures"]],
        "per_family": {k: p["cases"] for k, p in fams.items()},
        "family_seconds": {k: round(p["seconds"], 1)
                           for k, p in parts.items()},
        "errors": {k: p["errors"] for k, p in parts.items() if p["errors"]},
        "launches": {k: sum(p["launches"].get(k, 0)
                            for p in parts.values()) for k in KERNELS},
        "seconds": round(seconds, 1),
    }
    report["repaired"] = {k: parts["repaired"][k]
                          for k in ("runs", "failures")}
    return report


def soak(families: Optional[List[str]] = None, fast: bool = False,
         device: Optional[str] = None) -> dict:
    """The soak over ``families`` (all when None) and the
    :data:`REPAIRED` cases.  On a CUDA device each family (and the
    repaired cases) runs in its own subprocess, :data:`JOBS` at a time;
    on the CPU in this process.  Returns the merged report."""
    from ..pipeline import resolve_device

    fams = list(families or structured.FAMILIES)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    parts = {}
    if dev.type != "cuda":
        for fam in fams:
            parts[fam] = run_cases(family_cases(fam, fast), device=dev)
        parts["repaired"] = run_repaired(device=dev)
    else:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        tail = ["--device", str(dev)] + (["--fast"] if fast else [])
        jobs = [(fam, ["--run-family", fam] + tail) for fam in fams]
        jobs.append(("repaired", ["--run-repaired"] + tail))
        with ThreadPoolExecutor(max_workers=JOBS) as ex:
            got = list(ex.map(lambda j: _child(*j, root, 900.0), jobs))
        parts = {name: r for (name, _), r in zip(jobs, got)}
    return _merge(parts, time.perf_counter() - t0, str(dev))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mh_spgemm_torch.bench.soak",
        description="the structured 400-case soak of the PyTorch port")
    p.add_argument("--fast", action="store_true",
                   help="every 10th case of each family")
    p.add_argument("--family", action="append",
                   choices=list(structured.FAMILIES),
                   help="run only this family (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--run-family", help=argparse.SUPPRESS)
    p.add_argument("--run-repaired", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.run_family or args.run_repaired:
        out = (run_repaired(device=args.device) if args.run_repaired
               else run_cases(family_cases(args.run_family, args.fast),
                              device=args.device))
        print("RESULT" + json.dumps(out), flush=True)
        return 0
    report = soak(args.family, fast=args.fast, device=args.device)
    print(json.dumps(report), flush=True)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
