"""Suite runner of the PyTorch port: SpGEMM GFLOPS over the 16-matrix
suite, each C checked by digest (the port's counterpart of the JAX
package's root ``bench.py``).

    python -m mh_spgemm_torch.bench.suite [--matrices a,b] [--iters 3]
        [--deadline-s 2100] [--masked cant,pdb1HYS] [--device cpu]
        [--out build/suite_summary.json]

* Members run one after another, cheapest first (:data:`ORDER`), under
  ``mode="auto"`` in f64: the engine ``choose_engine`` picks, its state
  warmed from the plan cache (``bench/plan_cache.py``) where a record
  matches, then ``run_matrix(..., digest=True)``: two warm-up calls and
  ``iters`` timed calls.
* Each C is checked by its digest (``baseline.digest_device``: exact
  structure hashes and a weighted value sum) against the scipy oracle's
  digest under ``baseline.digest_check``.  Oracle digests are looked up
  by ``name:M:nnzA:nnzB`` in the committed ``data/oracle_digest.json``
  (read only), then in ``$MHSPGEMM_ORACLE_CACHE`` or
  ``~/.cache/mh_spgemm_torch/oracle_digest.json``; a missing one is
  computed with scipy and stored in the latter.
* A member whose run raises is recorded with its error and counts as a
  check failure.  A member is skipped only by the deadline (it is then
  listed under ``skipped`` and the run is partial).
* The masked-engine contract members (``--masked``, default ``cant`` and
  ``pdb1HYS``) run under ``mode="masked"`` after the suite.
* One JSON line per member, then the summary, whose headline keys come
  last: ``metric`` is ``spgemm_gflops_geomean_16`` for a full run of the
  16 and ``spgemm_gflops_geomean_partial`` for a subset or a cut run,
  ``value`` the geometric mean of the members' GFLOPS (2 * intprod / warm
  ms), ``vs_baseline`` its ratio to the oracle's.  The summary is also
  written to ``--out`` after every member; SIGTERM and SIGINT print it and
  stop.  Exits 1 when a check failed or nothing ran.

The oracle's times in the committed digest file were taken where the
file was made, not on this host; ``oracle_source`` says, per member,
where its digest and time came from.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import signal
import sys
import time
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_DIGESTS = os.path.join(_ROOT, "data", "oracle_digest.json")

# cheapest first, so a run cut by its deadline banks the most members
ORDER = [
    "scircuit", "mac_econ_fwd500", "GAP-road", "pdb1HYS", "webbase-1M",
    "wb-edu", "cage12", "rma10", "offshore", "cant", "pwtk", "cop20k_A",
    "delaunay_n24", "shipsec1", "hood", "cage15",
]
# the masked engine's contract members
MASKED = ["cant", "pdb1HYS"]
MODE, DTYPE = "auto", "float64"

_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(f"[suite +{time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def oracle_cache_path() -> str:
    return os.environ.get("MHSPGEMM_ORACLE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "mh_spgemm_torch",
        "oracle_digest.json")


def _load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def oracle_entry(name: str, A, B) -> dict:
    """{ms, digest, source} of the scipy oracle for C = A @ B: from the
    committed digest file, else the home cache, else computed here and
    stored in the home cache."""
    key = f"{name}:{A.M}:{A.nnz}:{B.nnz}"
    for path, source in ((REPO_DIGESTS, "data/oracle_digest.json"),
                         (oracle_cache_path(), "cache")):
        got = _load_json(path).get(key)
        if isinstance(got, dict) and "digest" in got and "ms" in got:
            return dict(got, source=source)
    from ..baseline import digest_host, timed_oracle_spgemm
    _log(f"{name}: computing the scipy oracle")
    C_ref, ms = timed_oracle_spgemm(A, B)
    entry = {"ms": ms, "digest": digest_host(C_ref)}
    del C_ref
    gc.collect()
    path = oracle_cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cache = _load_json(path)
        cache[key] = entry
        with open(path, "w") as f:
            json.dump(cache, f, indent=0, sort_keys=True)
    except OSError:
        pass
    return dict(entry, source="computed")


def label_of(name: str) -> str:
    """A member's label: a suite name as it is, a .mtx path by its file
    name."""
    from ..io.mmio import extract_matrix_name
    return extract_matrix_name(name) if os.path.exists(name) else name


def _load(name: str):
    """(label, A): a suite name's stand-in (or SuiteSparse file), or a
    .mtx file, which must exist."""
    from ..io.suites import load_matrix
    if not os.path.exists(name) and ("/" in name or name.endswith(".mtx")):
        raise FileNotFoundError(f"no such matrix file: {name}")
    return label_of(name), load_matrix(name)


def run_one(name: str, iters: int, device=None) -> dict:
    """One member through the protocol (``mode="auto"``, f64), with
    plan-cache warming and the digest check."""
    from ..baseline import digest_check
    from ..config import SpGEMMConfig
    from ..pipeline import (choose_engine, prepare_blockdense_state,
                            prepare_bucketed_state, resolve_device)
    from ..timing import gflops
    from . import plan_cache
    from .driver import run_matrix

    t0 = time.monotonic()
    config = SpGEMMConfig(mode=MODE, value_dtype=DTYPE)
    dev = resolve_device(device)
    label, A = _load(name)
    engine = choose_engine(A, A, config, device=dev)
    prep = (prepare_bucketed_state if engine == "bucketed"
            else prepare_blockdense_state)
    state = prep(A, A, config, device=dev)
    hit = plan_cache.try_warm(state, label, A, engine, config)
    res = run_matrix(A, label, config, iters=iters, warmup=2, check=False,
                     verbose=False, device=dev, mode=engine, state=state,
                     digest=True)
    if not hit and not res.failed:
        plan_cache.save(state, label, A, engine, config)
    oracle = oracle_entry(label, A, A)
    if res.failed:
        check = f"error: {res.error}"
    else:
        ok, reason = digest_check(res.digest, oracle["digest"],
                                  tol=config.tolerance)
        check = "pass" if ok else f"error: {reason}"
    out = {
        "gflops": res.gflops,
        "oracle_gflops": gflops(res.intprod, oracle["ms"]),
        "intprod": res.intprod, "nnz_c": res.nnz_c,
        "nnzc_per_s": res.nnzc_per_s,
        "total_ms": res.timing.total(), "oracle_ms": oracle["ms"],
        "oracle_source": oracle["source"],
        "engine": engine, "check": check,
        "plan_cache": "hit" if hit else "miss",
        "seconds": time.monotonic() - t0,
    }
    if res.error is not None:
        out["error"] = res.error
    if res.stats:
        out["stats"] = res.stats
    return out


def run_masked(names, iters: int, device=None) -> dict:
    """The masked-engine contract members under ``mode="masked"``: warm
    ms and GFLOPS each, or its error."""
    from ..config import SpGEMMConfig
    from .driver import run_matrix
    out = {}
    for name in names:
        label = label_of(name)
        try:
            _, A = _load(name)
            cfg = SpGEMMConfig(mode="masked", value_dtype=DTYPE)
            res = run_matrix(A, label, cfg, iters=iters, warmup=2,
                             check=False, verbose=False, device=device,
                             mode="masked")
            out[label] = ({"error": res.error} if res.failed else
                          {"gflops": res.gflops,
                           "total_ms": res.timing.total()})
            del A, res
            gc.collect()
        except Exception as e:  # noqa: BLE001 - recorded, not skipped
            out[label] = {"error": f"{type(e).__name__}: {e}"}
        _log(f"masked {label}: {out[label]}")
    return out


def summary(per_member: dict, skipped: list, masked: dict,
            final: bool) -> dict:
    """The summary object; headline keys last.  It is partial unless the
    run ended and covered the 16 members."""
    ran = [v for v in per_member.values() if v.get("gflops", 0) > 0]
    geo = (math.exp(sum(math.log(v["gflops"]) for v in ran) / len(ran))
           if ran else 0.0)
    geo_base = (math.exp(sum(math.log(max(v["oracle_gflops"], 1e-12))
                             for v in ran) / len(ran)) if ran else 1.0)
    partial = (bool(skipped) or not final
               or sorted(per_member) != sorted(ORDER))
    out = {
        "detail": per_member,
        "skipped": list(skipped),
        "partial": partial,
        "verified": sum(1 for v in per_member.values()
                        if v.get("check") == "pass"),
        "check_failures": sorted(k for k, v in per_member.items()
                                 if v.get("check") != "pass"),
        "baseline": "scipy f64 CPU oracle; times from the digest cache "
                    "where oracle_source says so, not re-measured here",
        "note": "synthetic structural stand-ins; set SUITESPARSE_ROOT "
                "for real matrices",
        "mode": MODE, "dtype": DTYPE,
        "n_matrices": len(ran),
    }
    if masked:
        out["masked"] = masked
    out.update({
        "metric": ("spgemm_gflops_geomean_16" if not partial
                   else "spgemm_gflops_geomean_partial"),
        "value": geo,
        "unit": "GFLOPS",
        "vs_baseline": geo / geo_base if ran else 0.0,
    })
    return out


def _write(path: Optional[str], obj: dict) -> None:
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps(obj) + "\n")
    except OSError:
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mh_spgemm_torch.bench.suite",
        description="the 16-matrix suite of the PyTorch port, each C "
                    "checked by digest")
    p.add_argument("--matrices", default=",".join(ORDER),
                   help="comma-separated suite names or .mtx paths "
                        "(default: the 16, cheapest first)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--deadline-s", type=float, default=2100.0,
                   help="start no member past this many seconds")
    p.add_argument("--masked", default=",".join(MASKED),
                   help="masked-engine contract members ('' skips them)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--out", default=os.path.join(_ROOT, "build",
                                                 "suite_summary.json"),
                   help="file the summary is written to")
    args = p.parse_args(argv)

    names = [n for n in args.matrices.split(",") if n]
    masked_names = [n for n in args.masked.split(",") if n]
    deadline = _T0 + args.deadline_s
    per_member, skipped, masked = {}, list(names), {}
    stop = {"flag": False}

    def flush(final: bool) -> dict:
        s = summary(per_member, skipped, masked, final)
        _write(args.out, s)
        return s

    def on_signal(signum, frame):
        stop["flag"] = True
        _log(f"signal {signum}: flushing the summary")
        print(json.dumps(flush(False)), flush=True)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)

    costs = []
    for name in names:
        remaining = deadline - time.monotonic()
        est = 1.3 * sum(costs) / len(costs) if costs else 240.0
        if stop["flag"] or remaining < min(est, 90.0):
            _log(f"deadline: skipping {name} (remaining {remaining:.0f} s)")
            continue
        t0 = time.monotonic()
        try:
            row = run_one(name, args.iters, device=args.device)
        except Exception as e:  # noqa: BLE001 - recorded as a failure
            err = f"{type(e).__name__}: {e}"
            row = {"error": err, "check": f"error: {err}"}
        label = label_of(name)
        per_member[label] = row
        costs.append(time.monotonic() - t0)
        skipped.remove(name)
        print(json.dumps({"member": label, **row}), flush=True)
        _log(f"{label}: {row.get('engine')} {row.get('gflops', 0):.2f} "
             f"GFLOPS, check {row['check']} ({costs[-1]:.1f} s)")
        flush(False)
        gc.collect()

    if masked_names and not stop["flag"] \
            and deadline - time.monotonic() > 240.0:
        masked.update(run_masked(masked_names, args.iters,
                                 device=args.device))

    s = flush(not stop["flag"])
    print(json.dumps(s), flush=True)
    return 0 if per_member and not s["check_failures"] else 1


if __name__ == "__main__":
    sys.exit(main())
