"""Distributed scaling benchmark of the port — the counterpart of
``mh_spgemm_tpu/bench/dist_bench.py``.

Runs ``spgemm_dist`` at D = 1, 2, 4, ... shards on the same matrix and
reports t(1) / (D * t(D)) beside each D's warm ms (host wall clock of a
call with a reused state, assembly on the host included) and its check
against the scipy oracle.  Shards beyond the number of devices share
them round-robin: on one card ``--max-devices 8`` runs eight virtual
shards, which measures the mechanism, not strong scaling (the output
says so).

Usage:  python -m mh_spgemm_torch.bench.dist_bench [matrix] \\
            [--strategy S] [--max-devices N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mh-spgemm-torch-dist")
    p.add_argument("matrix", nargs="?", default="scircuit")
    p.add_argument("--strategy", default="ragged",
                   choices=["replicate", "allgather", "ragged",
                            "ragged_overlap", "grid2d"])
    p.add_argument("--engine", default="bucketed",
                   choices=["bucketed", "esc"])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--max-devices", type=int, default=None,
                   help="largest shard count (default: the device count); "
                        "shards past the devices share them")
    p.add_argument("--device", default=None,
                   help="torch device type of the shards (default: the "
                        "CUDA cards; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    import torch

    from mh_spgemm_torch import oracle_spgemm, verify
    from mh_spgemm_torch.io import suites
    from mh_spgemm_torch.parallel.mesh import make_grid_mesh, make_row_mesh
    from mh_spgemm_torch.parallel.spgemm_dist import spgemm_dist
    from mh_spgemm_torch.pipeline import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        name = torch.cuda.get_device_name(0)
    else:
        devices, name = [str(dev)], str(dev)
    ndev = args.max_devices or len(devices)
    A = suites.load_matrix(args.matrix)
    ref = oracle_spgemm(A, A)

    results = {}
    t1 = None
    d = 1
    while d <= ndev:
        if args.strategy == "grid2d" and d < 4:
            d *= 2
            continue        # grid2d needs rows x cols with cols = 2
        mesh = (make_grid_mesh(d // 2, 2, devices=devices)
                if args.strategy == "grid2d"
                else make_row_mesh(d, devices=devices))
        st = {}
        C = spgemm_dist(A, None, mesh, b_strategy=args.strategy, state=st,
                        engine=args.engine)                 # plan, upload
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            C = spgemm_dist(A, None, mesh, b_strategy=args.strategy,
                            state=st, engine=args.engine)
            ts.append((time.perf_counter() - t0) * 1e3)
        ok = verify(C, ref, raise_on_fail=False, verbose=False)
        ms = min(ts)
        if d == 1:
            t1 = ms
        results[d] = {"ms": round(ms, 2),
                      "efficiency": (round(t1 / (d * ms), 3)
                                     if t1 else None),
                      "check": "pass" if ok else "error"}
        d *= 2

    print(json.dumps({
        "metric": "spgemm_dist_scaling",
        "matrix": args.matrix,
        "strategy": args.strategy,
        "engine": args.engine,
        "devices": results,
        "backend": dev.type,
        "device": name,
        "physical_devices": len(devices),
        "shards_share_devices": ndev > len(devices),
        "note": ("shards beyond the device count share devices: "
                 "efficiency is not strong scaling"
                 if ndev > len(devices) else ""),
    }))
    return 0 if all(r["check"] == "pass" for r in results.values()) else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
