"""One rank of a multi-process ``spgemm_dist`` job — the port's
counterpart of the JAX package's ``scripts/dist_worker.py``.

    python -m mh_spgemm_torch.parallel.worker PORT RANK NPROC SHARDS_PER_PROC
        [--device cpu|cuda] [--matrix NAME[,NAME...]] [--calls SPEC]
        [--out DIR] [--warm N] [--save-c] [--timeout S]

Start NPROC of these, ranks 0 .. NPROC-1, with one free PORT on
localhost.  Each joins the gloo group (``init_multihost``), builds the
rank-major mesh of NPROC * SHARDS_PER_PROC shards (``--device cuda``,
the default: its card, ``cuda:{rank % device_count()}``, so several
ranks may share one card; ``cpu``: CPU shards), and for each matrix runs
each call of ``--calls`` cold, then ``--warm`` times warm with its state,
holding every C to the port's ``oracle_spgemm`` (``CSR.equals``, 1e-9).

A matrix is ``banded`` (``gen.banded(64, band=5, nnz_per_row=4,
seed=42)``), ``powerlaw`` (``gen.powerlaw(150, avg_nnz=4, seed=43)``) or
a suite name (``io.suites.load_matrix``).  A call is
``ENGINE:STRATEGY:BACKEND`` with optional ``:fill`` (``dma_fill="on"``),
``:force`` (``MHSPGEMM_FORCE_OVERLAP=1``), ``:chunked`` (the row-chunked
overflow fallback, forced, over three chunks) and ``:turns`` (below),
separated by commas;
``all`` (the default) is every engine, strategy and backend
``spgemm_dist`` takes (:data:`ALL_CALLS`); grid2d runs on a
``D/2 x 2`` grid.

Per call the rank prints ``rank R: {json}`` with the C's digest
(:func:`csr_sha`), nnz, the cold call's ms, the warm call's and the
shard program's mean ms, the exchanges' barriers a call and their ms,
the gather of C's host pieces' ms,
and the kernels' launches over the call's cold, warm and program runs
(CUDA; not the turns below), and appends the
record to ``DIR/rank{R}.json``; with ``--save-c`` it also writes C to
``DIR/rank{R}_{matrix}_{call}.npz``.  A ``:turns`` call is then timed
in turns against the single-process call on rank 0's card (single,
multi, multi, single; ``--warm`` warm calls each; the other ranks wait
at a barrier while rank 0 runs alone).  The rank ends with ``rank R:
multiprocess dist OK``, and exits non-zero on the first failure.
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import sys
import time
import traceback

BUCKETED_STRATEGIES = ("replicate", "allgather", "ragged", "ragged_overlap",
                       "grid2d")
ESC_STRATEGIES = ("replicate", "allgather", "ragged")
ALL_CALLS = tuple(
    [f"bucketed:{s}:{b}" + (":force" if s == "ragged_overlap" else "")
     for s in BUCKETED_STRATEGIES for b in ("pallas", "xla")]
    + [f"esc:{s}:{b}" for s in ESC_STRATEGIES for b in ("pallas", "xla")]
    + ["bucketed:ragged:pallas:fill", "bucketed:allgather:xla:chunked"])


def load(name: str):
    """The named matrix: a small generated one or a suite stand-in."""
    from ..bench import gen
    if name == "banded":
        return gen.banded(64, band=5, nnz_per_row=4, seed=42)
    if name == "powerlaw":
        return gen.powerlaw(150, avg_nnz=4, seed=43)
    from ..io.suites import load_matrix
    return load_matrix(name)


def csr_sha(C) -> str:
    """:func:`comm.digest` of C's shape, ptr, col and values: equal
    digests are C bit for bit."""
    import numpy as np
    from .comm import digest
    return digest(C.M, C.N, C.ptr.astype(np.int32), C.col.astype(np.int32),
                  C.val)


def parse_call(spec: str) -> dict:
    parts = spec.split(":")
    if len(parts) < 3:
        raise ValueError(f"a call is ENGINE:STRATEGY:BACKEND[:opt], "
                         f"not {spec!r}")
    opts = set(parts[3:])
    unknown = opts - {"fill", "force", "chunked", "turns"}
    if unknown:
        raise ValueError(f"unknown options {sorted(unknown)} in {spec!r}")
    return {"name": spec, "engine": parts[0], "strategy": parts[1],
            "backend": parts[2], "fill": "on" if "fill" in opts else "auto",
            "force": "force" in opts, "chunked": "chunked" in opts,
            "turns": "turns" in opts}


def _counters():
    from ..ops import (esc_tail, gather_front, planned, ragged_fill,
                       remote_fetch)
    return {"halo_exchange": remote_fetch.halo_exchange,
            "esc_tail": esc_tail.esc_tail,
            "esc_tail_flat": esc_tail.esc_tail_flat,
            "pgather": planned.pgather, "proute": planned.proute,
            "ragged_fill": ragged_fill.ragged_fill,
            "gather_front": gather_front.gather_front}


def _fence(torch, cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def run_call(torch, A, ref, call: dict, mesh, grid, warm: int,
             rank: int) -> tuple:
    """One call: cold, then warm; returns (C, record)."""
    from . import comm
    from . import spgemm_dist as sd
    from ..config import SpGEMMConfig

    cfg = SpGEMMConfig(comm_backend=call["backend"], dma_fill=call["fill"])
    m = grid if call["strategy"] == "grid2d" else mesh
    cuda = m.devices[0].type == "cuda"
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    if call["force"]:
        os.environ["MHSPGEMM_FORCE_OVERLAP"] = "1"
    kw = dict(config=cfg, b_strategy=call["strategy"],
              engine=call["engine"])
    st = {}
    rec = {"rank": rank, "call": call["name"], "D": m.size,
           "grid": [m.shape[k] for k in m.axis_names]}
    try:
        t0 = time.perf_counter()
        if call["chunked"]:
            C = sd._dist_chunked(A, A, m, cfg, call["strategy"],
                                 budget=max(1, _products(A) // 3))
        else:
            C = sd.spgemm_dist(A, None, m, state=st, **kw)
        _fence(torch, cuda)
        rec["cold_ms"] = (time.perf_counter() - t0) * 1e3
        if not C.equals(ref, tol=1e-9):
            raise AssertionError(f"{call['name']}: cold C != oracle")
        if st and warm:
            comm.reset_stats()
            t0 = time.perf_counter()
            for _ in range(warm):
                Cw = sd.spgemm_dist(A, None, m, state=st, **kw)
            rec["warm_ms"] = (time.perf_counter() - t0) * 1e3 / warm
            rec["barriers_per_call"] = comm.stats["barriers"] / warm
            rec["barrier_ms"] = comm.stats["barrier_s"] * 1e3 / warm
            rec["sync_ms"] = comm.stats["sync_s"] * 1e3 / warm
            rec["gather_ms"] = comm.stats["gather_s"] * 1e3 / warm
            if not Cw.equals(C, tol=0.0):
                raise AssertionError(f"{call['name']}: warm C != cold C")
            t0 = time.perf_counter()
            for _ in range(warm):
                st["fn"](*st["args"])
            _fence(torch, cuda)
            rec["program_ms"] = (time.perf_counter() - t0) * 1e3 / warm
        # read before the turns, whose single-process calls on rank 0 are
        # not this call's
        rec["launches"] = {k: fn.launches for k, fn in counters.items()}
        if call["turns"] and st and warm:
            rec["turns"] = _turns(torch, A, m, st, kw, warm, rank, cuda)
    finally:
        os.environ.pop("MHSPGEMM_FORCE_OVERLAP", None)
    rec["nnz"] = int(C.nnz)
    rec["digest"] = csr_sha(C)
    del st
    return C, rec


def _products(A) -> int:
    import numpy as np
    blens = np.diff(A.ptr).astype(np.int64)
    return int(blens[A.col].sum())


def _turns(torch, A, m, st, kw, n: int, rank: int, cuda: bool) -> dict:
    """Warm ms in turns: single, multi, multi, single.  The single-process
    call runs on rank 0 alone, on a mesh of the same shape whose every
    shard it owns on its own device; the others wait at a barrier."""
    import dataclasses
    from . import comm
    from . import spgemm_dist as sd

    local = None
    if rank == 0:
        dev = m.devices[0]
        local = dataclasses.replace(m, devices=(dev,) * m.size,
                                    process_index=(0,) * m.size)
        st1 = {}
        sd.spgemm_dist(A, None, local, state=st1, **kw)

    def timed(mesh, state) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            sd.spgemm_dist(A, None, mesh, state=state, **kw)
        _fence(torch, cuda)
        return (time.perf_counter() - t0) * 1e3 / n

    out = {"single": [], "multi": []}
    for who in ("single", "multi", "multi", "single"):
        if who == "multi":
            out["multi"].append(timed(m, st))
        else:
            if rank == 0:
                out["single"].append(timed(local, st1))
            comm.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("shards_per_proc", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--matrix", default="banded")
    ap.add_argument("--calls", default="all")
    ap.add_argument("--out", default=None)
    ap.add_argument("--warm", type=int, default=2,
                    help="warm calls a call, and in each turn of a "
                    ":turns call")
    ap.add_argument("--save-c", action="store_true")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective waits for a peer")
    args = ap.parse_args(argv)
    rank = args.rank

    import numpy as np
    import torch

    from .. import oracle_spgemm
    from .mesh import init_multihost, make_grid_mesh, make_row_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        print(f"rank {rank}: no CUDA device", file=sys.stderr)
        return 1
    init_multihost(f"localhost:{args.port}", args.nproc, rank,
                   timeout=datetime.timedelta(seconds=args.timeout))
    devices = ["cpu"] if args.device == "cpu" else None
    D = args.nproc * args.shards_per_proc
    mesh = make_row_mesh(D, devices=devices)
    dc = 2 if D % 2 == 0 else 1
    grid = make_grid_mesh(D // dc, dc, devices=devices)
    calls = [parse_call(c) for c in (
        ALL_CALLS if args.calls == "all" else args.calls.split(","))]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    records = []
    for name in args.matrix.split(","):
        A = load(name)
        ref = oracle_spgemm(A, A)
        for call in calls:
            C, rec = run_call(torch, A, ref, call, mesh, grid, args.warm,
                              rank)
            rec["matrix"] = name
            records.append(rec)
            print(f"rank {rank}: " + json.dumps(rec), flush=True)
            if args.out and args.save_c:
                tag = call["name"].replace(":", "-")
                np.savez(os.path.join(args.out,
                                      f"rank{rank}_{name}_{tag}.npz"),
                         ptr=C.ptr, col=C.col, val=C.val,
                         shape=np.array([C.M, C.N]))
            del C
        del A, ref
    if args.out:
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump(records, f)
    # the peers' IPC views go before any process frees what they view
    gc.collect()
    if args.device == "cuda":
        torch.cuda.synchronize()
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: multiprocess dist OK", flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)         # a failed rank must not wait on its peers
    sys.exit(rc)
