"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m spgemm_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Exits 2 without a result where the card or the cell is missing, and 3
where JAX or the JAX package was loaded.  The last lines on standard
error are the numbers compared, each beside its limit; the last line on
standard output is the result."""

from __future__ import annotations

import argparse
import json
import os
import sys

# one thread for the host's numerical libraries, set before they load: a
# single caller's host work then neither spreads over the cores nor waits
# on its own thread pool, which steadies the host-bound calls
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}
os.environ.update(THREADS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from spgemm_bench import harness
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl[0]["chips"]:
        print(f"{args.workload} needs {wl[0]['chips']} CUDA device(s); "
              "found none" if not torch.cuda.is_available() else
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda:0")
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
