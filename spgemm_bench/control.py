"""Readings that a cell's limits are set from, in one process: the
program's on many seeds and the control's on a few, each a short run of
the cell at its own size and load.

The control is the plain reference computed in float32, the precision
below the configuration's float64, put in the program's place as the
timed call (``harness.control_entry``); it must come out not correct.

    python3 -m spgemm_bench.control --workload er_s17_ef16.warm \\
        --seeds 101-112 --control-seeds 201-203 --seconds 5

Prints one JSON line per run (side, seed, correct, the checks) and a
last line with the largest program reading and the smallest control
reading of each number compared.  Needs the card, like a run."""

from __future__ import annotations

import argparse
import json
import sys

from spgemm_bench import run as _threads  # noqa: F401  (sets THREADS first)


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def readings(bench: dict, cell: str, program_seeds: list,
             control_seeds: list, seconds: float, device) -> dict:
    """Runs the cell for each seed, the program's and the control's;
    returns {"program": {check: largest}, "control": {check: smallest}}
    and prints each run's line."""
    from spgemm_bench import harness
    summary = {"program": {}, "control": {}}
    for side, group in (("program", program_seeds),
                        ("control", control_seeds)):
        for seed in group:
            hook = ((lambda run: setattr(run, "entry",
                                         harness.control_entry(run)))
                    if side == "control" else None)
            out = harness.run_cell(bench, cell, seed, seconds, False,
                                   device=device, hook=hook)
            row = {"side": side, "seed": seed, "correct": out["correct"],
                   "attempted": out["attempted"],
                   "checks": {k: v["value"]
                              for k, v in out["checks"].items()}}
            print(json.dumps(row), flush=True)
            pick = max if side == "program" else min
            for k, v in row["checks"].items():
                prev = summary[side].get(k)
                summary[side][k] = v if prev is None else pick(prev, v)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from spgemm_bench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    summary = readings(bench, args.workload, seeds(args.seeds),
                       seeds(args.control_seeds), args.seconds, "cuda:0")
    print(json.dumps({"workload": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
