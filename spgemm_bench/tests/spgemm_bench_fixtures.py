"""Tiny cells for the CPU tests of the benchmark: the real traffic mixes
and metrics of ``BENCHMARK.json`` over configurations small enough for a
CPU, written to a temporary directory; and small matrices of several
shapes."""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from spgemm_bench import gen, harness


def _rmat(scale, edge_factor, a, b, c, permute, symmetric):
    return {"family": "rmat",
            "params": dict(scale=scale, edge_factor=edge_factor, a=a, b=b,
                           c=c, permute=permute, symmetric=symmetric)}


TINY = {
    "tiny_er": _rmat(11, 6, 0.25, 0.25, 0.25, False, False),
    "tiny_g500": _rmat(10, 8, 0.57, 0.19, 0.19, True, True),
}

# small matrices of several shapes: (name, generator)
SHAPES = [
    ("er", _rmat(10, 7, 0.25, 0.25, 0.25, False, False)),
    ("g500", _rmat(10, 6, 0.57, 0.19, 0.19, True, True)),
    ("skewed_directed", _rmat(10, 4, 0.45, 0.15, 0.3, False, False)),
]


def matrix(generator: dict, seed: int) -> gen.Matrix:
    return gen.make(generator, seed)


def banded(n: int, band: int, per_row: int, seed: int) -> gen.Matrix:
    """Entries drawn within +-band of the diagonal: dense blocks near it."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-band, band + 1, rows.size), 0, n - 1)
    return gen.from_coo(n, n, rows, cols, rng.standard_normal(rows.size))


def real_bench() -> dict:
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def tiny_bench(tmpdir: str) -> dict:
    """``BENCHMARK.json`` with its configurations swapped for tiny ones
    (the real ones' check limits), each under both traffic mixes; a tiny
    cell reports what the real cell of its mix reports."""
    bench = copy.deepcopy(real_bench())
    limits = {c["name"]: harness.load_json(harness.ROOT, c["file"])["check"]
              for c in bench["configs"]}
    strictest = {"val_gap": min(v["val_gap"] for v in limits.values())}
    configs = []
    for name, generator in TINY.items():
        path = os.path.join(tmpdir, f"{name}.json")
        with open(path, "w") as f:
            json.dump({"name": name, "value_dtype": "float64",
                       "mode": "auto", "generator": generator,
                       "check": strictest}, f)
        configs.append({"name": name, "file": path})
    bench["configs"] = configs
    bench["workloads"] = [{"name": f"{n}.{t}", "config": n, "traffic": t,
                           "chips": 1} for n in TINY for t in ("warm", "cold")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            mixes = {w.split(".")[-1] for w in m["workloads"]}
            m["workloads"] = [w["name"] for w in bench["workloads"]
                              if w["traffic"] in mixes]
    return bench
