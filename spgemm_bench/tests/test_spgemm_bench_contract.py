"""``BENCHMARK.json`` keeps to the benchmark's contract, and nothing the
benchmark runs imports JAX or the JAX package, by whole top-level name;
the yardstick imports nothing of the program."""

import ast
import os
import re
import sys

import pytest

from spgemm_bench import harness

import spgemm_bench_fixtures as fx

BENCH = fx.real_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "mh_spgemm_tpu"}
# the yardstick: it reads the program's outputs, never imports it
YARDSTICK = ["gen.py", "reference.py", "check.py", "profile.py"] + [os.path.join("metrics", f) for f in
                              sorted(os.listdir(os.path.join(harness.PKG,
                                                             "metrics")))]


def _sources():
    for dirpath, _, files in os.walk(harness.PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_imports(path) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.PKG))
def test_no_jax_import(path):
    assert not _top_imports(path) & JAX


@pytest.mark.parametrize("rel", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(rel):
    assert "mh_spgemm_torch" not in _top_imports(
        os.path.join(harness.PKG, rel))


def test_runtime_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mh_spgemm_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    for name in JAX:
        sys.modules.pop(name, None)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "mh_spgemm_tpu.ops", sys)
    assert harness.forbidden_modules() == ["jax", "mh_spgemm_tpu"]


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spgemm_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check of 24 cells at this window fits in 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("spgemm_bench/")
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            harness.PKG, "traffic", f"{w['traffic']}.json"))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            reported = {x["name"] for x in
                        harness.cell_metrics(BENCH, cell, False)}
            assert m["moves"] in reported
    for w in BENCH["workloads"]:
        e = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    assert len(open(os.path.join(harness.ROOT, "BENCHMARK.json")).read()) \
        < 64 * 1024
