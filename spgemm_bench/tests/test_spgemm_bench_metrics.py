"""Each metric of ``BENCHMARK.json`` is a file of its own, found by name,
that holds its reader (its unit, source, layer and what it moves are the
entry's alone) and reads a synthetic run."""

import types

import numpy as np
import pytest
import scipy.sparse as sp

from spgemm_bench import gen, harness, profile, reference

import spgemm_bench_fixtures as fx

BENCH = fx.real_bench()
ALL = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("entry", ALL, ids=[m["name"] for m in ALL])
def test_metric_file_matches_its_entry(entry):
    mod = harness.load_part("metrics", entry["name"])
    assert callable(mod.read)
    for key in ("UNIT", "SOURCE", "LAYER", "MOVES"):
        assert not hasattr(mod, key)


class _Event:
    def __init__(self, name, t0, t1, device=False, annotation=False):
        self.name = name
        self.time_range = types.SimpleNamespace(start=t0, end=t1)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.is_user_annotation = annotation


def _profile(calls=2):
    """Two calls of 1 ms each (us timestamps): three kernels a call, a
    host gap inside each call under ``aten::nonzero``."""
    ev = [_Event("ProfilerStep#1", 0, 2000)]
    for c in range(calls):
        b = c * 1000
        ev += [_Event("bench::call", b, b + 1000),
               _Event("aten::nonzero", b + 300, b + 500),
               _Event("void (anonymous namespace)::tail_warp<double, 8>"
                      "(int const*)", b + 100, b + 300, device=True),
               _Event("pair_matmul_kernel<double>(double const*)",
                      b + 500, b + 700, device=True),
               _Event("Memcpy DtoH (Device -> Pageable)", b + 700,
                      b + 800, device=True),
               _Event("bench::call", b, b + 1000, device=True,
                      annotation=True)]
    return profile.summarize(ev, calls, 0.0)


def test_profile_summary():
    p = _profile()
    assert p.window_s == pytest.approx(2e-3)
    assert p.busy_s == pytest.approx(2 * 500e-6)
    assert p.launches_per_call() == 3 and not p.partial
    assert p.by_name["tail_warp<double, 8>"] == [2, pytest.approx(4e-4)]
    assert p.idle["call/aten::nonzero"] == pytest.approx(4e-4)
    assert sum(p.idle.values()) == pytest.approx(p.window_s - p.busy_s)


def test_gap_across_spans_is_cut_at_their_edges():
    ev = [_Event("ProfilerStep#1", 0, 1000),
          _Event("bench::route", 0, 400), _Event("bench::plan", 400, 800),
          _Event("bench::run", 800, 1000),
          _Event("kernel", 850, 900, device=True)]
    p = profile.summarize(ev, 1, 0.0)
    assert p.idle == {"route": pytest.approx(4e-4),
                      "plan": pytest.approx(4e-4),
                      "run": pytest.approx(1.5e-4)}


def _run(engine="bucketed"):
    run = harness.Run("c", {}, {}, 1, 1.0, True, "cpu")
    run.A = fx.banded(600, 60, 20, seed=1)
    run.work = {"intprod": gen.intprod(run.A, run.A), "nnz_c": 1000}
    run.setup_s = 12.5
    run.calls = [{"start": 0.0, "end": 0.5, "events": None},
                 {"start": 0.5, "end": 1.0, "events": None}]
    run.spans = {"route": [0.1, 0.3], "plan": [1.0, 2.0]}
    run.counters = {"plan": {"engine": engine, "intprod": 100,
                             "area_slots": 114},
                    "tail_slots": {"direct": 1, "kernel": 3, "sort": 4}}
    run.profile = _profile()
    run.card = {"kind": "NVIDIA H100 80GB HBM3"}
    return run


EXPECT = {
    "setup_s": 12.5, "cold_ms": 500.0, "call_ms_p95": 500.0,
    "route_ms.cold": 200.0, "plan_ms.cold": 1500.0,
    "device_idle_pct.warm": 50.0, "kernels_per_call.warm": 3.0,
    "esc_tail.sort_share": 50.0, "bucketed.padding_ratio": 1.14,
}


@pytest.mark.parametrize("entry", ALL, ids=[m["name"] for m in ALL])
def test_metric_reads_a_synthetic_run(entry):
    mod = harness.load_part("metrics", entry["name"])
    v = mod.read(_run())
    assert isinstance(v, float) and np.isfinite(v) and v > 0
    if entry["name"] in EXPECT:
        assert v == pytest.approx(EXPECT[entry["name"]])
    if entry["unit"] == "%":
        assert v <= 100


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reads_nothing_from_an_empty_run(name):
    """A reader with nothing to read returns nothing, never 0."""
    run = harness.Run("c", {}, {}, 1, 1.0, True, "cpu")
    run.A = fx.banded(300, 10, 5, seed=1)
    assert harness.load_part("metrics", name).read(run) is None


def test_sort_share_reads_the_window_delta():
    run = _run()
    run.counters["tail_slots"] = {"direct": 0, "kernel": 0, "sort": 0}
    share = harness.load_part("metrics", "esc_tail.sort_share")
    assert share.read(run) is None
    run.counters["tail_slots"] = {"direct": 10, "kernel": 60, "sort": 30}
    assert share.read(run) == pytest.approx(30.0)
