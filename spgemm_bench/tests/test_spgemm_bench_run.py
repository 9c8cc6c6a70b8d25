"""Runs of tiny cells on the CPU, past the harness's look for a card: a
sound program comes out correct, and each fault a cell can have, planted
under the timed path, comes out not correct, as does the control."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from spgemm_bench import harness
from mh_spgemm_torch.ops import bucketed

import spgemm_bench_fixtures as fx

CELLS = [f"{n}.{t}" for n in fx.TINY for t in ("warm", "cold")]
CELL = fx.real_bench()["workloads"][0]["name"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return fx.tiny_bench(str(tmp_path_factory.mktemp("bench")))


def _run(bench, cell, hook=None, seconds=0.4, seed=11):
    return harness.run_cell(bench, cell, seed, seconds, False, device="cpu",
                            hook=hook)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    out = _run(bench, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    names = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert set(out["metrics"]) == names
    assert "setup_s" in names and len(names) >= 2
    assert list(out)[-1] == "checks"
    assert out["checks"]["val_gap"]["value"] \
        < out["checks"]["val_gap"]["limit"]


def test_warm_window_reads_the_tail_counter(bench):
    """The warm loop takes the plans' tail slots over the window: every
    call's slots, by route."""
    seen = []
    out = _run(bench, "tiny_er.warm", hook=seen.append)
    slots = seen[0].counters["tail_slots"]
    assert out["correct"] and sum(slots.values()) > 0
    share = harness.load_part("metrics", "esc_tail.sort_share").read(seen[0])
    assert 0 <= share <= 100


def _wrap(transform):
    def hook(run):
        entry = run.entry
        run.entry = lambda A: transform(entry(A))
    return hook


def _value_altered(C):
    val = C.val.clone() if torch.is_tensor(C.val) else C.val.copy()
    val[len(val) // 2] += 1e-6
    return dataclasses.replace(C, val=val)


def _half_rows(C):
    ptr = C.ptr.clone() if torch.is_tensor(C.ptr) else C.ptr.copy()
    ptr[C.M // 2:] = ptr[C.M // 2]
    return dataclasses.replace(C, ptr=ptr)


def _not_run(C):
    val = C.val.clone() if torch.is_tensor(C.val) else C.val.copy()
    val[:] = 0
    return dataclasses.replace(C, val=val)


def _stale(run):
    """Every call returns the first window call's C, as a step that keeps
    its state unchanged, or a cache keyed on the structure, would."""
    entry, first = run.entry, []

    def stale(A):
        if not first:
            first.append(entry(A))
        return first[0]
    run.entry = stale


def _raises(run):
    def boom(A):
        raise RuntimeError("planted")
    run.entry = boom


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_wrap(_value_altered), _wrap(_half_rows),
                                   _wrap(_not_run), _raises],
                         ids=["value_altered", "half_rows_left_out",
                              "step_not_run", "call_raises"])
def test_fault_is_not_correct(bench, cell, fault):
    out = _run(bench, cell, hook=fault)
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_unchanged_state_is_not_correct(bench, cell):
    out = _run(bench, cell, hook=_stale, seconds=0.8)
    assert out["attempted"] >= 2 and not out["correct"]


def test_fault_inside_the_program_is_not_correct(bench, monkeypatch):
    """A value altered where the bucketed engine's warm extraction
    produces it."""
    extract = bucketed.extract_warm

    def bad_extract(plan, slabs):
        col, val = extract(plan, slabs)
        val = val.clone()
        val[0] *= 1 + 1e-8
        return col, val
    monkeypatch.setattr(bucketed, "extract_warm", bad_extract)
    out = _run(bench, "tiny_er.warm")
    assert out["engine"] == "bucketed" and not out["correct"]


@pytest.mark.parametrize("cell", ["tiny_er.warm", "tiny_g500.cold"])
def test_control_is_not_correct(bench, cell):
    out = _run(bench, cell, hook=lambda run: setattr(
        run, "entry", harness.control_entry(run)))
    assert not out["correct"]
    assert out["checks"]["val_gap"]["value"] \
        > 100 * out["checks"]["val_gap"]["limit"]


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "spgemm_bench.run",
                        "--workload", CELL, "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, trace):
    """A short run of the first cell on the card: a result line that is
    correct and holds the cell's metrics."""
    p = subprocess.run([sys.executable, "-m", "spgemm_bench.run",
                        "--workload", CELL, "--seed", "3",
                        "--seconds", "2", "--trace", str(trace)],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    names = {m["name"] for m in harness.cell_metrics(
        fx.real_bench(), CELL, bool(trace))}
    assert set(out["metrics"]) == names
