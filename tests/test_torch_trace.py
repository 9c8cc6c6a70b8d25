"""The port's tracing (``timing.span``, ``PhaseTimer``) and the replan
counters of ``BucketPlan.stats()``, on the CPU.

- With no profiler recording, ``span`` is one shared no-op context and
  never reaches ``torch.profiler.record_function``, in the engines too.
- Under ``torch.profiler``, a bucketed product with ``planned="on"`` on a
  matrix whose demoted class dominates (so the plan is made again)
  records the ``mh::`` ranges of the span tree, each nested under
  ``mh::bucketed``; a warm call records neither planning nor learning.
- ``stats()`` reports ``replanned``, ``replan_share`` and
  ``demoted_classes`` as ``needs_replan`` judged the planned plan.
- ``PhaseTimer`` fills every ``Timing`` field it is given one for, and
  an engine called without one makes none.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm, timing
from mh_spgemm_torch import pipeline
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test workers share the host's cores, and the
    profiler's host cost grows with torch's spinning thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def long_span(n_long_a: int = 3, nshort: int = 40, seed: int = 11):
    """A rows over eight B rows of 4,500 nonzeros each (W = 65536: past
    the planned frontend's chunk cap, so that class is demoted), plus
    ``nshort`` A rows over short B rows.  With few short rows the demoted
    class holds most of the slots and the pipeline replans."""
    rng = np.random.default_rng(seed)
    n, nlong, long = 8000, 8, 4500
    rows = [np.full(long, r) for r in range(nlong)]
    cols = [np.sort(rng.choice(n, long, replace=False))
            for _ in range(nlong)]
    for r in range(nlong, n):
        rows.append(np.full(3, r))
        cols.append(rng.choice(n, 3, replace=False))
    a_rows = [np.full(nlong, i) for i in range(n_long_a)]
    a_cols = [rng.permutation(nlong) for _ in range(n_long_a)]
    for i in range(n_long_a, n_long_a + nshort):
        a_rows.append(np.full(2, i))
        a_cols.append(rng.choice(np.arange(nlong, n), 2, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    a_rows, a_cols = np.concatenate(a_rows), np.concatenate(a_cols)
    B = CSR.from_coo(n, n, rows, cols, rng.standard_normal(rows.size))
    A = CSR.from_coo(n_long_a + nshort, n, a_rows, a_cols,
                     rng.standard_normal(a_rows.size))
    return A, B


def ranges(prof) -> list:
    """(name without ``mh::``, start, end) of the program's host ranges."""
    return [(e.name[len(timing.SPAN_PREFIX):], e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.name.startswith(timing.SPAN_PREFIX)]


def under(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def traced():
    """The replanning product's cold call and a warm call, each under its
    own profiler."""
    A, B = long_span()
    cfg = SpGEMMConfig(planned="on")
    with profile(activities=[ProfilerActivity.CPU]) as cold:
        C, st = pipeline.spgemm_bucketed(A, B, cfg, device=CPU)
    C1 = C.host()
    with profile(activities=[ProfilerActivity.CPU]) as warm:
        C2, _ = pipeline.spgemm_bucketed(A, B, cfg, state=st, device=CPU)
    want = oracle_spgemm(A, B)
    assert C1.equals(want) and C2.host().equals(want)
    return ranges(cold), ranges(warm), st


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    s = timing.span("tail.sort", W=384)
    assert s is timing.span("plan") is timing._NO_SPAN
    with s as inside:
        assert inside is None
    assert timing.PhaseTimer.phase(None, "numeric") is timing._NO_SPAN
    # the engines' own spans, cold and warm, stay off too
    A = gen.banded(200, band=9, nnz_per_row=5, seed=3)
    cfg = SpGEMMConfig(planned="on")
    C, st = pipeline.spgemm_bucketed(A, A, cfg, device=CPU)
    C, _ = pipeline.spgemm_bucketed(A, A, cfg, state=st, device=CPU)
    assert C.host().equals(oracle_spgemm(A, A))


def test_span_args_under_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("tail.kernel", W=256):
            torch.ones(4).add_(1)
    got = [e for e in prof.events() if e.name == "mh::tail.kernel"]
    assert len(got) == 1


@pytest.mark.parametrize("name", [
    "plan", "plan.first", "plan.replan", "symbolic_binning", "mem_alloc",
    "upload", "calculate_c_nnz", "main", "front.gather", "tail.sort",
    "malloc_c_col_val", "learn", "extract.cold", "numeric"])
def test_cold_call_records_span_under_bucketed(traced, name):
    cold, _, _ = traced
    roots = [r for r in cold if r[0] == "bucketed"]
    assert len(roots) == 1
    got = [r for r in cold if r[0] == name]
    assert got and all(under(r, roots[0]) for r in got)


def test_cold_call_span_tree(traced):
    """plan.first and plan.replan sit in plan; front and tail in main;
    learn before the cold extraction, both after the main stage."""
    cold, _, _ = traced
    one = {r[0]: r for r in cold}
    assert under(one["plan.first"], one["plan"])
    assert under(one["plan.replan"], one["plan"])
    assert one["plan.first"][2] <= one["plan.replan"][1]
    for r in cold:
        if r[0].startswith(("front.", "tail.")):
            assert under(r, one["main"])
    assert one["main"][2] <= one["learn"][1]
    assert one["learn"][2] <= one["extract.cold"][1]


def test_warm_call_records_no_plan_and_no_learn(traced):
    _, warm, st = traced
    names = [r[0] for r in warm]
    assert names.count("bucketed") == 1
    root = next(r for r in warm if r[0] == "bucketed")
    assert all(under(r, root) for r in warm)
    for gone in ("plan", "plan.first", "plan.replan", "learn", "upload",
                 "main", "extract.cold"):
        assert gone not in names
    assert sum(n.startswith("extract.") for n in names) == 1
    nclass = len(st.plan.classes)
    assert sum(n.startswith("front.") for n in names) == nclass
    assert sum(n.startswith("tail.") for n in names) == nclass


@pytest.mark.parametrize("planned", ["on", "off"])
def test_tail_and_front_spans_name_the_route(planned):
    """Each class opens one front span named by its frontend and one tail
    span named by the route its slots took (the plan's ``tail_slots``)."""
    A = gen.powerlaw(400, avg_nnz=5, max_row=90, seed=42)
    cfg = SpGEMMConfig(planned=planned)
    _, st = pipeline.spgemm_bucketed(A, A, cfg, device=CPU)
    before = dict(st.plan.tail_slots)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.spgemm_bucketed(A, A, cfg, state=st, device=CPU)
    names = [r[0] for r in ranges(prof)]
    fronts = sorted("front." + c.frontend for c in st.plan.classes)
    assert sorted(n for n in names if n.startswith("front.")) == fronts
    routes = {k for k, v in st.plan.tail_slots.items() if v > before[k]}
    assert {n[len("tail."):] for n in names if n.startswith("tail.")} \
        == routes


@pytest.mark.parametrize("pre", [True, False])
def test_tail_kernel_span_names_the_path(pre, monkeypatch):
    """Each ``tail.kernel`` span carries ``path=``, the kernel's path for
    the class's segment width (``esc_tail.path_for``): ``warp``, ``tile``
    or ``wide``; flat (pre) and slab classes alike."""
    from mh_spgemm_torch.ops import esc_tail as tet
    seen = []

    def record(name, **args):
        seen.append((name, args))
        return timing._NO_SPAN

    monkeypatch.setattr(tbk, "span", record)
    W, rows = 16384, 2
    K = torch.randint(0, 4000, (rows, W), dtype=torch.int32)
    V = torch.randn(rows, W, dtype=torch.float64)
    counts = {"direct": 0, "kernel": 0, "sort": 0}
    for w in (W, 512, 128):
        k, v = K[:, :w].contiguous(), V[:, :w].contiguous()
        if pre:
            tbk._flat_tail(k.reshape(-1), v.reshape(-1), None, W=w,
                           rows=rows, seg_passes=14, route="kernel",
                           counts=counts)
        else:
            tbk.slab_tail(k, v, torch.full((rows,), w, dtype=torch.int32),
                          W=w, seg_passes=14, route="kernel", counts=counts)
    paths = [a["path"] for n, a in seen if n == "tail.kernel"]
    assert paths == ["wide", "tile", "warp"]
    assert paths == [tet.path_for(w) for w in (W, 512, 128)]


def test_spgemm_host_root_holds_route_and_readback():
    A = gen.banded(200, band=9, nnz_per_row=5, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        C = pipeline.spgemm_host(A, None, SpGEMMConfig(mode="auto"),
                                 device=CPU)
    assert C.equals(oracle_spgemm(A, A))
    got = ranges(prof)
    roots = [r for r in got if r[0] == "spgemm_host"]
    assert len(roots) == 1 and all(under(r, roots[0]) for r in got)
    names = {r[0] for r in got}
    assert {"route", "bucketed", "readback"} <= names


@pytest.mark.parametrize("case", ["replan", "demote", "off"])
def test_stats_report_the_replan_decision(case):
    A, B = long_span(n_long_a=1, nshort=40 if case == "replan" else 12000)
    cfg = SpGEMMConfig(planned="off" if case == "off" else "on")
    st = pipeline.prepare_bucketed_state(A, B, cfg, device=CPU)
    got = st.plan.stats()
    if case == "off":
        assert (got["replanned"], got["replan_share"],
                got["demoted_classes"]) == (False, None, 0)
        return
    judged = tbk.plan_buckets(A.ptr, A.col, B.ptr, precompute=True,
                              planned="on", dma_fill="off",
                              min_width=cfg.min_bucket_width,
                              area_cap=cfg.bucket_area_cap)
    share = tbk.replan_share(judged)
    assert got["replanned"] == st.replanned == tbk.needs_replan(judged) \
        == (case == "replan")
    assert got["replan_share"] == round(share, 3)
    assert (share >= tbk._REPLAN_SHARE) == got["replanned"]
    assert got["demoted_classes"] == judged.demoted_classes >= 1
    assert got["demoted_classes"] == sum(
        not c.pre and not c.fill for c in judged.classes if c.W > 1)


def test_phase_timer_fills_every_field():
    t = timing.Timing()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in timing._PHASES:
            with timing.PhaseTimer.phase(t, f):
                time.sleep(0.002)
    assert all(getattr(t, f) >= 1.0 for f in timing._PHASES)
    names = [r[0] for r in ranges(prof)]
    assert names == list(timing._PHASES)


def test_engine_fills_timing_it_is_given():
    A = gen.banded(200, band=9, nnz_per_row=5, seed=3)
    t = timing.Timing()
    C, st = pipeline.spgemm_bucketed(A, A, SpGEMMConfig(), timing=t,
                                     device=CPU)
    for f in ("symbolic_binning", "mem_alloc", "calculate_c_nnz",
              "malloc_c_col_val", "numeric"):
        assert getattr(t, f) > 0.0, f
    before = t.calculate_c_nnz
    pipeline.spgemm_bucketed(A, A, SpGEMMConfig(), timing=t, state=st,
                             device=CPU)
    assert t.calculate_c_nnz > before


def _calls():
    A = gen.banded(200, band=9, nnz_per_row=5, seed=3)
    dA = A.device(torch.float64, pad=True, device=CPU)
    return {
        "bucketed": lambda: pipeline.spgemm_bucketed(A, A, device=CPU),
        "chunked": lambda: pipeline.spgemm_chunked(A, A, device=CPU),
        "blockdense": lambda: pipeline.spgemm_blockdense(A, A, device=CPU),
        "masked": lambda: pipeline.spgemm_masked(A, A, device=CPU),
        "esc": lambda: pipeline.spgemm(dA, dA),
        "product_masked": lambda: pipeline.spgemm(
            dA, dA, SpGEMMConfig(mode="masked")),
        "host": lambda: pipeline.spgemm_host(A, None, device=CPU),
    }


@pytest.mark.parametrize("engine", ["blockdense", "bucketed", "chunked",
                                    "esc", "host", "masked",
                                    "product_masked"])
def test_engine_without_timing_makes_none(engine, monkeypatch):
    class NoTiming:
        def __init__(self, *a, **k):
            raise AssertionError("an engine made a Timing")

    call = _calls()[engine]
    monkeypatch.setattr(pipeline, "Timing", NoTiming)
    monkeypatch.setattr(timing, "Timing", NoTiming)
    call()
