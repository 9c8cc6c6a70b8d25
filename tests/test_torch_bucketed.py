"""The port's bucketed planner and device stage against the JAX package.

Planner equality: the port's ``plan_buckets`` must produce the JAX
planner's plan (``precompute=True`` with the fill, planned and grouped
frontends off, the configuration the JAX pipeline runs on a card with
native f64) array for array, with and without the native host library;
and, with the fill on (port ``dma_fill="on"`` against JAX "interpret",
port "auto" against JAX "auto" with its TPU switch forced on, both
``planar``), with ``precompute`` on and off, array for array again,
run plans, row counts, windowed-extraction plans and fill streams among
the arrays.  Device stage: the port run on a JAX plan
(``plan_from_arrays``) gives the same C as the port run on its own plan;
the fill path gives the JAX package's C and the oracle's under
``CSR.equals`` (1e-9).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import mh_spgemm_tpu as jm
from mh_spgemm_tpu.bench import gen as jgen
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_tpu.ops import ragged_fill as jrf
from mh_spgemm_tpu.pipeline import choose_engine as jchoose
from mh_spgemm_tpu.utils import native as jnative
from mh_spgemm_torch import CSR, SpGEMMConfig, choose_engine, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import esc_tail as tet
from mh_spgemm_torch.ops import ragged_fill as trf
from mh_spgemm_torch.pipeline import BucketedState, spgemm_bucketed
from mh_spgemm_torch.utils import native as tnative

NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "native", "host_runtime.cpp")
CPU = torch.device("cpu")


def empty_rows_dup_cols():
    """A with duplicate columns in a row and entries that reference
    empty B rows, plus an empty A row."""
    rows = [0, 0, 0, 1, 1, 3, 3, 3, 4]
    cols = [1, 1, 2, 4, 0, 2, 5, 5, 3]
    vals = [2.0, 3.0, 1.0, 1.0, -1.0, 0.5, 1.5, 2.5, 4.0]
    return CSR.from_coo(6, 6, rows, cols, vals)      # rows 2, 4.. empty


MATRICES = {
    "tiny_fixture": lambda: gen.tiny_fixture(),
    "banded": lambda: gen.banded(300, band=12, nnz_per_row=6, seed=5),
    "powerlaw": lambda: gen.powerlaw(400, avg_nnz=5, seed=42),
    "random_uniform": lambda: gen.random_uniform(300, nnz_per_row=7,
                                                 seed=9),
    "empty_rows_dup_cols": empty_rows_dup_cols,
}
CLASS_FIELDS = ("W", "rb", "nchunks", "eb", "rows_g", "ent_dst", "ent_src",
                "ent_len", "ent_aidx", "hold_passes", "seg_passes",
                "slot_src", "slot_aidx")


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The native host library built from the repository's source into a
    temporary directory (skips where g++ is missing)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the native library")
    out = str(tmp_path_factory.mktemp("native") / "libmhspgemm_host.so")
    subprocess.run([gxx, "-O2", "-fopenmp", "-shared", "-fPIC", "-o", out,
                    NATIVE_SRC], check=True)
    return out


@pytest.fixture(params=["numpy", "native"])
def builder(request, monkeypatch):
    """Select the descriptor builder in both packages."""
    if request.param == "native":
        path = request.getfixturevalue("native_lib")
        tlib = tnative.load(path)
        monkeypatch.setenv("MHSPGEMM_NATIVE_LIB", path)
        monkeypatch.setattr(jnative, "_TRIED", False)
        monkeypatch.setattr(jnative, "_LIB", None)
        assert jnative.available()
    else:
        tlib = None
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)
    monkeypatch.setattr(tnative, "_LIB", tlib)
    return request.param


def jax_plan(A, B, area_cap=1 << 23, vwords=2):
    return jbk.plan_buckets(A.ptr, A.col, B.ptr, min_width=2,
                            area_cap=area_cap, vwords=vwords,
                            dma_fill="off", group="off", precompute=True,
                            planned="off")


def plan_fields(p) -> dict:
    """A JAX BucketPlan's numpy fields, as plan_from_arrays takes them."""
    return {"m": p.m, "m_cap": p.m_cap, "intprod": p.intprod,
            "slab_row_start": p.slab_row_start,
            "classes": [vars(c) for c in p.classes]}


def assert_plans_equal(tp, jp):
    assert (tp.m, tp.m_cap, tp.intprod) == (jp.m, jp.m_cap, jp.intprod)
    assert np.array_equal(tp.slab_row_start, jp.slab_row_start)
    assert len(tp.classes) == len(jp.classes)
    for tc, jc in zip(tp.classes, jp.classes):
        assert jc.pre and not jc.fill and not jc.pf and jc.G == 1
        for f in CLASS_FIELDS:
            a, b = getattr(tc, f), getattr(jc, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_planner_matches_jax(name, builder):
    A = MATRICES[name]()
    assert_plans_equal(tbk.plan_buckets(A.ptr, A.col, A.ptr),
                       jax_plan(A, A))


@pytest.mark.parametrize("vwords,area_cap", [(2, 1 << 10), (1, 1 << 12)])
def test_planner_matches_jax_chunked(vwords, area_cap, builder):
    """Small area caps cut classes into several chunks."""
    A = gen.powerlaw(500, avg_nnz=6, seed=3)
    B = A.transpose()
    assert_plans_equal(
        tbk.plan_buckets(A.ptr, A.col, B.ptr, area_cap=area_cap,
                         vwords=vwords),
        jax_plan(A, B, area_cap=area_cap, vwords=vwords))


def test_generators_feed_both_planners_alike():
    """The JAX generator's matrix and the port's are the same input."""
    J = jgen.powerlaw(400, avg_nnz=5, seed=42)
    T = gen.powerlaw(400, avg_nnz=5, seed=42)
    assert isinstance(J, JCSR)
    assert np.array_equal(J.ptr, T.ptr) and np.array_equal(J.col, T.col)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_device_stage_on_jax_plan(name):
    """The port's device stage on a JAX plan rebuilt by plan_from_arrays
    equals the port on its own plan (cold and warm), and the oracle."""
    A = MATRICES[name]()
    ref = oracle_spgemm(A, A)
    own, state = spgemm_bucketed(A, A, device="cpu")
    plan = tbk.plan_from_arrays(plan_fields(jax_plan(A, A)))
    st = BucketedState(plan=plan, device=CPU, route="kernel")
    for _ in range(2):
        C, st = spgemm_bucketed(A, A, state=st)
        assert C.host().equals(own.host(), tol=0.0)
        assert C.host().equals(ref, tol=1e-9)


def test_plan_from_arrays_rejects_other_frontends():
    """Grouped classes and interleaved fill classes are not ported; fill,
    gather and planned classes are (see the fill tests and
    tests/test_torch_planned.py), and a planned class without its
    schedules is refused."""
    A = gen.tiny_fixture()
    for extra, err in (({"pf": True}, ValueError),
                       ({"G": 2}, NotImplementedError),
                       ({"fill": True}, NotImplementedError)):
        fields = plan_fields(jax_plan(A, A))
        fields["classes"][0] = dict(fields["classes"][0], **extra)
        with pytest.raises(err):
            tbk.plan_from_arrays(fields)


def test_wide_class_takes_the_sort_tail():
    """A row with more than 65536 products has a class wider than the
    kernel takes: it routes to the sort tail by width."""
    rng = np.random.default_rng(0)
    n = 300
    rows = np.repeat(np.arange(n), n)
    cols = np.tile(np.arange(n), n)
    B = CSR.from_coo(n, n, rows, cols, rng.standard_normal(n * n))
    A = CSR.from_coo(2, n, np.r_[np.zeros(n, int), 1], np.r_[np.arange(n), 0],
                     rng.standard_normal(n + 1))
    C, state = spgemm_bucketed(A, B, device="cpu")
    assert [c.W for c in state.plan.classes] == [512, 131072]
    wide = state.plan.classes[1]
    assert state.plan.tail_slots["sort"] == wide.W * wide.rb * wide.nchunks
    assert state.plan.tail_slots["kernel"] > 0
    assert C.host().equals(oracle_spgemm(A, B), tol=1e-9)


def test_warm_plan_from_crow_matches_first_run():
    A = gen.powerlaw(300, avg_nnz=5, seed=13)
    _, state = spgemm_bucketed(A, A, device="cpu")
    fresh = tbk.plan_buckets(A.ptr, A.col, A.ptr)
    tbk.warm_plan_from_crow(fresh, state.plan.crow_h)
    for f in ("class_caps", "nnz_c", "nnz_cap"):
        assert getattr(fresh, f) == getattr(state.plan, f)
    assert np.array_equal(fresh.ext_src_h, state.plan.ext_src_h)
    assert np.array_equal(fresh.cptr_h, state.plan.cptr_h)
    # the warm-started plan's first call takes the warm path and is right
    st = BucketedState(plan=fresh, device=CPU, route="kernel")
    C, _ = spgemm_bucketed(A, A, state=st)
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)


# ---------------------------------------------------------------------------
# The fill frontend, the gather frontend and the windowed extraction
# ---------------------------------------------------------------------------

FILL_MATRICES = {
    "tiny_fixture": lambda: gen.tiny_fixture(),
    "banded": lambda: gen.banded(150, band=12, nnz_per_row=6, seed=5),
    "powerlaw": lambda: gen.powerlaw(160, avg_nnz=5, max_row=60, seed=42),
}
FILL_FIELDS = CLASS_FIELDS + ("fill", "stride", "wrows", "out_rows",
                              "win_row", "runs", "row_len", "pre")
# port dma_fill -> (JAX dma_fill, JAX TPU switch)
FILL_MODES = {"on": ("interpret", False), "auto": ("auto", True),
              "off": ("off", False)}


@pytest.fixture
def jax_tpu_switch(monkeypatch):
    """Set the JAX planner's TPU switch (its gate of dma_fill="auto")."""
    def set_switch(on: bool):
        monkeypatch.setattr(jrf, "on_tpu", lambda: on)
    return set_switch


def jax_fill_plan(A, B, mode, precompute, vwords=2, area_cap=1 << 23):
    return jbk.plan_buckets(A.ptr, A.col, B.ptr, min_width=2,
                            area_cap=area_cap, vwords=vwords,
                            dma_fill=mode, planar=True, group="off",
                            precompute=precompute, planned="off")


def assert_fill_plans_equal(tp, jp):
    assert (tp.m, tp.m_cap, tp.intprod) == (jp.m, jp.m_cap, jp.intprod)
    assert np.array_equal(tp.slab_row_start, jp.slab_row_start)
    assert [c.W for c in tp.classes] == [c.W for c in jp.classes]
    for tc, jc in zip(tp.classes, jp.classes):
        assert jc.planar == jc.fill            # the port's streams are planar
        for f in FILL_FIELDS:
            a, b = getattr(tc, f), getattr(jc, f)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f


@pytest.mark.parametrize("precompute", [True, False], ids=["pre", "legacy"])
@pytest.mark.parametrize("mode", sorted(FILL_MODES))
@pytest.mark.parametrize("name", sorted(FILL_MATRICES))
def test_fill_planner_matches_jax(name, mode, precompute, jax_tpu_switch):
    A = FILL_MATRICES[name]()
    jmode, tpu = FILL_MODES[mode]
    jax_tpu_switch(tpu)
    for vwords, area_cap in ((2, 1 << 23), (1, 1 << 11)):
        tp = tbk.plan_buckets(A.ptr, A.col, A.ptr, area_cap=area_cap,
                              vwords=vwords, dma_fill=mode,
                              precompute=precompute)
        jp = jax_fill_plan(A, A, jmode, precompute, vwords, area_cap)
        assert_fill_plans_equal(tp, jp)
        assert tbk.needs_pairs(tp) == jbk.needs_pairs(jp)
        if mode == "on":
            assert all(c.fill for c in tp.classes)
        if mode == "off":
            assert all(c.frontend == ("pre" if precompute else "gather")
                       for c in tp.classes)


def test_fill_auto_needs_long_spans(jax_tpu_switch):
    """Under "auto" the dense band's long spans fill, the powerlaw's short
    spans keep the precomputed slots, as in the JAX planner."""
    jax_tpu_switch(True)
    D = gen.banded(256, band=40, nnz_per_row=40, seed=3)
    P = gen.powerlaw(300, avg_nnz=3, max_row=20, seed=4)
    fr = {n: [c.frontend for c in tbk.plan_buckets(
        X.ptr, X.col, X.ptr, dma_fill="auto").classes]
        for n, X in (("dense", D), ("powerlaw", P))}
    assert "fill" in fr["dense"] and "fill" not in fr["powerlaw"]
    for X in (D, P):
        assert_fill_plans_equal(
            tbk.plan_buckets(X.ptr, X.col, X.ptr, dma_fill="auto"),
            jax_fill_plan(X, X, "auto", True))


@pytest.mark.parametrize("vwords", [2, 1])
def test_pairs_planar_matches_jax(vwords):
    A = gen.powerlaw(120, avg_nnz=4, seed=6)
    vals = A.val.astype(np.float64 if vwords == 2 else np.float32)
    assert np.array_equal(tbk.build_pairs_planar(A.col, vals, vwords, 32),
                          jbk.build_pairs_planar(A.col, vals, vwords, 32))


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("nplanes", [3, 2])
@pytest.mark.parametrize("name", ["banded", "powerlaw", "dense_band"])
def test_build_extract_plan_matches_jax(name, nplanes, force):
    A = (gen.banded(256, band=40, nnz_per_row=40, seed=3)
         if name == "dense_band" else FILL_MATRICES[name]())
    plan = tbk.plan_buckets(A.ptr, A.col, A.ptr)
    crow = np.diff(oracle_spgemm(A, A).ptr).astype(np.int32)
    area = sum(c.W * c.rb * c.nchunks for c in plan.classes)
    kw = dict(area=area, nplanes=nplanes, force=force)
    te = tbk.build_extract_plan(crow, plan.slab_row_start, **kw)
    je = jbk.build_extract_plan(crow, plan.slab_row_start, **kw)
    assert (te is None) == (je is None)
    if force:
        assert te is not None
    if te is not None:
        for f in ("nplanes", "nchunks", "cap_slots", "wrows", "area_pad"):
            assert getattr(te, f) == getattr(je, f), f
        assert np.array_equal(te.win_row, je.win_row)
        assert np.array_equal(te.runs, je.runs)


@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_estimate_cost_with_fill_matches_jax(value_dtype, jax_tpu_switch):
    """On a CUDA device the cost model prices long-span classes at the
    fill frontend's cost, as the JAX package does on the TPU, and
    choose_engine picks as the JAX package's would there."""
    jax_tpu_switch(True)
    vw = 2 if value_dtype == "float64" else 1
    cfg = SpGEMMConfig(value_dtype=value_dtype)
    jcfg = jm.SpGEMMConfig(value_dtype=value_dtype, ozaki="interpret")
    for A in (gen.banded(512, band=60, nnz_per_row=60, seed=3),
              gen.powerlaw(400, avg_nnz=5, max_row=80, seed=5)):
        assert tbk.estimate_cost_s(A.ptr, A.col, A.ptr, min_width=2,
                                   vwords=vw, fill=True) == \
            jbk.estimate_cost_s(A.ptr, A.col, A.ptr, min_width=2, vwords=vw)
        J = JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col, val=A.val)
        assert choose_engine(A, A, cfg, device="cuda") == jchoose(J, J, jcfg)


def jax_bucketed(A, B, value_dtype: str):
    """JAX spgemm_host on the bucketed engine with the fill forced
    (interpreter mode)."""
    cfg = jm.SpGEMMConfig(mode="bucketed", value_dtype=value_dtype,
                          dma_fill="interpret", planned="off")
    return jm.spgemm_host(JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col,
                               val=A.val),
                          JCSR(M=B.M, N=B.N, ptr=B.ptr, col=B.col,
                               val=B.val), config=cfg)


@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["banded", "powerlaw", "rect"])
def test_fill_path_matches_jax_and_oracle(name, value_dtype):
    """spgemm_bucketed with every class on the fill frontend and the
    windowed extraction, cold then warm: C equals the JAX package's
    (fill forced, interpreter mode) and the oracle's."""
    if name == "rect":
        rng = np.random.default_rng(7)
        A = CSR.from_coo(90, 120, rng.integers(0, 90, 500),
                         rng.integers(0, 120, 500), rng.standard_normal(500),
                         sum_duplicates=True)
        B = CSR.from_coo(120, 70, rng.integers(0, 120, 900),
                         rng.integers(0, 70, 900), rng.standard_normal(900),
                         sum_duplicates=True)
    else:
        A = FILL_MATRICES[name]()
        B = A
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    cfg = SpGEMMConfig(value_dtype=value_dtype, dma_fill="on")
    ref = oracle_spgemm(A, B)
    J = jax_bucketed(A, B, value_dtype)
    before = (trf.ragged_fill.launches, tet.esc_tail.launches)
    state = None
    for call in range(3):
        C, state = spgemm_bucketed(A, B, config=cfg, state=state,
                                   device="cpu")
        H = C.host()
        assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
        assert H.equals(J, tol=tol) and H.equals(ref, tol=tol), call
    plan = state.plan
    assert all(c.fill for c in plan.classes) and plan.ext is not None
    assert plan.tail_slots["kernel"] > 0
    assert (trf.ragged_fill.launches, tet.esc_tail.launches) == before


@pytest.mark.parametrize("esc_tail", ["auto", "off"])
def test_fill_tail_routing(esc_tail):
    """Pow2 fill classes take the slab tail kernel unless esc_tail="off"
    selects the sort tail."""
    A = FILL_MATRICES["powerlaw"]()
    C, state = spgemm_bucketed(
        A, A, config=SpGEMMConfig(dma_fill="on", esc_tail=esc_tail),
        device="cpu")
    slots = state.plan.tail_slots
    route, other = (("kernel", "sort") if esc_tail == "auto"
                    else ("sort", "kernel"))
    assert slots[route] > 0 and slots[other] == 0
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)


@pytest.mark.parametrize("precompute", [True, False], ids=["pre", "legacy"])
def test_device_stage_on_jax_fill_plan(precompute, jax_tpu_switch):
    """The port's device stage on a JAX plan with fill classes (forced)
    and, without precompute, gather classes, carried across by
    plan_from_arrays: the port's own C."""
    A = FILL_MATRICES["powerlaw"]()
    ref = oracle_spgemm(A, A)
    for jmode in ("interpret", "off"):
        jp = jax_fill_plan(A, A, jmode, precompute)
        fields = plan_fields(jp)
        fields.update(dma_fill=jp.dma_fill, vwords=jp.vwords)
        plan = tbk.plan_from_arrays(fields)
        assert [c.frontend for c in plan.classes] == [
            "fill" if c.fill else "pre" if c.pre else "gather"
            for c in jp.classes]
        st = BucketedState(plan=plan, device=CPU, route="kernel")
        if tbk.needs_pairs(plan):
            st.pairs = torch.from_numpy(tbk.build_pairs_planar(
                A.col, A.val, 2, tbk.pairs_wrows_max(plan)))
        cfg = SpGEMMConfig(dma_fill="on" if jmode == "interpret" else "off")
        for _ in range(2):
            C, st = spgemm_bucketed(A, A, config=cfg, state=st)
            assert C.host().equals(ref, tol=1e-9)


def test_warm_plan_from_crow_plans_the_windowed_extraction():
    A = FILL_MATRICES["banded"]()
    cfg = SpGEMMConfig(dma_fill="on")
    _, state = spgemm_bucketed(A, A, config=cfg, device="cpu")
    fresh = tbk.plan_buckets(A.ptr, A.col, A.ptr, dma_fill="on")
    tbk.warm_plan_from_crow(fresh, state.plan.crow_h)
    assert fresh.ext is not None
    assert np.array_equal(fresh.ext.runs, state.plan.ext.runs)
    st = BucketedState(plan=fresh, device=CPU, route="kernel",
                       pairs=state.pairs)
    C, _ = spgemm_bucketed(A, A, config=cfg, state=st)
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)
