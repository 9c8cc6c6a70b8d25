"""The port's bucketed planner and device stage against the JAX package.

Planner equality: the port's ``plan_buckets`` must produce the JAX
planner's plan (``precompute=True`` with the fill, planned and grouped
frontends off, the configuration the JAX pipeline runs on a card with
native f64) array for array, with and without the native host library.
Device stage: the port run on a JAX plan (``plan_from_arrays``) gives the
same C as the port run on its own plan.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mh_spgemm_tpu.bench import gen as jgen
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_tpu.utils import native as jnative
from mh_spgemm_torch import CSR, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk
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
    A = gen.tiny_fixture()
    fields = plan_fields(jax_plan(A, A))
    fields["classes"][0] = dict(fields["classes"][0], fill=True)
    with pytest.raises(NotImplementedError):
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
