"""The port's suite runner (``bench/suite.py``), ``run_matrix``'s
``mode=``, ``state=`` and ``digest=``, the plan cache
(``bench/plan_cache.py``), ``io/suites.matrix408_list``, the standalone
``ops/mask`` pieces and ``utils/native.intprod``, on the CPU.

- ``matrix408_list`` reads ``$MATRIX408_LIST`` as the JAX package's does
  and raises FileNotFoundError without it.
- ``run_matrix(..., digest=True)``: the device digest of C equals
  ``digest_host`` of the oracle's C (structure exact, values under
  ``digest_check`` at 1e-9) for each engine; a caller's engine and state
  skip planning and the state learns in place.
- Plan cache, bucketed and block-dense, in a ``tmp_path`` named by
  ``$MHSPGEMM_PLAN_CACHE``: a fresh state warmed from the saved record has
  the learned ``crow_h`` and capacities before its first call, whose C
  equals the oracle; a corrupt or foreign record is a miss.
- The suite runner on one small ``.mtx`` with its oracle digest cache in
  ``tmp_path``: the check passes (the oracle computed on the first run,
  read from the cache on the second, when the plan cache hits); a member
  that raises is recorded with its error and fails the run; the summary
  wears the 16-member metric name only for all 16.
- ``count_tiles``, ``form_mask_matrix``, ``flops_upper_bound`` and
  ``flops_exact`` equal the JAX package's (as ``tests/test_mask.py``
  checks those), and ``native.intprod`` equals ``CSR.intprod``.
"""

import json
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mh_spgemm_tpu.bench import gen as jgen
from mh_spgemm_tpu.io import suites as jsuites
from mh_spgemm_tpu.ops import mask as jmask
from mh_spgemm_torch import SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.baseline import digest_check, digest_host
from mh_spgemm_torch.bench import gen, plan_cache, suite
from mh_spgemm_torch.bench.driver import run_matrix
from mh_spgemm_torch.io import suites
from mh_spgemm_torch.io.mmio import write_mtx
from mh_spgemm_torch.ops import mask as tmask
from mh_spgemm_torch.pipeline import (prepare_blockdense_state,
                                      prepare_bucketed_state,
                                      spgemm_blockdense, spgemm_bucketed)
from mh_spgemm_torch.utils import native as tnative

NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "native", "host_runtime.cpp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' torch ops run on one thread here: the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small():
    return gen.banded(300, band=12, nnz_per_row=6, seed=5)


# -- matrix408_list ---------------------------------------------------------

def test_matrix408_list(tmp_path, monkeypatch):
    monkeypatch.delenv("MATRIX408_LIST", raising=False)
    with pytest.raises(FileNotFoundError):
        suites.matrix408_list()
    monkeypatch.setenv("MATRIX408_LIST", str(tmp_path / "missing.txt"))
    with pytest.raises(FileNotFoundError):
        suites.matrix408_list()
    path = tmp_path / "list.txt"
    path.write_text("cant\n\n  pdb1HYS \nscircuit\n")
    monkeypatch.setenv("MATRIX408_LIST", str(path))
    assert suites.matrix408_list() == ["cant", "pdb1HYS", "scircuit"]
    assert suites.matrix408_list() == jsuites.matrix408_list()


# -- run_matrix -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bucketed", "blockdense", "masked", "esc"])
def test_run_matrix_digest_equals_the_oracles(mode):
    A = small()
    res = run_matrix(A, "small", SpGEMMConfig(mode=mode), iters=1,
                     warmup=1, verbose=False, device="cpu", digest=True)
    assert not res.failed and res.error is None
    want = digest_host(oracle_spgemm(A, A))
    for k in ("nnz", "hptr", "hcol"):
        assert res.digest[k] == want[k], k
    assert digest_check(res.digest, want, tol=1e-9) == (True, "pass")


def test_run_matrix_takes_the_callers_engine_and_state():
    A = small()
    cfg = SpGEMMConfig(mode="auto")
    state = prepare_bucketed_state(A, A, cfg, device="cpu")
    assert state.plan.crow_h is None
    res = run_matrix(A, "small", cfg, iters=1, warmup=1, verbose=False,
                     device="cpu", mode="bucketed", state=state)
    assert res.stats["engine"] == "bucketed"
    assert state.plan.crow_h is not None          # learned in place
    assert res.digest is None


def test_run_matrix_records_the_error():
    A = small()
    cfg = SpGEMMConfig(mode="bucketed")
    state = prepare_bucketed_state(A, A, SpGEMMConfig(planned="on"),
                                   device="cpu")
    res = run_matrix(A, "small", cfg, iters=1, warmup=1, verbose=False,
                     device="cpu", mode="bucketed", state=state)
    assert res.failed and res.gflops == 0.0
    assert res.error.startswith("SpGEMMError")


# -- plan cache -------------------------------------------------------------

ENGINES = {"bucketed": (prepare_bucketed_state, spgemm_bucketed),
           "blockdense": (prepare_blockdense_state, spgemm_blockdense)}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_plan_cache_round_trip(engine, tmp_path, monkeypatch):
    monkeypatch.setenv("MHSPGEMM_PLAN_CACHE", str(tmp_path))
    prep, run = ENGINES[engine]
    A = small()
    cfg = SpGEMMConfig(mode=engine)
    ref = oracle_spgemm(A, A)
    cold = prep(A, A, cfg, device="cpu")
    assert not plan_cache.try_warm(cold, "small", A, engine, cfg)
    assert plan_cache.save(cold, "small", A, engine, cfg) is None  # not run
    C, cold = run(A, A, config=cfg, state=cold, device="cpu")
    path = plan_cache.save(cold, "small", A, engine, cfg)
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    assert plan_cache.save(cold, "small", A, engine, cfg) is None  # kept

    warm = prep(A, A, cfg, device="cpu")
    assert plan_cache.try_warm(warm, "small", A, engine, cfg)
    assert np.array_equal(warm.plan.crow_h, cold.plan.crow_h)
    assert warm.plan.nnz_c == cold.plan.nnz_c == ref.nnz
    assert warm.plan.nnz_cap == cold.plan.nnz_cap
    if engine == "bucketed":
        assert warm.plan.class_caps == cold.plan.class_caps
    else:
        assert (warm.plan.ext_area, warm.plan.ext_nplanes) == \
            (cold.plan.ext_area, cold.plan.ext_nplanes)
    C, warm = run(A, A, config=cfg, state=warm, device="cpu")
    assert C.host().equals(ref, tol=1e-9)

    # another config, name or engine keys another record
    other = prep(A, A, cfg, device="cpu")
    assert not plan_cache.try_warm(other, "other", A, engine, cfg)
    f32 = SpGEMMConfig(mode=engine, value_dtype="float32")
    assert not plan_cache.try_warm(prep(A, A, f32, device="cpu"), "small",
                                   A, engine, f32)
    # a corrupt record is a miss, never a failure
    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert not plan_cache.try_warm(other, "small", A, engine, cfg)
    # so is a record of another matrix's rows
    np.savez(path, crow=np.zeros(3, np.int32), ext_area=np.int64(1),
             ext_nplanes=np.int64(3))
    assert not plan_cache.try_warm(other, "small", A, engine, cfg)


def test_plan_cache_keys_name_the_port():
    A = small()
    cfg = SpGEMMConfig()
    k = plan_cache.cache_key("small", A, "bucketed", cfg, "cpu")
    assert k != plan_cache.cache_key("small", A, "bucketed", cfg, "cuda")
    assert k != plan_cache.cache_key(
        "small", A, "bucketed", SpGEMMConfig(planned="on"), "cpu")
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "data", "plan_cache")
    assert os.path.abspath(data) not in map(os.path.abspath,
                                            plan_cache._dirs())


# -- the suite runner -------------------------------------------------------

def test_suite_on_a_small_mtx(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MHSPGEMM_ORACLE_CACHE", str(tmp_path / "oc.json"))
    monkeypatch.setenv("MHSPGEMM_PLAN_CACHE", str(tmp_path / "plans"))
    mtx = str(tmp_path / "small.mtx")
    write_mtx(mtx, small())
    out = str(tmp_path / "summary.json")
    args = ["--matrices", mtx, "--masked", mtx, "--iters", "1", "--device",
            "cpu", "--out", out]
    rows = []
    for _ in range(2):
        assert suite.main(args) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        member, summ = json.loads(lines[0]), json.loads(lines[-1])
        rows.append(member)
        assert member["member"] == "small" and member["check"] == "pass"
        assert member["intprod"] == small().intprod(small())
        assert summ["verified"] == 1 and summ["check_failures"] == []
        assert summ["metric"] == "spgemm_gflops_geomean_partial"
        assert summ["partial"] and summ["value"] > 0
        assert list(summ)[-4:] == ["metric", "value", "unit",
                                   "vs_baseline"]
        assert "error" not in summ["masked"]["small"]
        with open(out) as f:
            assert json.load(f) == summ
    assert [r["oracle_source"] for r in rows] == ["computed", "cache"]
    assert [r["plan_cache"] for r in rows] == ["miss", "hit"]
    nnz = small().nnz
    with open(tmp_path / "oc.json") as f:
        assert list(json.load(f)) == [f"small:300:{nnz}:{nnz}"]


def test_suite_records_a_member_that_raises(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MHSPGEMM_ORACLE_CACHE", str(tmp_path / "oc.json"))
    missing = str(tmp_path / "missing.mtx")
    rc = suite.main(["--matrices", missing, "--masked", "", "--device",
                     "cpu", "--out", str(tmp_path / "s.json")])
    summ = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    row = summ["detail"][missing]
    assert row["error"] and row["check"].startswith("error: ")
    assert summ["check_failures"] == [missing] and summ["verified"] == 0


def test_suite_metric_names_only_the_full_sixteen():
    row = {"gflops": 2.0, "oracle_gflops": 1.0, "check": "pass"}
    full = {name: dict(row) for name in suite.ORDER}
    s = suite.summary(full, [], {}, final=True)
    assert s["metric"] == "spgemm_gflops_geomean_16" and not s["partial"]
    assert s["value"] == pytest.approx(2.0)
    assert s["vs_baseline"] == pytest.approx(2.0)
    del full["cage15"]
    s = suite.summary(full, [], {}, final=True)
    assert s["metric"] == "spgemm_gflops_geomean_partial" and s["partial"]
    s = suite.summary({n: dict(row) for n in suite.ORDER}, [], {},
                      final=False)
    assert s["partial"]


def test_suite_members_are_the_sixteen():
    assert sorted(suite.ORDER) == sorted(suites.SIXTEEN_MATRICES)
    with open(suite.REPO_DIGESTS) as f:
        digests = json.load(f)
    names = {k.split(":")[0] for k in digests}
    assert names == set(suites.SIXTEEN_MATRICES)


# -- the standalone mask pieces and native.intprod ---------------------------

MASK_MATRICES = {
    "tiny_fixture": (gen.tiny_fixture, jgen.tiny_fixture, {}),
    "banded": (gen.banded, jgen.banded,
               dict(n=300, band=40, nnz_per_row=9, seed=3)),
    "random": (gen.random_uniform, jgen.random_uniform,
               dict(n=257, nnz_per_row=7, seed=5)),
    "powerlaw": (gen.powerlaw, jgen.powerlaw,
                 dict(n=400, avg_nnz=6, seed=11)),
}


@pytest.mark.parametrize("name", sorted(MASK_MATRICES))
def test_mask_pieces_match_jax(name):
    tgen, jgen_, kw = MASK_MATRICES[name]
    A, J = tgen(**kw), jgen_(**kw)
    tp, tc = (torch.from_numpy(x.astype(np.int32)) for x in (A.ptr, A.col))
    jp, jc = (jnp.asarray(x.astype(np.int32)) for x in (J.ptr, J.col))
    ttpr, ttot = tmask.count_tiles(tp, tc, A.M, A.nnz)
    jtpr, jtot = jmask.count_tiles(jp, jc, J.M, J.nnz)
    assert np.array_equal(ttpr.numpy(), np.asarray(jtpr))
    assert int(ttot) == int(jtot)
    tm = tmask.form_mask_matrix(tp, tc, A.M, A.nnz, int(ttot))
    jm_ = jmask.form_mask_matrix(jp, jc, J.M, J.nnz, int(jtot))
    for f in ("tileptr", "tilecol", "nnz_to_tile"):
        assert np.array_equal(getattr(tm, f).numpy(),
                              np.asarray(getattr(jm_, f))), f
    assert np.array_equal(tm.tilemask.numpy().view(np.uint32),
                          np.asarray(jm_.tilemask))
    assert tm.tilecol.shape[0] == int(ttot)
    fub = tmask.flops_upper_bound(tp, tc, ttpr, A.nnz)
    assert np.array_equal(fub.numpy(), np.asarray(
        jmask.flops_upper_bound(jp, jc, jtpr, J.nnz)))
    ex = tmask.flops_exact(tp, tc, tp, A.nnz)
    assert np.array_equal(ex.numpy(), np.asarray(
        jmask.flops_exact(jp, jc, jp, J.nnz)))
    assert int(ex.sum()) == A.intprod(A)


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


def test_native_intprod(native_lib, monkeypatch):
    A = gen.random_uniform(300, nnz_per_row=6, seed=88)
    monkeypatch.setattr(tnative, "_TRIED", True)
    monkeypatch.setattr(tnative, "_LIB", None)
    assert tnative.intprod(A.col, A.ptr) is None         # no library
    monkeypatch.setattr(tnative, "_LIB", tnative.load(native_lib))
    assert tnative.intprod(A.col, A.ptr) == A.intprod(A)
    B = gen.banded(300, band=12, nnz_per_row=5, seed=2)
    assert tnative.intprod(A.col, B.ptr) == A.intprod(B)
