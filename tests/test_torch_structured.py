"""The port's structured catalog (``bench/structured.py``) and soak
(``bench/soak.py``), and the two repaired faults, against the JAX package
on the CPU.

- Catalog: every one of the 400 cases equals the JAX package's bit for
  bit (shapes, ptr, col, val and their dtypes, and whether B is A).
- The class-based masked engine on ``rect_tall(0)`` (B is 8 x 200, wider
  than it is tall, and the engine passes B as both operands of
  ``mask_stage``): ``spgemm_host(mode="masked")`` and ``spgemm_masked``,
  cold and warm, equal the JAX package's masked C and the oracle, 1e-9 in
  f64 and 1e-4 in f32; ``mask_stage``'s ``fub_row`` and ``prod_row`` on
  (B, B) equal JAX's, whose gathers clamp.
- The planned planner on ``diag_full_row(6)`` and ``rect_tall(9)``, whose
  chunks would clone a window row 64 times or more: under
  ``planned="on"``, cold and warm, C equals the oracle (the JAX planner
  asserts there, so the oracle is the only reference), and
  ``plan_pgather`` returns None where the JAX scheduler asserts.
- Soak: ``run_cases`` over every 25th case of each family, with the
  repaired cases, through the five engines with no failure; the repaired
  cases cold and warm in f64 and f32 (``run_repaired``); and on six cases
  the default engine's C equals the JAX package's ``spgemm_host`` C.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_spgemm_tpu as jm
from mh_spgemm_tpu.bench import structured as jst
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import mask as jmask
from mh_spgemm_tpu.ops import planned as jpn
from mh_spgemm_tpu.pipeline import prepare_bucketed_state as jprepare
from mh_spgemm_torch import SpGEMMConfig, oracle_spgemm, spgemm_host
from mh_spgemm_torch.bench import soak, structured
from mh_spgemm_torch.ops import mask as tmask
from mh_spgemm_torch.ops import planned as tpn
from mh_spgemm_torch.pipeline import spgemm_bucketed, spgemm_masked

TOL = {"float64": 1e-9, "float32": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' torch ops run on one thread here: the test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcsr(X) -> JCSR:
    return JCSR(M=X.M, N=X.N, ptr=X.ptr, col=X.col, val=X.val)


def same_array(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("family", sorted(structured.FAMILIES))
def test_catalog_matches_jax(family):
    assert structured.FAMILIES[family][1] == jst.FAMILIES[family][1]
    count = structured.FAMILIES[family][1]
    assert [c for c in structured.catalog() if c[0] == family] == \
        [(family, i) for i in range(count)]
    for i in range(count):
        tA, tB = structured.make_case(family, i)
        jA, jB = jst.make_case(family, i)
        assert (tB is tA) == (jB is jA), (family, i)
        for t, j in ((tA, jA), (tB, jB)):
            assert (t.M, t.N) == (j.M, j.N), (family, i)
            for f in ("ptr", "col", "val"):
                assert same_array(getattr(t, f), getattr(j, f)), \
                    (family, i, f)
    assert structured.catalog() == jst.catalog()


# -- the masked engine on a B wider than it is tall -------------------------

@functools.lru_cache(maxsize=None)
def jax_masked_rect_tall0(value_dtype: str):
    A, B = structured.make_case("rect_tall", 0)
    cfg = jm.SpGEMMConfig(mode="masked", value_dtype=value_dtype,
                          dma_fill="off")
    return jm.spgemm_host(jcsr(A), jcsr(B), config=cfg)


def test_rect_tall0_mask_stage_matches_jax():
    _, B = structured.make_case("rect_tall", 0)
    assert B.N > B.M                       # B's columns pass its rows
    t = tmask.mask_stage(*(torch.from_numpy(x.astype(np.int32))
                           for x in (B.ptr, B.col, B.ptr, B.col)))
    j = jmask.mask_stage(*(jnp.asarray(x.astype(np.int32))
                           for x in (B.ptr, B.col, B.ptr, B.col)))
    for f in ("fub_row", "prod_row", "totals", "max_arow"):
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f))), f
    assert np.array_equal(t.mask.tilemask.numpy().view(np.uint32),
                          np.asarray(j.mask.tilemask))


@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_rect_tall0_masked_matches_jax_and_oracle(value_dtype):
    A, B = structured.make_case("rect_tall", 0)
    tol = TOL[value_dtype]
    cfg = SpGEMMConfig(mode="masked", value_dtype=value_dtype)
    J = jax_masked_rect_tall0(value_dtype)
    ref = oracle_spgemm(A, B)
    H = spgemm_host(A, B, config=cfg, device="cpu")
    assert H.equals(J, tol=tol) and H.equals(ref, tol=tol)
    state = None
    for call in range(3):                       # cold, then warm
        C, state = spgemm_masked(A, B, config=cfg, state=state,
                                 device="cpu")
        H = C.host()
        assert H.val.dtype == np.dtype(value_dtype)
        assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
        assert H.equals(J, tol=tol) and H.equals(ref, tol=tol), call


# -- the planned planner's clone cap ----------------------------------------

def test_plan_pgather_declines_where_jax_asserts():
    src = np.full(64 * 128 + 1, 5, np.int64)    # one window row, 65 copies
    assert tpn.plan_pgather(src, 0) is None
    with pytest.raises(AssertionError):
        jpn.plan_pgather(src, 0)
    below = src[:-1]                            # 64 copies: still planned
    for a, b in zip(tpn.plan_pgather(below, 0), jpn.plan_pgather(below, 0)):
        assert same_array(a, b)


@pytest.mark.parametrize("case", [("diag_full_row", 6), ("rect_tall", 9)])
def test_planned_on_past_the_clone_cap(case, monkeypatch):
    A, B = structured.make_case(*case)
    cfg = SpGEMMConfig(planned="on")
    with pytest.raises(AssertionError):         # the reference's fault
        jprepare(jcsr(A), jcsr(B), jm.SpGEMMConfig(
            mode="bucketed", planned="interpret", df32="on"))
    declined = []
    plan_pgather = tpn.plan_pgather

    def spy(src, table_words):
        got = plan_pgather(src, table_words)
        declined.append(got is None)
        return got

    monkeypatch.setattr(tpn, "plan_pgather", spy)
    ref = oracle_spgemm(A, B)
    H = spgemm_host(A, None if B is A else B, config=cfg, device="cpu")
    assert H.equals(ref, tol=1e-9)
    state = None
    for call in range(3):                       # cold, then warm
        C, state = spgemm_bucketed(A, B, config=cfg, state=state,
                                   device="cpu")
        assert C.host().equals(ref, tol=1e-9), call
    assert state.planned == "on"
    assert any(declined)        # a chunk past the cap stayed unscheduled


# -- the soak ---------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(structured.FAMILIES))
def test_soak_subset_passes(family):
    cases = [(family, i) for i in range(0, structured.FAMILIES[family][1],
                                        25)]
    cases += [c[:2] for c in soak.REPAIRED
              if c[0] == family and c[1] % 25]
    got = soak.run_cases(cases, device="cpu")
    assert got["failures"] == [], got["errors"]
    assert got["cases"] == len(cases)
    assert got["runs"] == dict.fromkeys(soak.ENGINES, len(cases))
    assert got["launches"] == dict.fromkeys(soak.KERNELS, 0)  # CPU


@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_soak_repaired_cold_and_warm(value_dtype):
    got = soak.run_repaired(device="cpu", value_dtype=value_dtype)
    assert got["failures"] == [], got["errors"]
    assert sum(got["runs"].values()) == 2 * len(soak.REPAIRED)


DEFAULT_CASES = [("spike", 3), ("width_edge", 5), ("cancel", 4),
                 ("degenerate", 1), ("rect_tall", 2), ("comb", 7)]


@pytest.mark.parametrize("case", DEFAULT_CASES)
def test_default_engine_matches_jax(case):
    A, B = structured.make_case(*case)
    ref = oracle_spgemm(A, B)
    H = spgemm_host(A, None if B is A else B, device="cpu")
    J = jm.spgemm_host(jcsr(A), None if B is A else jcsr(B))
    assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
    assert H.equals(J, tol=1e-9) and H.equals(ref, tol=1e-9)


def test_soak_cli_on_the_cpu(capsys):
    rc = soak.main(["--family", "degenerate", "--fast", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["failures"] == []
    assert rep["cases"] == 2 and rep["runs"]["auto"] == 2
    assert rep["per_family"] == {"degenerate": 2}
    assert rep["repaired"]["failures"] == []
