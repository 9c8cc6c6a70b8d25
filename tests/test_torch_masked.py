"""The port's masked engine (``mode="masked"``) against the JAX package, on
the CPU.

- Host planning: ``host_mask_matrix`` and ``plan_masked_extras`` equal
  the JAX package's array for array (the tile-slab widths and, with the
  fill on, the tile run plans, row counts and the tile stream), on the
  port's ``precompute=False`` plans, which equal the JAX planner's.
- ``mask_stage`` on CPU tensors equals the JAX ``mask_stage`` (masks
  compared as their 32 bits).
- Engine: ``spgemm_masked`` cold and warm, with ``dma_fill`` off and on
  (JAX "off" and "interpret"), in f64 and f32 and on a rectangular pair:
  ptr and col exact against the JAX package's C and the oracle's, values
  within ``CSR.equals`` 1e-9 (f64; the JAX package adds double-f32 pairs
  there) or 1e-4 (f32, other summation orders).

JAX calls stay at about 150 rows: the masked programs' compiles dominate
the JAX suite's time.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mh_spgemm_tpu as jm
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_tpu.ops import mask as jmask
from mh_spgemm_tpu.ops import masked_classes as jmc
from mh_spgemm_tpu.ops import ragged_fill as jrf
from mh_spgemm_torch import (CSR, SpGEMMConfig, oracle_spgemm,
                             spgemm_host, spgemm_masked)
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import mask as tmask
from mh_spgemm_torch.ops import masked_classes as tmc
from mh_spgemm_torch.ops import ragged_fill as trf


def rect_pair():
    rng = np.random.default_rng(8)
    A = CSR.from_coo(120, 160, rng.integers(0, 120, 700),
                     rng.integers(0, 160, 700), rng.standard_normal(700),
                     sum_duplicates=True)
    B = CSR.from_coo(160, 90, rng.integers(0, 160, 1100),
                     rng.integers(0, 90, 1100), rng.standard_normal(1100),
                     sum_duplicates=True)
    return A, B


# (A, B or None for A @ A)
PAIRS = {
    "tiny_fixture": lambda: (gen.tiny_fixture(), None),
    "banded": lambda: (gen.banded(150, band=12, nnz_per_row=6, seed=5),
                       None),
    "powerlaw": lambda: (gen.powerlaw(150, avg_nnz=5, max_row=50, seed=42),
                         None),
    "rect": rect_pair,
}
FILL_MODES = {"on": ("interpret", False), "auto": ("auto", True),
              "off": ("off", False)}


def operands(name):
    A, B = PAIRS[name]()
    return A, (A if B is None else B)


def jcsr(X):
    return JCSR(M=X.M, N=X.N, ptr=X.ptr, col=X.col, val=X.val)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_host_mask_matrix_matches_jax(name):
    _, B = operands(name)
    for a, b in zip(tmc.host_mask_matrix(B.ptr, B.col),
                    jmc.host_mask_matrix(B.ptr, B.col)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_mask_stage_matches_jax(name):
    A, B = operands(name)
    t = tmask.mask_stage(*(torch.from_numpy(x.astype(np.int32))
                           for x in (B.ptr, B.col, A.ptr, A.col)))
    j = jmask.mask_stage(*(jnp.asarray(x.astype(np.int32))
                           for x in (B.ptr, B.col, A.ptr, A.col)))
    for f in ("tileptr", "tilecol", "nnz_to_tile"):
        assert np.array_equal(getattr(t.mask, f).numpy(),
                              np.asarray(getattr(j.mask, f))), f
    assert np.array_equal(t.mask.tilemask.numpy().view(np.uint32),
                          np.asarray(j.mask.tilemask))
    for f in ("fub_row", "prod_row", "totals", "max_arow"):
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f))), f


@pytest.mark.parametrize("mode", sorted(FILL_MODES))
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_masked_extras_match_jax(name, mode, monkeypatch):
    A, B = operands(name)
    jmode, tpu = FILL_MODES[mode]
    monkeypatch.setattr(jrf, "on_tpu", lambda: tpu)
    tp = tbk.plan_buckets(A.ptr, A.col, B.ptr, dma_fill=mode,
                          precompute=False)
    jp = jbk.plan_buckets(A.ptr, A.col, B.ptr, min_width=2,
                          dma_fill=jmode, planar=True, precompute=False)
    assert [(c.W, c.frontend) for c in tp.classes] == [
        (c.W, "fill" if c.fill else "gather") for c in jp.classes]
    tt, te, tpairs = tmc.plan_masked_extras(tp, A.ptr, A.col, B.ptr, B.col,
                                            dma_fill=mode)
    jt, je, jpairs = jmc.plan_masked_extras(jp, A.ptr, A.col, B.ptr, B.col,
                                            dma_fill=jmode)
    assert np.array_equal(tt, jt)
    assert len(te) == len(je)
    for a, b in zip(te, je):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert (tpairs is None) == (jpairs is None)
    if tpairs is not None:
        assert np.array_equal(tpairs, jpairs)
    if mode == "on":
        assert all(e["t_fill"] for e in te)


@functools.lru_cache(maxsize=None)
def jax_masked(name: str, value_dtype: str, dma_fill: str):
    A, B = operands(name)
    cfg = jm.SpGEMMConfig(mode="masked", value_dtype=value_dtype,
                          dma_fill=dma_fill)
    return jm.spgemm_host(jcsr(A), jcsr(B), config=cfg)


CASES = [("tiny_fixture", "float64", "off"), ("banded", "float64", "off"),
         ("banded", "float64", "on"), ("powerlaw", "float64", "off"),
         ("powerlaw", "float64", "on"), ("powerlaw", "float32", "on"),
         ("rect", "float64", "off"), ("rect", "float64", "on"),
         ("rect", "float32", "off")]


@pytest.mark.parametrize("name,value_dtype,dma_fill", CASES)
def test_masked_matches_jax_and_oracle(name, value_dtype, dma_fill):
    A, B = operands(name)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    cfg = SpGEMMConfig(mode="masked", value_dtype=value_dtype,
                       dma_fill=dma_fill)
    J = jax_masked(name, value_dtype,
                   "interpret" if dma_fill == "on" else "off")
    ref = oracle_spgemm(A, B)
    before = trf.ragged_fill.launches
    state = None
    for call in range(3):                       # cold, then warm
        C, state = spgemm_masked(A, B, config=cfg, state=state,
                                 device="cpu")
        H = C.host()
        assert H.val.dtype == np.dtype(value_dtype)
        assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
        assert H.equals(J, tol=tol) and H.equals(ref, tol=tol), call
    plan = state.plan
    assert plan.nnz_c == ref.nnz
    assert all(not c.pre for c in plan.classes)
    if dma_fill == "on":
        assert all(c.fill for c in plan.classes) and plan.ext is not None
        assert all(e["t_fill"] for e in state.extras)
    else:
        assert all(c.frontend == "gather" for c in plan.classes)
        assert plan.ext is None
    assert trf.ragged_fill.launches == before


def test_symbolic_counts_equal_the_numeric_rows():
    """The symbolic stage's per-row counts (tile OR + popcount) are the
    rows of C, gather and fill tile slabs alike."""
    A, B = operands("powerlaw")
    crow = np.diff(oracle_spgemm(A, B).ptr)
    for mode in ("off", "on"):
        cfg = SpGEMMConfig(mode="masked", dma_fill=mode)
        _, state = spgemm_masked(A, B, config=cfg, device="cpu")
        main = tmc.masked_main(state.plan, state.extras, state.ops)
        assert np.array_equal(main[0][: A.M].numpy(), crow)


def test_popcount32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    want = np.array([bin(int(v)).count("1") for v in x])
    got = tmc.popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    assert np.array_equal(got, want)


def test_masked_through_spgemm_host():
    A, _ = operands("banded")
    for aat in (False, True):
        cfg = SpGEMMConfig(mode="masked", aat=aat)
        B = A.transpose() if aat else A
        C = spgemm_host(A, config=cfg, device="cpu")
        assert C.equals(oracle_spgemm(A, B), tol=1e-9)


def test_masked_empty_operand():
    A = gen.tiny_fixture()
    Z = CSR.from_coo(A.M, A.N, [], [], [])
    C, _ = spgemm_masked(Z, A, device="cpu")
    assert C.host().nnz == 0
