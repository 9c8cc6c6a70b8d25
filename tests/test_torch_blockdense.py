"""The port's block-dense engine and ``mode="auto"`` routing against the JAX
package, on the CPU.

- Planner: the port's ``plan_blockdense`` equals the JAX planner array for
  array (both return None past ``max_pairs``).
- Routing: ``estimate_cost_s``, ``estimate_blockdense_cost``,
  ``blockdense_cost`` and ``choose_engine`` equal the JAX package's.  The
  port's f64 pair kernel is native f64 and needs no certificate, so the
  port's default is compared with JAX ``ozaki="interpret"`` on values its
  bound certifies, and ``ozaki="off"`` with JAX ``ozaki="off"``.
- Engine: C from ``spgemm_host`` under ``mode="blockdense"`` and
  ``"auto"`` equals JAX ``spgemm_host`` under the same mode and the scipy
  oracle: ptr and col exact, values within ``CSR.equals`` 1e-9 (f64) or
  1e-4 (f32), where the engines add the same products in other orders.
- State: warm calls reuse the plan and the densified operands; a JAX plan
  carried across (``blockplan_from_arrays``) gives the same C.
- Windowed extraction: with ``dma_fill="on"`` (JAX "interpret") the
  strips are copied into CSR by ``ragged_fill`` runs; the extraction plan
  equals the JAX package's array for array and C equals its C and the
  oracle's; ``warm_blockplan_from_crow`` rebuilds the same plan.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mh_spgemm_tpu as jm
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import blockdense as jbd
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_tpu.pipeline import choose_engine as jchoose
from mh_spgemm_tpu.pipeline import spgemm_blockdense as jspgemm_blockdense
from mh_spgemm_torch import (CSR, SpGEMMConfig, choose_engine,
                             oracle_spgemm, spgemm_blockdense, spgemm_host)
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.errors import SpGEMMError
from mh_spgemm_torch.ops import blockdense as tbd
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import pair_matmul as tpm
from mh_spgemm_torch.ops import ragged_fill as trf
from mh_spgemm_torch.pipeline import BlockDenseState

CPU = torch.device("cpu")
PLAN_FIELDS = ("nab", "nbb", "ncb", "npairs", "pair_a", "pair_b",
               "pair_new", "cb_i", "cb_j", "end_pair", "seg_passes",
               "max_seg", "m", "n", "mb", "a_blk_of_ent", "a_pos_of_ent",
               "b_blk_of_ent", "b_pos_of_ent", "flops")


def rect_pair():
    rng = np.random.default_rng(6)
    A = CSR.from_coo(200, 300, rng.integers(0, 200, 900),
                     rng.integers(0, 300, 900), rng.standard_normal(900),
                     sum_duplicates=True)
    B = CSR.from_coo(300, 150, rng.integers(0, 300, 700),
                     rng.integers(0, 150, 700), rng.standard_normal(700),
                     sum_duplicates=True)
    return A, B


def structural_zero():
    return CSR.from_coo(2, 2, [0, 0, 1, 1], [0, 1, 0, 1],
                        [1.0, -1.0, 1.0, 1.0])


def empty():
    return CSR.from_coo(7, 7, [], [], [])


# (A, B or None for A @ A)
PAIRS = {
    "banded": lambda: (gen.banded(400, band=15, nnz_per_row=8, seed=1),
                       None),
    "non_multiple": lambda: (gen.banded(333, band=9, nnz_per_row=5,
                                        seed=2), None),
    "rect": rect_pair,
    "structural_zero": lambda: (structural_zero(), None),
    "empty": lambda: (empty(), None),
}
# routing inputs: a block-dense-friendly band, a sparse band, a powerlaw
# and a random matrix
ROUTING = {
    "dense_band": lambda: gen.banded(512, band=60, nnz_per_row=60, seed=3),
    "banded": lambda: gen.banded(400, band=15, nnz_per_row=8, seed=1),
    "powerlaw": lambda: gen.powerlaw(600, avg_nnz=5, max_row=80, seed=5),
    "random": lambda: gen.random_uniform(500, nnz_per_row=7, seed=4),
}


def jcsr(A):
    return JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col, val=A.val,
                is_symmetric=A.is_symmetric)


def jplan(A, B, max_pairs=16384):
    return jbd.plan_blockdense(A.ptr, A.col, B.ptr, B.col, A.M, A.N, B.N,
                               max_pairs=max_pairs)


def tplan(A, B, max_pairs=16384):
    return tbd.plan_blockdense(A.ptr, A.col, B.ptr, B.col, A.M, A.N, B.N,
                               max_pairs=max_pairs)


def assert_plans_equal(tp, jp):
    for f in PLAN_FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    assert np.array_equal(tp.slab_row_start, jp.slab_row_start)
    assert len(tp.strips) == len(jp.strips)
    for ts, js in zip(tp.strips, jp.strips):
        assert (ts.nj, ts.nrows_blk) == (js.nj, js.nrows_blk)
        assert np.array_equal(ts.blk_rows, js.blk_rows)
        assert np.array_equal(ts.cb_idx, js.cb_idx)


@pytest.mark.parametrize("name", ["banded", "non_multiple", "diag_blocks",
                                  "rect"])
def test_planner_matches_jax(name):
    if name == "diag_blocks":
        A, B = gen.diag_blocks(256, block=8, seed=5), None
    else:
        A, B = PAIRS[name]()
    B = A if B is None else B
    tp, jp = tplan(A, B), jplan(A, B)
    assert tp is not None and jp is not None
    assert_plans_equal(tp, jp)


def test_planner_over_budget_is_none():
    A = gen.banded(400, band=15, nnz_per_row=8, seed=1)
    npairs = tplan(A, A).npairs
    assert tplan(A, A, max_pairs=npairs - 1) is None
    assert jplan(A, A, max_pairs=npairs - 1) is None


def configs(value_dtype: str, ozaki: str):
    """(port config, JAX config) that route alike: the port's default is
    JAX's certified Ozaki route."""
    jozaki = "interpret" if ozaki == "auto" else "off"
    return (SpGEMMConfig(value_dtype=value_dtype, ozaki=ozaki),
            jm.SpGEMMConfig(value_dtype=value_dtype, ozaki=jozaki))


@pytest.mark.parametrize("ozaki", ["auto", "off"])
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(ROUTING))
def test_routing_matches_jax(name, value_dtype, ozaki):
    A = ROUTING[name]()
    cfg, jcfg = configs(value_dtype, ozaki)
    vw = 2 if value_dtype == "float64" else 1
    oz = value_dtype == "float32" or ozaki != "off"
    joz = value_dtype == "float64" and ozaki != "off"
    assert tbk.estimate_cost_s(A.ptr, A.col, A.ptr, min_width=2,
                               vwords=vw) == \
        jbk.estimate_cost_s(A.ptr, A.col, A.ptr, min_width=2, vwords=vw)
    args = (A.ptr, A.col, A.ptr, A.col, A.M, A.N)
    assert tbd.estimate_blockdense_cost(*args, cfg.vdtype, ozaki=oz) == \
        jbd.estimate_blockdense_cost(*args, jnp.dtype(value_dtype),
                                     ozaki=joz)
    budget = 1 << 18 if oz else 16384
    assert tbd.blockdense_cost(tplan(A, A, budget), cfg.vdtype,
                               ozaki=oz) == \
        jbd.blockdense_cost(jplan(A, A, budget), jnp.dtype(value_dtype),
                            ozaki=joz)
    assert choose_engine(A, A, cfg) == jchoose(jcsr(A), jcsr(A), jcfg)


def test_routing_reaches_both_engines():
    cfg = SpGEMMConfig()
    assert choose_engine(ROUTING["dense_band"](), ROUTING["dense_band"](),
                         cfg) == "blockdense"
    P = ROUTING["powerlaw"]()
    assert choose_engine(P, P, cfg) == "bucketed"


@functools.lru_cache(maxsize=None)
def jax_result(name: str, mode: str, aat: bool, value_dtype: str):
    A, B = PAIRS[name]()
    B = None if aat else B                # A @ A^T takes one operand
    cfg = jm.SpGEMMConfig(mode=mode, aat=aat, value_dtype=value_dtype)
    return jm.spgemm_host(jcsr(A), None if B is None else jcsr(B),
                          config=cfg)


def reference(A, B, aat: bool):
    if B is None:
        B = A.transpose() if aat else A
    return oracle_spgemm(A, B)


@pytest.mark.parametrize("ozaki", ["auto", "off"])
@pytest.mark.parametrize("aat", [False, True], ids=["AA", "AAT"])
@pytest.mark.parametrize("mode", ["blockdense", "auto"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_engine_matches_jax_and_oracle(name, mode, aat, ozaki):
    A, B = PAIRS[name]()
    B = None if aat else B                # A @ A^T takes one operand
    cfg = SpGEMMConfig(mode=mode, aat=aat, ozaki=ozaki)
    C = spgemm_host(A, B, config=cfg, device="cpu")
    J = jax_result(name, mode, aat, "float64")
    assert np.array_equal(C.ptr, J.ptr) and np.array_equal(C.col, J.col)
    assert C.equals(J, tol=1e-9)
    assert C.equals(reference(A, B, aat), tol=1e-9)


@pytest.mark.parametrize("name", ["banded", "rect"])
def test_engine_f32(name):
    A, B = PAIRS[name]()
    cfg = SpGEMMConfig(mode="blockdense", value_dtype="float32")
    C = spgemm_host(A, B, config=cfg, device="cpu")
    J = jax_result(name, "blockdense", False, "float32")
    assert C.val.dtype == np.float32
    assert np.array_equal(C.ptr, J.ptr) and np.array_equal(C.col, J.col)
    assert C.equals(J, tol=1e-4)
    assert C.equals(reference(A, B, False), tol=1e-4)


@pytest.mark.parametrize("ozaki", ["auto", "off"])
def test_state_reuse(ozaki):
    A = gen.banded(300, band=11, nnz_per_row=6, seed=7)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(mode="blockdense", ozaki=ozaki)
    state, first = None, None
    for call in range(3):
        C, state = spgemm_blockdense(A, A, config=cfg, state=state,
                                     device="cpu")
        C = C.host()
        first = C if first is None else first
        assert C.equals(first, tol=0.0) and C.equals(ref, tol=1e-9), call
    assert state.plan.nnz_c == ref.nnz
    assert state.plan.route == ("kernel" if ozaki == "auto" else "bmm")
    assert "a_dense" in state.plan.dev


def test_state_rejects_other_route():
    A = gen.banded(300, band=11, nnz_per_row=6, seed=7)
    _, state = spgemm_blockdense(A, A, device="cpu")
    with pytest.raises(SpGEMMError):
        spgemm_blockdense(A, A, config=SpGEMMConfig(ozaki="off"),
                          state=state)


@pytest.mark.parametrize("warm", [False, True], ids=["fresh", "learned"])
def test_device_stage_on_jax_plan(warm):
    """The port's device stage on a JAX plan (fresh, or after a JAX run,
    which carries nnz(C) across) gives the port's own C."""
    A = gen.banded(300, band=11, nnz_per_row=6, seed=7)
    own = spgemm_host(A, config=SpGEMMConfig(mode="blockdense"),
                      device="cpu")
    if warm:
        _, jstate = jspgemm_blockdense(jcsr(A), jcsr(A))
        jp = jstate.plan
    else:
        jp = jplan(A, A, max_pairs=1 << 18)
    plan = tbd.blockplan_from_arrays(vars(jp))
    assert (plan.nnz_c is not None) == warm
    st = BlockDenseState(plan=plan, device=CPU, vdtype=torch.float64)
    for _ in range(2):
        C, st = spgemm_blockdense(A, A, state=st)
        assert C.host().equals(own, tol=0.0)


def test_kernel_route_block_sums():
    """The kernel route's per-C-block sums equal the bmm route's
    segment-end sums (the two feeds of the strip packer)."""
    A = gen.banded(300, band=11, nnz_per_row=6, seed=7)
    plan = tplan(A, A)
    tbd.upload_blockplan(plan, CPU)
    d = plan.dev
    val = torch.from_numpy(A.val)
    ad, ap = tbd.densify(d["a_blk"], d["a_pos"], val, nblk=plan.nab)
    stream = (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"])
    kv = tpm.pair_matmul_f64(ad, ad, *stream, ncb=plan.ncb)
    kp = tpm.pair_matmul_f32(ap, ap, *stream, ncb=plan.ncb)
    vs, ps = tbd._bmm_route(d, ad, ap, ad, ap, seg_passes=plan.seg_passes,
                            pair_chunk=8)
    ends = torch.from_numpy(plan.end_pair).long()
    assert torch.allclose(kv, vs[ends], rtol=1e-12, atol=1e-12)
    assert torch.equal(kp, ps[ends])


@functools.lru_cache(maxsize=None)
def jax_windowed(name: str, value_dtype: str):
    A, B = PAIRS[name]()
    cfg = jm.SpGEMMConfig(mode="blockdense", value_dtype=value_dtype,
                          dma_fill="interpret")
    C, state = jspgemm_blockdense(jcsr(A), jcsr(A if B is None else B),
                                  config=cfg)
    return C.host(), state.plan


@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["banded", "rect"])
def test_windowed_extraction_matches_jax(name, value_dtype):
    A, B = PAIRS[name]()
    B = A if B is None else B
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    cfg = SpGEMMConfig(mode="blockdense", value_dtype=value_dtype,
                       dma_fill="on")
    J, jplan_ = jax_windowed(name, value_dtype)
    ref = reference(A, B, False)
    before = trf.ragged_fill.launches
    state = None
    for call in range(3):
        C, state = spgemm_blockdense(A, B, config=cfg, state=state,
                                     device="cpu")
        H = C.host()
        assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
        assert H.equals(J, tol=tol) and H.equals(ref, tol=tol), call
    te, je = state.plan.ext, jplan_.ext
    assert te is not None and je is not None
    for f in ("nplanes", "nchunks", "cap_slots", "wrows", "area_pad"):
        assert getattr(te, f) == getattr(je, f), f
    assert np.array_equal(te.win_row, je.win_row)
    assert np.array_equal(te.runs, je.runs)
    assert trf.ragged_fill.launches == before


@pytest.mark.parametrize("dma_fill", ["auto", "on"])
def test_warm_blockplan_from_crow(dma_fill):
    """A fresh plan warmed from the learned counts takes the warm path at
    once, with the windowed plan exactly where the fill mode allows it
    (on the CPU "auto" resolves to off)."""
    A = gen.banded(300, band=11, nnz_per_row=6, seed=7)
    cfg = SpGEMMConfig(mode="blockdense", dma_fill=dma_fill)
    _, state = spgemm_blockdense(A, A, config=cfg, device="cpu")
    plan = state.plan
    fresh = tplan(A, A, max_pairs=1 << 18)
    fresh.dma_fill = plan.dma_fill
    tbd.warm_blockplan_from_crow(fresh, plan.crow_h, plan.ext_area,
                                 plan.ext_nplanes)
    assert (fresh.nnz_c, fresh.nnz_cap) == (plan.nnz_c, plan.nnz_cap)
    assert (fresh.ext is None) == (dma_fill == "auto") == (plan.ext is None)
    if fresh.ext is not None:
        assert np.array_equal(fresh.ext.runs, plan.ext.runs)
    st = BlockDenseState(plan=fresh, device=CPU, vdtype=torch.float64)
    C, _ = spgemm_blockdense(A, A, config=cfg, state=st)
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)
