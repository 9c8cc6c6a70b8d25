"""``esc_tail="pow2"``'s planner half against the JAX package, on the CPU.

Under ``esc_tail="pow2"`` with values as f32 words the JAX pipeline plans
with ``pow2_fill_widths``: rows with long B spans (the rows headed for
fill classes) take power-of-two width classes, so the fill classes run the
pow2 slab tail.  The port's ``plan_buckets`` must give the JAX planner's
plan array for array with the option on and off (``precompute=False`` and
the fill forced: the port's ``dma_fill="on"`` against the JAX
``"interpret"``, both planar), ``prepare_bucketed_state`` must pass it to
both of its plans exactly where the JAX pipeline does, and C from the pow2
plan must equal the JAX package's (its pipeline planning the same way) and
the oracle's.

Tolerances: ptr and col exact; f32 values within ``CSR.equals`` tol 1e-4
(absolute or relative): the two packages' tails sum in different orders.
"""

import numpy as np
import pytest
import torch

import mh_spgemm_tpu as jm
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu import pipeline as jpipe
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_torch import SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.pipeline import (BucketedState, prepare_bucketed_state,
                                      spgemm_bucketed)

CPU = torch.device("cpu")
FIELDS = ("W", "rb", "nchunks", "eb", "rows_g", "ent_dst", "ent_src",
          "ent_len", "ent_aidx", "hold_passes", "seg_passes", "slot_src",
          "slot_aidx", "fill", "stride", "wrows", "out_rows", "win_row",
          "runs", "row_len", "pre")
# matrix -> fill-class widths without and with pow2_fill_widths
PLAN_MATRICES = {
    "banded": (lambda: gen.banded(3000, band=40, nnz_per_row=12, seed=1),
               [128, 192], [128, 256]),
    "random_uniform": (lambda: gen.random_uniform(3000, nnz_per_row=12,
                                                  seed=2), [192], [256]),
}
C_MATRICES = {
    "banded": lambda: gen.banded(400, band=40, nnz_per_row=12, seed=1),
    "random_uniform": lambda: gen.random_uniform(400, nnz_per_row=12,
                                                 seed=2),
}


def both_plans(A, pow2: bool):
    tp = tbk.plan_buckets(A.ptr, A.col, A.ptr, vwords=1, dma_fill="on",
                          precompute=False, pow2_fill_widths=pow2)
    jp = jbk.plan_buckets(A.ptr, A.col, A.ptr, min_width=2, vwords=1,
                          dma_fill="interpret", planar=True, group="off",
                          precompute=False, planned="off",
                          pow2_fill_widths=pow2)
    return tp, jp


def assert_plans_equal(tp, jp):
    assert (tp.m, tp.m_cap, tp.intprod) == (jp.m, jp.m_cap, jp.intprod)
    assert np.array_equal(tp.slab_row_start, jp.slab_row_start)
    assert len(tp.classes) == len(jp.classes)
    for tc, jc in zip(tp.classes, jp.classes):
        for f in FIELDS:
            a, b = getattr(tc, f), getattr(jc, f)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f


@pytest.mark.parametrize("pow2", [False, True], ids=["grid", "pow2"])
@pytest.mark.parametrize("name", sorted(PLAN_MATRICES))
def test_pow2_fill_plans_match_jax(name, pow2):
    make, grid_w, pow2_w = PLAN_MATRICES[name]
    A = make()
    tp, jp = both_plans(A, pow2)
    assert_plans_equal(tp, jp)
    assert all(c.fill for c in tp.classes)
    assert [c.W for c in tp.classes] == (pow2_w if pow2 else grid_w)


@pytest.mark.parametrize("value_dtype,expect", [("float32", True),
                                                ("float64", False)])
@pytest.mark.parametrize("esc_tail", ["pow2", "auto"])
def test_prepare_passes_pow2_to_both_plans(esc_tail, value_dtype, expect,
                                           monkeypatch):
    """The first plan and the legacy replan both get pow2_fill_widths,
    true only under esc_tail="pow2" with f32 values (the JAX pipeline's
    "f32 words"; the port has no Dekker transport)."""
    seen = []
    plan = tbk.plan_buckets

    def spy(*a, **kw):
        seen.append(kw["pow2_fill_widths"])
        return plan(*a, **kw)

    monkeypatch.setattr(tbk, "plan_buckets", spy)
    monkeypatch.setattr(tbk, "needs_replan", lambda p: True)
    A = C_MATRICES["banded"]()
    cfg = SpGEMMConfig(value_dtype=value_dtype, esc_tail=esc_tail,
                       dma_fill="on", planned="on")
    state = prepare_bucketed_state(A, A, cfg, device="cpu")
    assert state.replanned
    assert seen == [expect and esc_tail == "pow2"] * 2


@pytest.mark.parametrize("name", sorted(C_MATRICES))
def test_pow2_fill_c_matches_jax_and_oracle(name, monkeypatch):
    """C from the pow2 legacy plan (f32, fill forced), cold then warm,
    against the JAX pipeline's C on the plan it makes without precompute
    under esc_tail="pow2" (the same plan), and against the oracle."""
    A = C_MATRICES[name]()
    tp, jp = both_plans(A, True)
    assert_plans_equal(tp, jp)
    assert all(c.W & (c.W - 1) == 0 for c in tp.classes)
    # the JAX pipeline plans under "pow2" without precompute, then runs
    # the plan with its tail kernel in interpreter mode ("pow2" runs the
    # Mosaic tail, which the CPU runs only interpreted)
    monkeypatch.setenv("MHSPGEMM_PRE", "0")
    JA = JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col, val=A.val)
    kw = dict(mode="bucketed", value_dtype="float32", dma_fill="interpret",
              planned="off")
    jstate = jpipe.prepare_bucketed_state(
        JA, JA, jm.SpGEMMConfig(esc_tail="pow2", **kw))
    assert_plans_equal(tp, jstate.plan)
    J = jpipe.spgemm_bucketed(JA, JA, jm.SpGEMMConfig(esc_tail="interpret",
                                                      **kw),
                              state=jstate)[0].host()
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(value_dtype="float32", dma_fill="on",
                       esc_tail="pow2")
    state = BucketedState(plan=tp, device=CPU, route="kernel")
    for call in range(2):
        C, state = spgemm_bucketed(A, A, config=cfg, state=state)
        H = C.host()
        assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
        assert H.equals(J, tol=1e-4) and H.equals(ref, tol=1e-4), call
    assert state.plan.tail_slots["kernel"] > 0
    assert state.plan.tail_slots["sort"] == 0
