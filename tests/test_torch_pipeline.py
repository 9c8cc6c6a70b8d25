"""The port's pipeline (``spgemm_host``, ``spgemm_bucketed`` cold and warm,
``spgemm_chunked``) against the JAX package's ``spgemm_host`` on the
bucketed engine and against the scipy oracle, on the CPU.

The JAX side runs the configuration its own rules pick on a card with
native f64: the bucketed engine with precomputed slots, native-f64 values
(``df32="off"``), no fill or planned frontend, and the XLA sort tail.

Tolerances: ptr and col exact; values within ``CSR.equals`` tol 1e-9
(absolute or relative) in f64, where both packages add the same products
in f64; 1e-4 in f32, where the two tails sum in different orders.

Also here: every setting the port does not run yet raises and names its
ROADMAP item, and ``esc_tail="off"`` routes every class through the sort
tail.
"""

import numpy as np
import pytest
import torch

import mh_spgemm_tpu as jm
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_torch import (CSR, SpGEMMConfig, oracle_spgemm,
                             spgemm_chunked, spgemm_host)
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.errors import DeviceError
from mh_spgemm_torch.ops import esc_tail as et
from mh_spgemm_torch.pipeline import spgemm_bucketed

MATRICES = {
    "tiny_fixture": lambda: gen.tiny_fixture(),
    "powerlaw": lambda: gen.powerlaw(400, avg_nnz=5, max_row=90, seed=42),
    "banded": lambda: gen.banded(300, band=12, nnz_per_row=6, seed=5),
}
TOL = {"float64": 1e-9, "float32": 1e-4}


def jax_host(A, value_dtype: str, aat: bool):
    cfg = jm.SpGEMMConfig(mode="bucketed", value_dtype=value_dtype,
                          aat=aat, df32="off", dma_fill="off",
                          planned="off", esc_tail="off")
    J = JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col, val=A.val,
             is_symmetric=A.is_symmetric)
    return jm.spgemm_host(J, config=cfg)


def reference(A, aat: bool):
    B = A.transpose() if aat else A
    return B, oracle_spgemm(A, B)


@pytest.mark.parametrize("aat", [False, True], ids=["AA", "AAT"])
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_host_matches_jax_and_oracle(name, value_dtype, aat):
    A = MATRICES[name]()
    tol = TOL[value_dtype]
    cfg = SpGEMMConfig(value_dtype=value_dtype, aat=aat)
    C = spgemm_host(A, config=cfg, device="cpu")
    J = jax_host(A, value_dtype, aat)
    _, ref = reference(A, aat)
    assert C.val.dtype == np.dtype(value_dtype)
    assert np.array_equal(C.ptr, J.ptr) and np.array_equal(C.col, J.col)
    assert C.equals(J, tol=tol)
    assert C.equals(ref, tol=tol)


@pytest.mark.parametrize("aat", [False, True], ids=["AA", "AAT"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bucketed_cold_then_warm(name, aat):
    A = MATRICES[name]()
    B, ref = reference(A, aat)
    state = None
    for call in range(3):
        C, state = spgemm_bucketed(A, B, state=state, device="cpu")
        assert state.plan.class_caps is not None        # warm after call 0
        assert C.host().equals(ref, tol=1e-9), call
    assert state.plan.nnz_c == ref.nnz


def test_chunked_equals_whole():
    A = gen.powerlaw(500, avg_nnz=6, max_row=120, seed=8)
    whole = spgemm_host(A, device="cpu")
    parts = spgemm_chunked(A, A, max_products=A.intprod(A) // 7,
                           device="cpu")
    assert parts.equals(whole, tol=1e-9)
    assert parts.equals(oracle_spgemm(A, A), tol=1e-9)


def test_host_falls_back_to_chunked_on_overflow(monkeypatch):
    """A plan past int32 indexing raises SlabOverflowError; spgemm_host
    then splits the rows, halving a range again while it overflows.  The
    overflow is simulated by a product budget far under int32."""
    from mh_spgemm_torch.ops import bucketed as tbk
    plan = tbk.plan_buckets
    seen = []

    def small_budget(a_ptr, a_col, b_ptr, **kw):
        p = plan(a_ptr, a_col, b_ptr, **kw)
        seen.append(p.intprod)
        if p.intprod > 1500:
            raise tbk.SlabOverflowError("simulated overflow")
        return p

    monkeypatch.setattr(tbk, "plan_buckets", small_budget)
    A = gen.powerlaw(500, avg_nnz=6, max_row=120, seed=8)
    C = spgemm_host(A, device="cpu")
    assert seen[0] == A.intprod(A) > 1500 and len(seen) > 3
    assert C.equals(oracle_spgemm(A, A), tol=1e-9)


def test_empty_operands():
    A = gen.tiny_fixture()
    Z = CSR.from_coo(A.M, A.N, [], [], [])
    for X, Y in ((Z, A), (A, Z)):
        C = spgemm_host(X, Y, device="cpu")
        assert C.nnz == 0 and np.array_equal(C.ptr, np.zeros(A.M + 1))


def test_default_device_needs_cuda():
    """device=None means the card: without CUDA every entry point raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A = gen.tiny_fixture()
    with pytest.raises(DeviceError):
        spgemm_host(A)
    with pytest.raises(DeviceError):
        spgemm_bucketed(A, A)
    with pytest.raises(DeviceError):
        spgemm_chunked(A, A)


@pytest.mark.parametrize("field,value,item", [
    ("mode", "auto", "Queue 1 item 8"),
    ("mode", "blockdense", "Queue 1 item 8"),
    ("mode", "masked", "Queue 1 item 9"),
    ("mode", "esc", "Queue 1 item 9"),
    ("dma_fill", "on", "Queue 2 item 3"),
    ("dma_fill", "interpret", "Queue 2 item 3"),
    ("planned", "on", "Queue 2 items 4-5"),
    ("planned", "interpret", "Queue 2 items 4-5"),
    ("ozaki", "on", "Queue 2 item 7"),
    ("ozaki", "interpret", "Queue 2 item 7"),
    ("df32", "on", "ground rules"),
    ("wide_gather", "on", "ground rules"),
    ("group_gather", "on", "ground rules"),
    ("comm_backend", "pallas", "Queue 1 item 10"),
])
def test_unported_settings_raise(field, value, item):
    cfg = SpGEMMConfig(**{field: value})
    A = gen.tiny_fixture()
    for call in (lambda: spgemm_host(A, config=cfg, device="cpu"),
                 lambda: spgemm_bucketed(A, A, config=cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP") as exc:
            call()
        assert item in str(exc.value)


@pytest.mark.parametrize("field", ["dma_fill", "planned", "ozaki", "df32",
                                   "wide_gather", "group_gather"])
def test_auto_and_off_settings_run(field):
    A = gen.tiny_fixture()
    ref = oracle_spgemm(A, A)
    for value in ("auto", "off"):
        C = spgemm_host(A, config=SpGEMMConfig(**{field: value}),
                        device="cpu")
        assert C.equals(ref, tol=1e-9)


@pytest.mark.parametrize("esc_tail,route", [("auto", "kernel"),
                                            ("on", "kernel"),
                                            ("off", "sort")])
def test_esc_tail_routing(esc_tail, route):
    """Pow2 classes go to esc_tail_flat unless esc_tail="off" selects the
    sort tail.  On CPU tensors the wrapper runs its plain version, so no
    launch is counted either way."""
    A = gen.powerlaw(400, avg_nnz=5, max_row=90, seed=42)
    before = et.esc_tail_flat.launches
    C, state = spgemm_bucketed(A, A, config=SpGEMMConfig(esc_tail=esc_tail),
                               device="cpu")
    slots = state.plan.tail_slots
    other = "sort" if route == "kernel" else "kernel"
    assert slots[route] > 0 and slots[other] == 0
    assert et.esc_tail_flat.launches == before
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)
