"""The slab tail on rows whose width W is not a power of two (the 1.5x
width grid's classes), padded to w2 = the next power of two.

``esc_tail_plain`` at stride W against the sort tail ``_chunk_tail`` on
the same masked rows (keys and counts exact, values within 1e-12 of the
summed magnitudes: the two add in different orders), and against the
power-of-two call on a slab padded by hand to w2, bit for bit (the
kernel's order of additions).  Then the route that ``slab_tail`` takes
for each (W, route, device type), and the bucketed engine with its
padded classes sent to the slab tail, as on the card.  The kernel itself
runs in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from mh_spgemm_torch import SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import esc_tail as tet
from mh_spgemm_torch.pipeline import BucketedState, spgemm_bucketed

I32_MAX = 2**31 - 1
CPU = torch.device("cpu")
# the settings a plan_buckets plan of the 1.5x grid is made under
CFG = SpGEMMConfig(dma_fill="off", planned="off")
WIDTHS = [12, 24, 48, 96, 192, 384, 768, 1536, 3072, 6144]
DTYPES = [torch.float64, torch.float32]


def padded_rows(W: int, dtype, mode: str):
    """Rows of W slots with duplicate-heavy keys; row counts all 0, all W
    or random (row 0 full, row 1 empty), random keys and NaN values past
    each count.  f32 values are multiples of 2^-10 under 2^10, whose sums
    are exact in any order; f64 values are standard normal."""
    rng = np.random.default_rng(W)
    rows = max(3, 8192 // W) + 1
    keys = rng.integers(0, max(2, W // 4), (rows, W)).astype(np.int32)
    if dtype == torch.float32:
        vals = rng.integers(-1 << 20, 1 << 20, (rows, W)) / 1024.0
    else:
        vals = rng.standard_normal((rows, W))
    row_len = {"zero": np.zeros(rows, np.int32),
               "full": np.full(rows, W, np.int32),
               "random": rng.integers(0, W + 1, rows).astype(np.int32)}[mode]
    if mode == "random":
        row_len[0], row_len[1] = W, 0
    vals[np.arange(W)[None, :] >= row_len[:, None]] = np.nan
    return (torch.from_numpy(keys), torch.from_numpy(vals).to(dtype),
            torch.from_numpy(row_len))


@pytest.mark.parametrize("mode", ["zero", "full", "random"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W", WIDTHS)
def test_padded_plain_matches_sort_tail(W, dtype, mode):
    keys, vals, rl = padded_rows(W, dtype, mode)
    oK, oV, cnt = tet.esc_tail(keys, vals, rl, w2=tet.pad_w2(W))
    assert oK.shape == oV.shape == keys.shape
    live = torch.arange(W)[None, :] < rl.long()[:, None]
    K = torch.where(live, keys, I32_MAX)
    V = torch.where(live, vals, 0.0)
    passes = (W - 1).bit_length()
    rK, rV, rc = tbk._chunk_tail(K, V, seg_passes=passes)
    mag = tbk._chunk_tail(K, V.abs(), seg_passes=passes)[1]
    assert torch.equal(oK, rK) and torch.equal(cnt, rc)
    err = (oV.double() - rV.double()).abs()
    assert bool((err <= 1e-12 * mag.double().clamp(min=1.0)).all())
    assert bool((oV[oK == I32_MAX] == 0).all())


@pytest.mark.parametrize("mode", ["zero", "full", "random"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W", WIDTHS)
def test_padded_plain_is_the_pow2_call_on_a_padded_slab(W, dtype, mode):
    """Rows of W slots give, bit for bit, the first W slots of the
    power-of-two call on the same rows padded by hand to w2 with random
    keys and NaN values, which the row counts mask; the call's slots
    W..w2-1 come back empty, so the cut loses nothing."""
    keys, vals, rl = padded_rows(W, dtype, mode)
    w2 = tet.pad_w2(W)
    rng = np.random.default_rng(w2)
    Kp = torch.from_numpy(rng.integers(0, W, (keys.shape[0], w2)).astype(
        np.int32))
    Vp = torch.full((keys.shape[0], w2), float("nan"), dtype=dtype)
    Kp[:, :W], Vp[:, :W] = keys, vals
    pK, pV, pc = tet.esc_tail(Kp, Vp, rl, w2=w2)
    oK, oV, cnt = tet.esc_tail(keys, vals, rl, w2=w2)
    assert torch.equal(oK, pK[:, :W]) and torch.equal(oV, pV[:, :W])
    assert torch.equal(cnt, pc)
    assert bool((pK[:, W:] == I32_MAX).all() and (pV[:, W:] == 0).all())


@pytest.mark.parametrize("W,w2,ok", [
    (3, 4, True), (6, 8, True), (192, 256, True), (6144, 8192, True),
    (8191, 8192, True), (256, 256, True), (12288, 16384, True),
    (128, 256, False), (300, 256, False), (5, 7, False)])
def test_slab_wrapper_takes_rows_that_pad_to_w2(W, w2, ok):
    keys = torch.zeros((2, W), dtype=torch.int32)
    vals = torch.zeros((2, W), dtype=torch.float64)
    rl = torch.full((2,), W, dtype=torch.int32)
    before = tet.esc_tail.launches
    if ok:
        oK, _, cnt = tet.esc_tail(keys, vals, rl, w2=w2)
        assert oK.shape == (2, W) and cnt.tolist() == [1, 1]
    else:
        with pytest.raises(ValueError):
            tet.esc_tail(keys, vals, rl, w2=w2)
    assert tet.esc_tail.launches == before


@pytest.mark.parametrize("W,route,device,want", [
    (1, "kernel", "cuda", "direct"), (1, "sort", "cpu", "direct"),
    (2, "kernel", "cpu", "kernel"), (256, "kernel", "cuda", "kernel"),
    (256, "kernel", "cpu", "kernel"), (256, "sort", "cuda", "sort"),
    (65536, "kernel", "cuda", "kernel"), (131072, "kernel", "cuda", "kernel"),
    (3, "kernel", "cuda", "kernel"), (192, "kernel", "cuda", "kernel"),
    (384, "kernel", "cuda", "kernel"), (6144, "kernel", "cuda", "kernel"),
    (384, "kernel", "cpu", "sort"), (384, "sort", "cuda", "sort"),
    (12288, "kernel", "cuda", "kernel"), (9000, "kernel", "cuda", "kernel"),
    (8192, "kernel", "cuda", "kernel"), (8193, "kernel", "cuda", "kernel"),
    (16384, "kernel", "cuda", "kernel"), (98304, "kernel", "cuda", "kernel"),
    (786432, "kernel", "cuda", "kernel"),
    (1 << 20, "kernel", "cuda", "kernel"), (I32_MAX, "kernel", "cuda", "kernel"),
    (12288, "sort", "cuda", "sort"), (786432, "sort", "cuda", "sort"),
    (12288, "kernel", "cpu", "sort"), (16384, "kernel", "cpu", "kernel"),
    (65536, "kernel", "cpu", "kernel"), (131072, "kernel", "cpu", "sort"),
    (786432, "kernel", "cpu", "sort")])
def test_tail_route(W, route, device, want):
    """On CUDA every width but 1 takes the kernel up to the int32 slab
    bound (padded to 8192, its wide path past it), unless the route is
    "sort"; CPU tensors keep the sort tail off the JAX package's widths
    (powers of two to 65536)."""
    assert tbk.tail_route(W, route, device) == want


def padded_plan(A):
    """A plan on the 1.5x width grid (the legacy replan's), with at least
    one class whose W is not a power of two."""
    plan = tbk.plan_buckets(A.ptr, A.col, A.ptr, precompute=False)
    assert any(c.W & (c.W - 1) for c in plan.classes)
    return plan


@pytest.mark.parametrize("matrix", ["er_192", "powerlaw_16_384"])
def test_engine_sends_padded_classes_to_the_slab_tail(matrix, monkeypatch):
    """With the route decided as for CUDA tensors, every class of a
    1.5x-grid plan takes the slab tail (its plain version here): no slot
    takes the sort tail, ``tail_padded_slots`` counts the padded classes'
    slots in every run, and C is the oracle's."""
    A = {"er_192": lambda: gen.random_uniform(2000, nnz_per_row=12, seed=9),
         "powerlaw_16_384": lambda: gen.powerlaw(6000, avg_nnz=8,
                                                 seed=42)}[matrix]()
    route = tbk.tail_route
    monkeypatch.setattr(tbk, "tail_route",
                        lambda W, r, device: route(W, r, "cuda"))
    plan = padded_plan(A)
    padded = sum(c.W * c.rb * c.nchunks for c in plan.classes
                 if c.W & (c.W - 1))
    st = BucketedState(plan=plan, device=CPU, route="kernel")
    ref = oracle_spgemm(A, A)
    for run in (1, 2):
        C, st = spgemm_bucketed(A, A, CFG, state=st)
        assert C.host().equals(ref, tol=1e-9)
        assert st.plan.tail_slots["sort"] == 0
        assert st.plan.tail_padded_slots == run * padded
        assert st.plan.stats()["padded_tail_slots"] == run * padded


def test_cpu_keeps_the_sort_tail_for_padded_classes():
    """On CPU tensors the 1.5x-grid classes keep the sort tail, the JAX
    package's bits; nothing counts as padded."""
    A = gen.random_uniform(2000, nnz_per_row=12, seed=9)
    st = BucketedState(plan=padded_plan(A), device=CPU, route="kernel")
    C, st = spgemm_bucketed(A, A, CFG, state=st)
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)
    assert st.plan.tail_slots["sort"] > 0
    assert st.plan.tail_padded_slots == 0
    assert st.plan.stats()["padded_tail_slots"] == 0
