"""The port's pair matmuls and block gather (mh_spgemm_torch.ops.pair_matmul)
against the JAX package's Pallas kernels run in interpreter mode, on the
same numpy inputs.

Tolerances:
- f32 pair matmul: 1e-4 absolute or relative against JAX
  ``pair_matmul_f32`` (both in f32, summed in different orders).
- The model of the CUDA f32 kernel's split-TF32 arithmetic
  (:func:`split_tf32_model`): 1e-4 absolute or relative against JAX
  ``pair_matmul_f32`` (f32 sums in another order, and the dropped
  small·small terms, each under 2^-22 of |a|·|b|); its max abs error
  against the f64 product of the same f32 inputs at most 4× that of
  plain f32 ``torch.bmm``; exact on 0/1 blocks.
- f64 pair matmul: 1e-9 absolute or relative against JAX
  ``pair_matmul_f64_ozaki`` (its error bound certifies 1e-10 absolute),
  and within 1e-12 of the sum of |a|·|b| products against numpy f64 (the
  rounding bound of a dot product of these lengths is under 2e-13 of
  it).
- block gather: exact.

The Pallas kernels never write a C block that no pair names (its content
is undefined in interpreter mode), so the comparison with JAX covers the
named blocks; the port must give zeros for the others.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mh_spgemm_tpu.ops import ozaki as joz
from mh_spgemm_tpu.ops import pallas_gather as jpg
from mh_spgemm_torch.ops import pair_matmul as tpm

BS = 128


def pair_stream(rng, nab: int, nbb: int, ncb: int, max_seg: int):
    """Segments of 1..max_seg pairs in C-block order, some dead pairs,
    one C block whose pairs are all dead, and C blocks with no pair
    (block 1 and the last)."""
    pa, pb, cb, live = [], [], [], []
    for c in range(ncb):
        if c in (1, ncb - 1):
            continue
        n = int(rng.integers(1, max_seg + 1))
        pa += rng.integers(0, nab, n).tolist()
        pb += rng.integers(0, nbb, n).tolist()
        cb += [c] * n
        live += (rng.random(n) > 0.25).tolist() if c != 2 else [False] * n
    return (np.array(pa, np.int32), np.array(pb, np.int32),
            np.array(cb, np.int32), np.array(live, bool))


def blocks(rng, n: int) -> np.ndarray:
    return rng.standard_normal((n, BS, BS))


def port(fn, a, b, pa, pb, cb, live, ncb, dtype):
    t = [torch.from_numpy(x) for x in (pa, pb, cb)]
    return fn(torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
              *t, torch.from_numpy(live), ncb=ncb).numpy()


def close(got, want, tol):
    err = np.abs(got - want)
    return bool(np.all(err <= tol * np.maximum(1.0, np.abs(want))))


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = blocks(rng, 9).astype(np.float32), blocks(rng, 7).astype(np.float32)
    ncb = 6
    pa, pb, cb, live = pair_stream(rng, 9, 7, ncb, max_seg=10)
    assert 16 <= pa.size <= 40
    got = port(tpm.pair_matmul_f32, a, b, pa, pb, cb, live, ncb,
               torch.float32)
    want = np.asarray(jpg.pair_matmul_f32(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(pa), jnp.asarray(pb),
        jnp.asarray(cb), jnp.asarray(live), ncb=ncb, interpret=True))
    named = np.unique(cb)
    assert got.dtype == np.float32
    assert close(got[named], want[named], 1e-4)
    assert not got[[1, ncb - 1]].any() and not got[2].any()


def test_f64_matches_ozaki_and_numpy():
    rng = np.random.default_rng(7)
    a, b = blocks(rng, 6), blocks(rng, 5)
    ncb = 5
    pa, pb, cb, live = pair_stream(rng, 6, 5, ncb, max_seg=5)
    max_seg = int(np.bincount(cb).max())
    S = joz.plan_ozaki_levels(float(np.abs(a).max()),
                              float(np.abs(b).max()), max_seg)
    assert S is not None
    want = np.asarray(joz.pair_matmul_f64_ozaki(
        joz.slice_blocks(jnp.asarray(a), nslices=S, contract_axis=2),
        joz.slice_blocks(jnp.asarray(b), nslices=S, contract_axis=1),
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(cb),
        jnp.asarray(live), ncb=ncb, nslices=S, interpret=True))
    got = port(tpm.pair_matmul_f64, a, b, pa, pb, cb, live, ncb,
               torch.float64)
    named = np.unique(cb)
    assert got.dtype == np.float64
    assert close(got[named], want[named], 1e-9)
    exact = np.zeros((ncb, BS, BS))
    scale = np.zeros((ncb, BS, BS))
    for g in np.flatnonzero(live):
        exact[cb[g]] += a[pa[g]] @ b[pb[g]]
        scale[cb[g]] += np.abs(a[pa[g]]) @ np.abs(b[pb[g]])
    assert np.all(np.abs(got - exact) <= 1e-12 * scale)
    assert not got[[1, ncb - 1]].any()


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 bits: round to 10 explicit
    mantissa bits, to nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_model(a, b, pair_a, pair_b, pair_cb, live, ncb: int):
    """The CUDA f32 kernel's arithmetic (``csrc/pair_matmul.cu``), in
    torch on f32 tensors: each operand x is split into big = tf32(x) and
    small = tf32(x - big); per live pair, in stream order, each 32-deep
    k-slice sums small·big, big·small and big·big (each 8-deep step of
    the three a product of its own, added in that order) into a slice
    tile that is then added to the C block.  What it cannot model is the
    tensor cores' own rounding inside a step."""
    def split(x):
        big = tf32_rna(x)
        return big, tf32_rna(x - big)

    out = torch.zeros((ncb, BS, BS), dtype=torch.float32)
    for g in torch.nonzero(live).flatten().tolist():
        ab, asm = split(a[int(pair_a[g])])
        bb, bsm = split(b[int(pair_b[g])])
        for k0 in range(0, BS, 32):
            part = torch.zeros((BS, BS), dtype=torch.float32)
            for k in range(k0, k0 + 32, 8):
                s = slice(k, k + 8)
                part += asm[:, s] @ bb[s]
                part += ab[:, s] @ bsm[s]
                part += ab[:, s] @ bb[s]
            out[int(pair_cb[g])] += part
    return out


def test_tf32_rounding():
    one = 1.0
    x = torch.tensor([one, one + 2**-11, -(one + 2**-11), one + 2**-12,
                      one + 3 * 2**-12, 3.0, -0.0], dtype=torch.float32)
    want = [one, one + 2**-10, -(one + 2**-10), one, one + 2**-10, 3.0,
            -0.0]
    assert tf32_rna(x).tolist() == want
    assert torch.equal(tf32_rna(x).view(torch.int32) & 0x1FFF,
                       torch.zeros(7, dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_model_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = blocks(rng, 9).astype(np.float32), blocks(rng, 7).astype(np.float32)
    ncb = 6
    pa, pb, cb, live = pair_stream(rng, 9, 7, ncb, max_seg=10)
    got = split_tf32_model(torch.from_numpy(a), torch.from_numpy(b),
                           *(torch.from_numpy(x) for x in (pa, pb, cb,
                                                           live)),
                           ncb).numpy()
    want = np.asarray(jpg.pair_matmul_f32(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(pa), jnp.asarray(pb),
        jnp.asarray(cb), jnp.asarray(live), ncb=ncb, interpret=True))
    named = np.unique(cb)
    assert close(got[named], want[named], 1e-4)
    assert not got[[1, ncb - 1]].any() and not got[2].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_model_error_within_bmm(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(blocks(rng, 9).astype(np.float32))
    b = torch.from_numpy(blocks(rng, 7).astype(np.float32))
    ncb = 6
    stream = [torch.from_numpy(x) for x in
              pair_stream(rng, 9, 7, ncb, max_seg=10)]
    exact = tpm.pair_matmul_plain(a.double(), b.double(), *stream, ncb=ncb)
    model = split_tf32_model(a, b, *stream, ncb).double()
    bmm = tpm.pair_matmul_plain(a, b, *stream, ncb=ncb).double()
    err = float((model - exact).abs().max())
    assert 0.0 < err <= 4 * float((bmm - exact).abs().max())


def test_split_model_exact_on_patterns():
    rng = np.random.default_rng(4)
    a = torch.from_numpy((rng.random((12, BS, BS)) < 0.8).astype(np.float32))
    b = torch.from_numpy((rng.random((10, BS, BS)) < 0.8).astype(np.float32))
    ncb = 3
    # C block 0: 40 pairs (sums up to 40 * 128 = 5120), 1: none, 2: three
    cb = np.array([0] * 40 + [2] * 3, np.int32)
    live = np.ones(43, bool)
    live[[0, 39, 41]] = False
    stream = [torch.from_numpy(x) for x in (
        rng.integers(0, 12, 43).astype(np.int32),
        rng.integers(0, 10, 43).astype(np.int32), cb, live)]
    got = split_tf32_model(a, b, *stream, ncb)
    assert torch.equal(got, tpm.pair_matmul_plain(a, b, *stream, ncb=ncb))
    assert float(got[0].max()) > 2**11


def test_plain_checks_pair_order():
    a = torch.zeros((2, BS, BS))
    i = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="nondecreasing"):
        tpm.pair_matmul_f32(a, a, i, i, torch.tensor([1, 0],
                                                     dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32), ncb=2)


@pytest.mark.parametrize("bad", ["dtype", "pair_dtype", "length", "shape"])
def test_argument_checks(bad):
    a = torch.zeros((2, BS, BS), dtype=torch.float64)
    i = torch.tensor([0, 1], dtype=torch.int32)
    args = dict(a=a, b=a, pair_a=i, pair_b=i, pair_cb=i,
                live=torch.ones(2, dtype=torch.int32))
    fn = tpm.pair_matmul_f64
    if bad == "dtype":
        fn = tpm.pair_matmul_f32
    elif bad == "pair_dtype":
        args["pair_a"] = i.long()
    elif bad == "length":
        args["live"] = torch.ones(3, dtype=torch.int32)
    else:
        args["b"] = torch.zeros((2, 64, BS), dtype=torch.float64)
    with pytest.raises(ValueError):
        fn(**args, ncb=2)


def test_cpu_takes_plain_without_launch():
    rng = np.random.default_rng(3)
    a = blocks(rng, 3)
    pa = np.array([0, 1, 2], np.int32)
    cb = np.array([0, 0, 1], np.int32)
    before = (tpm.pair_matmul_f32.launches, tpm.pair_matmul_f64.launches)
    got = port(tpm.pair_matmul_f64, a, a, pa, pa, cb, np.ones(3, bool), 2,
               torch.float64)
    assert np.allclose(got[0], a[0] @ a[0] + a[1] @ a[1], rtol=1e-12)
    assert (tpm.pair_matmul_f32.launches,
            tpm.pair_matmul_f64.launches) == before


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_block_gather_matches_jax(dtype):
    rng = np.random.default_rng(5)
    table = (rng.standard_normal((6, 16, 128)) * 100).astype(dtype)
    idx = np.array([3, 3, 0, 5, 1, 3, 0], np.int32)     # repeated indices
    got = tpm.block_gather(torch.from_numpy(table),
                           torch.from_numpy(idx)).numpy()
    want = np.asarray(jpg.block_gather(jnp.asarray(table), jnp.asarray(idx),
                                       interpret=True))
    assert got.dtype == dtype
    assert np.array_equal(got, want) and np.array_equal(got, table[idx])


def test_block_gather_f64_matches_take():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((5, 8, 128))
    idx = np.array([4, 0, 0, 2], np.int32)
    got = tpm.block_gather(torch.from_numpy(table),
                           torch.from_numpy(idx)).numpy()
    want = np.asarray(jpg.block_gather_any(jnp.asarray(table),
                                           jnp.asarray(idx)))
    assert got.dtype == np.float64 and np.array_equal(got, want)
