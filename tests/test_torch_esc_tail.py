"""The port's flat ESC tail (mh_spgemm_torch.ops.esc_tail) against the JAX
package's ``esc_tail_flat`` run in Pallas interpreter mode, on the same
numpy inputs.

Tolerances: f64 values within 1e-9 * max(1, |ref|) — the JAX kernel
accumulates double-f32 (hi, lo) pairs (relative error ~2^-47 per add)
while the port adds in f64; f32 values within 1e-4 absolute and relative
(f32 sums in a different order).  Keys and per-segment counts are exact.

The comparison of the CUDA kernel with the plain version on the card is
in tests/test_torch_cuda.py, which imports no JAX and so runs on a
machine that has only torch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mh_spgemm_tpu.ops import esc_tail as jet
from mh_spgemm_torch.ops import esc_tail as tet

I32_MAX = 2**31 - 1


def tail_inputs(w2: int, nseg: int, seed: int):
    """Duplicate-heavy keys; segment 0 empty, segment 1 all one key,
    the rest with random valid lengths; empty slots carry 2^31-1, 0."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, w2 // 2), (nseg, w2)).astype(np.int32)
    n = rng.integers(0, w2 + 1, nseg)
    n[0] = 0
    keys[1] = 5
    n[1] = w2
    keys[np.arange(w2)[None, :] >= n[:, None]] = I32_MAX
    vals = rng.standard_normal((nseg, w2))
    vals[keys == I32_MAX] = 0.0
    return keys.reshape(-1), vals.reshape(-1)


def run_jax(keys, vals, w2: int, f64: bool):
    """JAX esc_tail_flat in interpreter mode; f64 values go in as their
    Dekker split.  Returns (keys, values as f64)."""
    if f64:
        hi, lo = jet.dekker_split_np(vals)
        vhi, vlo = hi.view(np.int32), lo.view(np.int32)
    else:
        vhi = vlo = vals.astype(np.float32).view(np.int32)
    ok, oh, ol = jet.esc_tail_flat(jnp.asarray(keys), jnp.asarray(vhi),
                                   jnp.asarray(vlo), w2=w2, f64=f64,
                                   interpret=True)
    out = np.asarray(oh).view(np.float32).astype(np.float64)
    if f64:
        out = out + np.asarray(ol).view(np.float32).astype(np.float64)
    return np.asarray(ok), out


def run_port(keys, vals, w2: int, dtype):
    oK, oV, cnt = tet.esc_tail_flat(torch.from_numpy(keys),
                                    torch.from_numpy(vals).to(dtype), w2=w2)
    return oK.numpy(), oV.to(torch.float64).numpy(), cnt.numpy()


def numpy_tail(keys, vals, w2: int):
    """Per-segment reference: unique keys ascending, summed values."""
    oK = np.full(keys.size, I32_MAX, np.int32)
    oV = np.zeros(keys.size)
    for s in range(keys.size // w2):
        k = keys[s * w2:(s + 1) * w2]
        v = vals[s * w2:(s + 1) * w2]
        live = k < I32_MAX
        uk, inv = np.unique(k[live], return_inverse=True)
        sums = np.zeros(uk.size)
        np.add.at(sums, inv, v[live])
        oK[s * w2: s * w2 + uk.size] = uk
        oV[s * w2: s * w2 + uk.size] = sums
    return oK, oV


def check_against(pK, pV, cnt, rK, rV, w2, rtol, atol):
    assert np.array_equal(pK, rK)
    live = rK < I32_MAX
    err = np.abs(pV[live] - rV[live])
    assert np.all(err <= atol + rtol * np.abs(rV[live])), float(err.max())
    assert np.all(pV[~live] == 0.0)
    assert np.array_equal(cnt, live.reshape(-1, w2).sum(axis=1))


@pytest.mark.parametrize("w2", [2, 4, 8, 32, 128, 1024])
def test_flat_tail_f64_matches_jax(w2):
    keys, vals = tail_inputs(w2, max(4, 2048 // w2), seed=w2)
    rK, rV = run_jax(keys, vals, w2, f64=True)
    pK, pV, cnt = run_port(keys, vals, w2, torch.float64)
    assert np.array_equal(pK, rK)
    live = rK < I32_MAX
    err = np.abs(pV[live] - rV[live])
    assert np.all(err <= 1e-9 * np.maximum(1.0, np.abs(rV[live])))
    assert np.all(pV[~live] == 0.0)
    assert np.array_equal(cnt, live.reshape(-1, w2).sum(axis=1))


@pytest.mark.parametrize("w2", [2, 4, 8, 32, 128, 1024])
def test_flat_tail_f32_matches_jax(w2):
    keys, vals = tail_inputs(w2, max(4, 2048 // w2), seed=100 + w2)
    rK, rV = run_jax(keys, vals, w2, f64=False)
    pK, pV, cnt = run_port(keys, vals.astype(np.float32), w2,
                           torch.float32)
    check_against(pK, pV, cnt, rK, rV, w2, rtol=1e-4, atol=1e-4)


def test_flat_tail_cancellation():
    """Pairs (+x, -x) plus a tiny residual, all on one key: absolute
    error under 1e-9 in both packages against the f64 sum."""
    w2, nseg = 128, 8
    rng = np.random.default_rng(11)
    x = rng.uniform(1.0, 100.0, (nseg, w2 // 2))
    vals = np.zeros((nseg, w2))
    vals[:, 0::2] = x
    vals[:, 1::2] = -x
    vals[:, 1] += 1e-7
    keys = np.zeros((nseg, w2), np.int32).reshape(-1)
    ref = vals.sum(axis=1)
    vals = vals.reshape(-1)
    rK, rV = run_jax(keys, vals, w2, f64=True)
    pK, pV, cnt = run_port(keys, vals, w2, torch.float64)
    assert np.array_equal(pK, rK)
    assert np.all(np.abs(rV[::w2] - ref) < 1e-9)
    assert np.all(np.abs(pV[::w2] - ref) < 1e-9)
    assert np.all(cnt == 1)


def test_flat_tail_wide_against_numpy():
    """w2 = 16384 (the kernel's wide path) against a numpy reference
    only: interpreter mode is slow at this width."""
    w2 = 16384
    keys, vals = tail_inputs(w2, 3, seed=7)
    rK, rV = numpy_tail(keys, vals, w2)
    pK, pV, cnt = run_port(keys, vals, w2, torch.float64)
    check_against(pK, pV, cnt, rK, rV, w2, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 96, 1024, 3 << 10, 65536,
                               1 << 17])
def test_supported_w2_matches_jax(w):
    assert tet.supported_w2(w) == jet.supported_w2(w)


def test_wrapper_rejects_bad_shapes():
    keys = torch.zeros(12, dtype=torch.int32)
    vals = torch.zeros(12, dtype=torch.float64)
    with pytest.raises(ValueError):
        tet.esc_tail_flat(keys, vals, w2=8)           # 12 % 8 != 0
    with pytest.raises(ValueError):
        tet.esc_tail_flat(keys, vals, w2=3)           # not a power of two
    with pytest.raises(ValueError):
        tet.esc_tail_flat(keys.long(), vals, w2=4)    # keys not int32


def test_cpu_tensors_take_the_plain_version():
    keys, vals = tail_inputs(8, 16, seed=1)
    before = tet.esc_tail_flat.launches
    run_port(keys, vals, 8, torch.float64)
    assert tet.esc_tail_flat.launches == before
