"""Edge shapes of the ESC tail, both forms, the port's (plain version on
the CPU) against the JAX package's ``esc_tail_flat`` and ``esc_tail`` in
Pallas interpreter mode, on the same numpy inputs: slot counts that are
not a multiple of the CUDA kernel's tile (256 slots a warp on its warp
path, w2 <= 256; max(w2, 2048) a block on its tile path, 512 <= w2 <=
8192), so its last tile is partial; a whole tile of one key, a tile of
empty rows and a tile of full rows in descending key order.  At the tile path's widths (512, 1024, 8192) the
same shapes are held against a numpy reference instead (interpreter mode
is slow at those widths).

Tolerances as in tests/test_torch_esc_tail.py and
tests/test_torch_ragged_fill.py: keys and counts exact; f64 values within
1e-9 * max(1, |ref|) (the JAX kernel adds double-f32 pairs); f32 slab
values bit for bit, f32 flat values within 1e-4 absolute and relative.
The same shapes run on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mh_spgemm_tpu.ops import esc_tail as jet
from mh_spgemm_torch.ops import esc_tail as tet

I32_MAX = 2**31 - 1


def partial_tile(w2: int, rows: int):
    """Duplicate-heavy keys, random row counts (row 0 full), random keys
    and values past each row's count."""
    rng = np.random.default_rng(w2 * rows)
    keys = rng.integers(0, max(2, w2 // 4), (rows, w2)).astype(np.int32)
    row_len = rng.integers(0, w2 + 1, rows).astype(np.int32)
    row_len[0] = w2
    return keys, rng.standard_normal((rows, w2)), row_len


def equal_and_empty_tiles(w2: int):
    """One kernel tile (256 slots on the warp path, max(w2, 2048) on the
    tile path) of one key, one of empty rows (random keys and values past
    their count 0), one of full rows of distinct keys in descending
    order."""
    per = (256 if w2 <= 256 else max(w2, 2048)) // w2
    rng = np.random.default_rng(w2)
    keys = np.empty((3 * per, w2), dtype=np.int32)
    keys[:per] = 12345
    keys[per:2 * per] = rng.integers(0, 9, (per, w2))
    keys[2 * per:] = np.arange(w2)[::-1][None, :]
    row_len = np.full(3 * per, w2, dtype=np.int32)
    row_len[per:2 * per] = 0
    return keys, rng.standard_normal(keys.shape), row_len


def value_planes(vals, f64: bool):
    """The JAX kernel's value planes: the Dekker split of f64 values, or
    the f32 bits twice."""
    if f64:
        hi, lo = jet.dekker_split_np(vals)
        return hi.view(np.int32), lo.view(np.int32)
    v32 = vals.astype(np.float32).view(np.int32)
    return v32, v32


def jax_values(oh, ol):
    out = np.asarray(oh).view(np.float32).astype(np.float64)
    if ol is not None:
        out = out + np.asarray(ol).view(np.float32).astype(np.float64)
    return out


def check_values(pV, rV, live, f64: bool, exact: bool):
    if f64:
        err = np.abs(pV[live] - rV[live])
        assert np.all(err <= 1e-9 * np.maximum(1.0, np.abs(rV[live])))
    elif exact:
        assert np.array_equal(pV[live].astype(np.float32),
                              rV[live].astype(np.float32))
    else:
        err = np.abs(pV[live] - rV[live])
        assert np.all(err <= 1e-4 + 1e-4 * np.abs(rV[live]))
    assert np.all(pV[~live] == 0.0)


def check_both_forms(keys, vals, row_len, dtype):
    """The slab form on (keys, vals, row_len), then the flat form on the
    same slots with those past each count emptied, against JAX."""
    rows, w2 = keys.shape
    f64 = dtype == torch.float64
    vals = vals if f64 else vals.astype(np.float32).astype(np.float64)
    vhi, vlo = value_planes(vals, f64)

    rK, rH, rL = jet.esc_tail(jnp.asarray(keys), jnp.asarray(vhi),
                              jnp.asarray(vlo), jnp.asarray(row_len), w2=w2,
                              f64=f64, interpret=True)
    rK, rV = np.asarray(rK), jax_values(rH, rL)
    oK, oV, cnt = tet.esc_tail(torch.from_numpy(keys),
                               torch.from_numpy(vals).to(dtype),
                               torch.from_numpy(row_len), w2=w2)
    live = rK < I32_MAX
    assert np.array_equal(oK.numpy(), rK)
    assert np.array_equal(cnt.numpy(), live.sum(axis=1))
    check_values(oV.double().numpy(), rV, live, f64, exact=True)

    dead = np.arange(w2)[None, :] >= row_len[:, None]
    fk = np.where(dead, I32_MAX, keys).astype(np.int32).reshape(-1)
    fv = np.where(dead, 0.0, vals).reshape(-1)
    fhi, flo = value_planes(fv, f64)
    rK, rH, rL = jet.esc_tail_flat(jnp.asarray(fk), jnp.asarray(fhi),
                                   jnp.asarray(flo), w2=w2, f64=f64,
                                   interpret=True)
    rK, rV = np.asarray(rK), jax_values(rH, rL)
    oK, oV, cnt = tet.esc_tail_flat(torch.from_numpy(fk),
                                    torch.from_numpy(fv).to(dtype), w2=w2)
    live = rK < I32_MAX
    assert np.array_equal(oK.numpy(), rK)
    assert np.array_equal(cnt.numpy(), live.reshape(rows, w2).sum(axis=1))
    check_values(oV.double().numpy(), rV, live, f64, exact=False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2,rows", [(8, 5), (64, 3)])
def test_partial_tile_matches_jax(w2, rows, dtype):
    check_both_forms(*partial_tile(w2, rows), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [2, 32, 256])
def test_equal_keys_and_empty_tiles_match_jax(w2, dtype):
    check_both_forms(*equal_and_empty_tiles(w2), dtype)


def numpy_rows(keys, vals, row_len):
    """Per row: the distinct keys under the row's count ascending, their
    summed values (f64) and the count, left-packed and padded with
    2^31-1 and 0."""
    rows, w2 = keys.shape
    out_k = np.full((rows, w2), I32_MAX, dtype=np.int32)
    out_v = np.zeros((rows, w2))
    cnt = np.zeros(rows, dtype=np.int32)
    for r in range(rows):
        k, v = keys[r, :row_len[r]], vals[r, :row_len[r]]
        uk, inv = np.unique(k, return_inverse=True)
        out_k[r, :uk.size] = uk
        out_v[r, :uk.size] = np.bincount(inv, weights=v, minlength=uk.size)
        cnt[r] = uk.size
    return out_k, out_v, cnt


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", ["partial", "equal_and_empty"])
@pytest.mark.parametrize("w2", [512, 1024, 8192])
def test_tile_width_edges_match_numpy(w2, shape, dtype):
    """The tile path's widths: both forms of the port's tail on the edge
    shapes against :func:`numpy_rows` (keys and counts exact; values
    within 1e-9 (f64) or 1e-4 (f32) of the summed magnitudes).  Numpy is
    the reference here: the JAX package's interpreter mode compiles
    slowly at these widths."""
    keys, vals, row_len = (partial_tile(w2, 3) if shape == "partial"
                           else equal_and_empty_tiles(w2))
    f64 = dtype == torch.float64
    vals = vals if f64 else vals.astype(np.float32).astype(np.float64)
    rK, rV, rc = numpy_rows(keys, vals, row_len)
    _, mag, _ = numpy_rows(keys, np.abs(vals), row_len)
    tol = 1e-9 if f64 else 1e-4
    dead = np.arange(w2)[None, :] >= row_len[:, None]
    fk = np.where(dead, I32_MAX, keys).astype(np.int32).reshape(-1)
    fv = np.where(dead, 0.0, vals).reshape(-1)
    for oK, oV, cnt in (
            tet.esc_tail(torch.from_numpy(keys),
                         torch.from_numpy(vals).to(dtype),
                         torch.from_numpy(row_len), w2=w2),
            tet.esc_tail_flat(torch.from_numpy(fk),
                              torch.from_numpy(fv).to(dtype), w2=w2)):
        assert np.array_equal(oK.numpy().reshape(rK.shape), rK)
        assert np.array_equal(cnt.numpy(), rc)
        err = np.abs(oV.double().numpy().reshape(rV.shape) - rV)
        assert np.all(err <= tol * np.maximum(1.0, mag))
