"""The port's ``ragged_fill`` and slab-form ``esc_tail`` (their plain
versions, which CPU tensors take) against the JAX package's Pallas kernels
run in interpreter mode, on the same numpy inputs.

- ``ragged_fill``: compared on the words some run covers (the rest are
  undefined in both), exactly, for 1 and 3 planes: on the fill plans of
  the bucketed planner and on synthetic run sets with runs that cross the
  half-window grid, zero-length runs and the largest window (128 rows).
- ``esc_tail`` with ``row_len < w2`` (garbage keys past each row's
  count): keys and counts exact; f32 values exact (the plain version
  adds in the kernels' order); f64 values within 1e-9 * max(1, |ref|)
  against the JAX kernel on the Dekker-split inputs (that kernel adds
  double-f32 pairs, the port native f64).

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mh_spgemm_tpu.ops import esc_tail as jet
from mh_spgemm_tpu.ops import ragged_fill as jrf
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import esc_tail as tet
from mh_spgemm_torch.ops import ragged_fill as trf

I32_MAX = 2**31 - 1


def covered(win_row, runs, ow: int, nplanes: int, dst_stride: int):
    """Bool mask of the output words the runs of one chunk write."""
    cov = np.zeros(ow, bool)
    for g in range(win_row.shape[0]):
        for src, dst, ln in runs[g, : win_row[g, 1]]:
            for p in range(nplanes):
                lo = dst + p * dst_stride
                cov[lo: lo + max(0, ln)] = True
    return cov


def check_chunks(win_row, runs, pairs, *, out_rows, wrows, nplanes,
                 src_stride_rows, dst_stride):
    """The port over all chunks in one call against the JAX kernel per
    chunk, exactly, on covered words."""
    kw = dict(out_rows=out_rows, nplanes=nplanes,
              src_stride_rows=src_stride_rows, dst_stride=dst_stride)
    got = trf.ragged_fill(torch.from_numpy(win_row), torch.from_numpy(runs),
                          torch.from_numpy(pairs), **kw).numpy()
    assert got.shape == win_row.shape[:-2] + (out_rows + trf.PAD_ROWS, 128)
    ncov = 0
    for k in range(win_row.shape[0]):
        want = np.asarray(jrf.ragged_fill(
            jnp.asarray(win_row[k]), jnp.asarray(runs[k]),
            jnp.asarray(pairs), wrows=wrows, interpret=True, **kw))
        cov = covered(win_row[k], runs[k], want.size, nplanes, dst_stride)
        assert np.array_equal(got[k].reshape(-1)[cov],
                              want.reshape(-1)[cov]), k
        ncov += int(cov.sum())
    return ncov


@pytest.mark.parametrize("vwords", [2, 1], ids=["3planes_f64",
                                                "2planes_f32"])
def test_fill_plan_matches_jax(vwords):
    """A fill class of the planner (forced), all its chunks in one call,
    on B's planar stream."""
    A = gen.powerlaw(150, avg_nnz=5, max_row=40, seed=3)
    plan = tbk.plan_buckets(A.ptr, A.col, A.ptr, vwords=vwords,
                            dma_fill="on", area_cap=1 << 12)
    c = max((c for c in plan.classes if c.fill),
            key=lambda c: c.W * c.rb * c.nchunks)
    vals = A.val.astype(np.float64 if vwords == 2 else np.float32)
    pairs = tbk.build_pairs_planar(A.col, vals, vwords, c.wrows)
    stride = 1 + vwords
    n = check_chunks(c.win_row, c.runs, pairs, out_rows=stride * c.out_rows,
                     wrows=c.wrows, nplanes=stride,
                     src_stride_rows=pairs.shape[0] // stride,
                     dst_stride=c.out_rows * 128)
    assert n == stride * int(c.row_len.sum())


def synthetic_runs(rng, nplanes: int, wrows: int, nruns: int,
                   out_slots: int):
    """Runs with disjoint destinations, lengths 0..SW (some crossing the
    half-window grid, some of length 0), grouped by the planner's own
    ``_group_runs``; plus a source stream with distinct words."""
    SW = wrows * 64
    ln = rng.integers(0, SW // 4 + 1, nruns)
    ln[:3] = [0, SW, SW - 1]
    gaps = rng.integers(0, 50, nruns)
    dst = np.cumsum(gaps + ln) - ln
    keep = dst + ln <= out_slots
    dst, ln = dst[keep], ln[keep]
    src = rng.integers(0, 20 * SW, dst.size)
    live = ln > 0
    win_row, runs = tbk._group_runs(src[live], dst[live], ln[live], wrows,
                                    tbk._FILL_EPG)
    # zero-length runs inside the live count are no-ops
    runs[0, 0, 2] = 0
    pitch = -(-(tbk._FILL_BIAS_WORDS + 22 * SW) // 128) + wrows \
        + trf.PAD_ROWS
    pairs = rng.integers(-2**31, 2**31 - 1, (nplanes * pitch, 128),
                         dtype=np.int64).astype(np.int32)
    return win_row[None], runs[None], pairs, pitch


@pytest.mark.parametrize("nplanes", [1, 3])
@pytest.mark.parametrize("wrows", [16, 128])
def test_synthetic_runs_match_jax(nplanes, wrows):
    rng = np.random.default_rng(10 * nplanes + wrows)
    out_slots = 12 * wrows * 128
    win_row, runs, pairs, pitch = synthetic_runs(rng, nplanes, wrows, 40,
                                                 out_slots)
    live = runs[0, :, :, 2] > 0
    assert (runs[0, :, :, 0][live] % 128 != 0).any()  # unaligned sources
    assert (runs[0, :, :, 2] == wrows * 64).any()      # a full-window run
    n = check_chunks(win_row, runs, pairs,
                     out_rows=nplanes * out_slots // 128,
                     wrows=wrows, nplanes=nplanes, src_stride_rows=pitch,
                     dst_stride=out_slots)
    assert n > 0


def test_batched_call_equals_per_chunk_calls():
    rng = np.random.default_rng(5)
    parts = [synthetic_runs(rng, 2, 32, 20, 24 * 128) for _ in range(2)]
    S = max(p[0].shape[1] for p in parts)
    win_row = np.zeros((2, S, 2), np.int32)
    runs = np.zeros((2, S, tbk._FILL_EPG, 3), np.int32)
    for k, (w, r, _, _) in enumerate(parts):
        win_row[k, : w.shape[1]] = w[0]
        runs[k, : r.shape[1]] = r[0]
    pairs, pitch = parts[0][2], parts[0][3]
    kw = dict(out_rows=48, nplanes=2, src_stride_rows=pitch,
              dst_stride=24 * 128)
    both = trf.ragged_fill(torch.from_numpy(win_row), torch.from_numpy(runs),
                           torch.from_numpy(pairs), **kw)
    for k in range(2):
        one = trf.ragged_fill(torch.from_numpy(win_row[k]),
                              torch.from_numpy(runs[k]),
                              torch.from_numpy(pairs), **kw)
        assert torch.equal(both[k], one)


def test_fill_cpu_takes_the_plain_version_and_checks_shapes():
    rng = np.random.default_rng(1)
    win_row, runs, pairs, pitch = synthetic_runs(rng, 1, 16, 8, 8 * 128)
    before = trf.ragged_fill.launches
    trf.ragged_fill(torch.from_numpy(win_row), torch.from_numpy(runs),
                    torch.from_numpy(pairs), out_rows=8)
    assert trf.ragged_fill.launches == before
    with pytest.raises(ValueError):
        trf.ragged_fill(torch.from_numpy(win_row).long(),
                        torch.from_numpy(runs), torch.from_numpy(pairs),
                        out_rows=8)
    with pytest.raises(ValueError):
        trf.ragged_fill(torch.from_numpy(win_row), torch.from_numpy(runs),
                        torch.from_numpy(pairs).view(-1, 64), out_rows=8)


def slab_inputs(w2: int, rows: int, seed: int):
    """Duplicate-heavy keys with garbage past each row's count (row 0
    empty, row 1 full of one key, the rest random counts)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, w2 // 2), (rows, w2)).astype(np.int32)
    row_len = rng.integers(0, w2, rows).astype(np.int32)
    row_len[0] = 0
    keys[1] = 3
    row_len[1] = w2
    vals = rng.standard_normal((rows, w2))
    return keys, vals, row_len


def jax_slab(keys, vhi, vlo, row_len, w2, f64):
    ok, oh, ol = jet.esc_tail(jnp.asarray(keys), jnp.asarray(vhi),
                              jnp.asarray(vlo), jnp.asarray(row_len), w2=w2,
                              f64=f64, interpret=True)
    return np.asarray(ok), np.asarray(oh), None if ol is None \
        else np.asarray(ol)


@pytest.mark.parametrize("w2", [2, 8, 64, 256])
def test_slab_tail_f32_matches_jax_exactly(w2):
    keys, vals, row_len = slab_inputs(w2, max(4, 1024 // w2), seed=w2)
    v32 = vals.astype(np.float32)
    rK, rH, _ = jax_slab(keys, v32.view(np.int32), v32.view(np.int32),
                         row_len, w2, f64=False)
    oK, oV, cnt = tet.esc_tail(torch.from_numpy(keys), torch.from_numpy(v32),
                               torch.from_numpy(row_len), w2=w2)
    live = rK < I32_MAX
    assert np.array_equal(oK.numpy(), rK)
    assert np.array_equal(cnt.numpy(), live.sum(axis=1))
    assert np.array_equal(oV.numpy()[live], rH.view(np.float32)[live])
    assert np.all(oV.numpy()[~live] == 0.0)


@pytest.mark.parametrize("w2", [2, 8, 64, 256])
def test_slab_tail_f64_matches_jax(w2):
    keys, vals, row_len = slab_inputs(w2, max(4, 1024 // w2), seed=50 + w2)
    hi, lo = jet.dekker_split_np(vals)
    rK, rH, rL = jax_slab(keys, hi.view(np.int32), lo.view(np.int32),
                          row_len, w2, f64=True)
    ref = (rH.view(np.float32).astype(np.float64)
           + rL.view(np.float32).astype(np.float64))
    oK, oV, cnt = tet.esc_tail(torch.from_numpy(keys),
                               torch.from_numpy(vals),
                               torch.from_numpy(row_len), w2=w2)
    live = rK < I32_MAX
    assert np.array_equal(oK.numpy(), rK)
    assert np.array_equal(cnt.numpy(), live.sum(axis=1))
    err = np.abs(oV.numpy()[live] - ref[live])
    assert np.all(err <= 1e-9 * np.maximum(1.0, np.abs(ref[live])))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("w2", [1024, 16384])
def test_slab_tail_against_numpy_sort(w2, dtype):
    """At widths where interpreter mode is slow, against a reference by
    np.unique and np.add.at that shares nothing of the bitonic network:
    keys and counts exact, values within 1e-9 (f64) or 1e-4 (f32) of the
    summed magnitudes of each key's terms."""
    keys, vals, row_len = slab_inputs(w2, 3, seed=w2 + 1)
    vals = vals.astype(dtype)
    oK, oV, cnt = tet.esc_tail(torch.from_numpy(keys), torch.from_numpy(vals),
                               torch.from_numpy(row_len), w2=w2)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    for r in range(keys.shape[0]):
        k, v = keys[r, :row_len[r]], vals[r, :row_len[r]].astype(np.float64)
        uk, inv = np.unique(k, return_inverse=True)
        sums, mags = np.zeros(uk.size), np.zeros(uk.size)
        np.add.at(sums, inv, v)
        np.add.at(mags, inv, np.abs(v))
        assert np.array_equal(oK[r, :uk.size].numpy(), uk)
        assert np.all(oK[r, uk.size:].numpy() == I32_MAX)
        assert int(cnt[r]) == uk.size
        err = np.abs(oV[r, :uk.size].numpy().astype(np.float64) - sums)
        assert np.all(err <= tol * np.maximum(1.0, mags)), float(err.max())


def test_slab_tail_ignores_words_past_row_len():
    """NaN values and random keys past a row's count change nothing."""
    keys, vals, row_len = slab_inputs(64, 16, seed=3)
    past = np.arange(64)[None, :] >= row_len[:, None]
    k2, v2 = keys.copy(), vals.copy()
    k2[past] = 9
    v2[past] = np.nan
    a = tet.esc_tail(torch.from_numpy(keys), torch.from_numpy(vals),
                     torch.from_numpy(row_len), w2=64)
    b = tet.esc_tail(torch.from_numpy(k2), torch.from_numpy(v2),
                     torch.from_numpy(row_len), w2=64)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_slab_tail_wrapper_checks():
    keys = torch.zeros((4, 8), dtype=torch.int32)
    vals = torch.zeros((4, 8), dtype=torch.float64)
    rl = torch.zeros(4, dtype=torch.int32)
    before = tet.esc_tail.launches
    tet.esc_tail(keys, vals, rl, w2=8)
    assert tet.esc_tail.launches == before
    with pytest.raises(ValueError):
        tet.esc_tail(keys, vals, rl.long(), w2=8)
    with pytest.raises(ValueError):
        tet.esc_tail(keys, vals, rl, w2=4)
    with pytest.raises(ValueError):
        tet.esc_tail(keys, vals.t().contiguous().t(), rl, w2=8)
