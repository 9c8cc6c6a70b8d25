"""CUDA-only tests of the PyTorch port: each kernel (esc_tail_flat and its
slab form esc_tail, ragged_fill, the two pair matmuls, block_gather,
pgather, proute and halo_exchange) against its plain PyTorch version on
the card, and the bucketed (with and without the fill frontend, planned
and not), block-dense (with the windowed extraction), masked,
DeviceCSR-level (ESC and product-granularity masked, warm calls with no
host sync) and distributed (bucketed and ESC) engines on the card
against the scipy oracle, halo_exchange into a subset of the receiving
shards, two ranks of ``parallel.worker`` sharing the card (CUDA IPC), and the structured catalog's repaired and
degenerate cases through the engines, cold and warm.  They skip
where there is no CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only torch: ``python -m pytest --noconftest
tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import bucketed as bk
from mh_spgemm_torch.ops import esc_tail as et
from mh_spgemm_torch.ops import pair_matmul as pm
from mh_spgemm_torch.ops import planned as pn
from mh_spgemm_torch.ops import ragged_fill as rf
from mh_spgemm_torch.ops import remote_fetch as rfx
from mh_spgemm_torch.parallel.mesh import make_row_mesh
from mh_spgemm_torch.parallel.spgemm_dist import spgemm_dist
from mh_spgemm_torch.pipeline import (BucketedState, spgemm_blockdense,
                                      spgemm_bucketed, spgemm_masked)

I32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tail_inputs(w2: int, nseg: int, seed: int):
    """Keys with duplicate-heavy segments, empty segments, one all-same
    segment and invalid tails; values standard normal."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, w2 // 4), (nseg, w2)).astype(np.int32)
    n = rng.integers(0, w2 + 1, nseg)
    n[0] = 0                                  # an empty segment
    if nseg > 1:
        keys[1] = 7                           # every key the same
        n[1] = w2
    keys[np.arange(w2)[None, :] >= n[:, None]] = I32_MAX
    vals = rng.standard_normal((nseg, w2))
    vals[keys == I32_MAX] = 0.0
    return keys.reshape(-1), vals.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                                2048, 4096, 8192, 16384, 32768, 65536,
                                131072])
def test_kernel_matches_plain(cuda, w2, dtype):
    nseg = max(3, (1 << 17) // w2)
    k, v = tail_inputs(w2, nseg, seed=w2)
    keys = torch.from_numpy(k).to(cuda)
    vals = torch.from_numpy(v).to(dtype).to(cuda)
    before = et.esc_tail_flat.launches
    oK, oV, cnt = et.esc_tail_flat(keys, vals, w2=w2)
    torch.cuda.synchronize()
    assert et.esc_tail_flat.launches == before + 1
    pK, pV, pc = et.esc_tail_flat_plain(keys, vals, w2=w2)
    assert torch.equal(oK, pK)
    assert torch.equal(cnt, pc)
    # every path adds in the plain version's order: bit for bit
    assert torch.equal(oV, pV), float((oV - pV).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_engine_on_card(cuda, value_dtype):
    A = gen.powerlaw(3000, avg_nnz=5, seed=42)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(value_dtype=value_dtype)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    before = et.esc_tail_flat.launches
    state = None
    for _ in range(3):                        # cold, then warm
        C, state = spgemm_bucketed(A, A, config=cfg, state=state,
                                   device=cuda)
        assert C.host().equals(ref, tol=tol)
    assert et.esc_tail_flat.launches > before


def pair_stream(rng, nab: int, nbb: int, ncb: int):
    """Segments of 1..64 pairs, dead pairs, and C blocks with no pair."""
    cb = np.sort(rng.integers(0, ncb, 8 * ncb)).astype(np.int32)
    cb = cb[(cb % 7) != 3]                    # every 7th block gets none
    pa = rng.integers(0, nab, cb.size).astype(np.int32)
    pb = rng.integers(0, nbb, cb.size).astype(np.int32)
    live = (rng.random(cb.size) > 0.1).astype(np.int32)
    return [torch.from_numpy(x) for x in (pa, pb, cb, live)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_matmul_matches_plain(cuda, dtype):
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((40, 128, 128))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((30, 128, 128))).to(dtype)
    ncb = 50
    stream = [t.to(cuda) for t in pair_stream(rng, 40, 30, ncb)]
    fn = pm.pair_matmul_f64 if dtype == torch.float64 else pm.pair_matmul_f32
    before = fn.launches
    out = fn(a.to(cuda), b.to(cuda), *stream, ncb=ncb)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = pm.pair_matmul_plain(a.to(cuda), b.to(cuda), *stream, ncb=ncb)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    err = (out - ref).abs()
    assert bool((err <= tol * torch.clamp(ref.abs(), min=1.0)).all()), \
        float(err.max())
    assert not out[3].any()


def boundary_cases(cuda, dtype, rng):
    """The boundary streams (segments of 1, 2, 3 and 37 pairs, dead pairs
    at their ends, an all-dead C block, empty C blocks; ncb = 1) with
    standard normal blocks of ``dtype``."""
    a = torch.from_numpy(rng.standard_normal((30, 128, 128))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((20, 128, 128))).to(dtype)
    return [(a.to(cuda), b.to(cuda),
              [torch.from_numpy(x).to(cuda) for x in st], ncb)
             for st, ncb in pm.boundary_streams(rng, 30, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_matmul_boundary_streams(cuda, dtype):
    # f64 within 1e-9 absolute or relative; f32 within 1e-4 of the summed
    # magnitudes (the same product over |a| and |b|): segments of 37
    # pairs sum 4736 random-sign terms, whose f32 sums in two orders
    # differ by more than 1e-4 absolute where they cancel
    fn = pm.pair_matmul_f64 if dtype == torch.float64 else pm.pair_matmul_f32
    for a, b, stream, ncb in boundary_cases(cuda, dtype,
                                            np.random.default_rng(13)):
        before = fn.launches
        out = fn(a, b, *stream, ncb=ncb)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = pm.pair_matmul_plain(a, b, *stream, ncb=ncb)
        if dtype == torch.float64:
            bound = 1e-9 * ref.abs().clamp(min=1.0)
        else:
            bound = 1e-4 * pm.pair_matmul_plain(a.abs(), b.abs(), *stream,
                                                ncb=ncb).clamp(min=1.0)
        err = (out - ref).abs()
        assert bool((err <= bound).all()), float(err.max())
        cb, live = stream[2], stream[3]
        empty = torch.ones(ncb, dtype=torch.bool, device=cuda)
        empty[cb[live != 0].long()] = False
        assert not out[empty].any()


@pytest.mark.cuda
def test_pair_matmul_f32_exact_on_patterns(cuda):
    for a, b, stream, ncb in boundary_cases(cuda, torch.float32,
                                            np.random.default_rng(14)):
        pa, pb = (a > 0.3).float(), (b > 0.3).float()
        out = pm.pair_matmul_f32(pa, pb, *stream, ncb=ncb)
        assert torch.equal(out, pm.pair_matmul_plain(pa, pb, *stream,
                                                     ncb=ncb))


@pytest.mark.cuda
def test_pair_matmul_f32_error_within_bmm(cuda):
    # against the f64 product of the same f32 inputs, at most 4 times
    # the error of torch.bmm in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, stream, ncb = boundary_cases(cuda, torch.float32,
                                       np.random.default_rng(15))[0]
    k_err, bmm_err = pm.f32_errors(pm.pair_matmul_f32, a, b, stream, ncb)
    assert 0.0 < k_err <= 4 * bmm_err, (k_err, bmm_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_matmul_refuses_misaligned_blocks(cuda, dtype):
    # a contiguous view one element into its storage passes the shape and
    # contiguity checks; the kernel's 16-byte copies cannot read it, so
    # the wrapper raises before it launches
    fn = pm.pair_matmul_f64 if dtype == torch.float64 else pm.pair_matmul_f32
    n = 4
    buf = torch.zeros(n * 128 * 128 + 1, dtype=dtype, device=cuda)
    off = buf[1:].view(n, 128, 128)
    ok = torch.zeros((n, 128, 128), dtype=dtype, device=cuda)
    stream = [torch.tensor(x, dtype=torch.int32, device=cuda)
              for x in ([0, 1], [2, 3], [0, 0], [1, 1])]
    before = fn.launches
    for a, b in ((off, ok), (ok, off)):
        with pytest.raises(ValueError, match="16-byte"):
            fn(a, b, *stream, ncb=1)
    assert fn.launches == before
    assert not fn(ok, ok, *stream, ncb=1).any()


@pytest.mark.cuda
def test_pair_kernel_info(cuda):
    # what the runtime reports of the built kernels: the f64 kernel keeps
    # two blocks resident per SM, and neither spills
    f64, f32 = pm.kernel_info(torch.float64), pm.kernel_info(torch.float32)
    assert f64["blocks_per_sm"] >= 2 and f32["blocks_per_sm"] >= 1
    assert f64["local_bytes"] == 0 and f32["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.int32])
def test_block_gather_matches_index_select(cuda, dtype):
    rng = np.random.default_rng(12)
    table = torch.from_numpy(rng.integers(-1000, 1000, (20, 128, 128))
                             ).to(dtype).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 20, 57).astype(np.int32)).to(cuda)
    before = pm.block_gather.launches
    out = pm.block_gather(table, idx)
    torch.cuda.synchronize()
    assert pm.block_gather.launches == before + 1
    assert torch.equal(out, table.index_select(0, idx.long()))


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_blockdense_on_card(cuda, value_dtype):
    A = gen.banded(3000, band=60, nnz_per_row=30, seed=4)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(mode="blockdense", value_dtype=value_dtype)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    values = pm.pair_matmul_f64 if value_dtype == "float64" \
        else pm.pair_matmul_f32
    before = (values.launches, pm.pair_matmul_f32.launches)
    state = None
    for _ in range(3):                        # cold, then warm
        C, state = spgemm_blockdense(A, A, config=cfg, state=state,
                                     device=cuda)
        assert C.host().equals(ref, tol=tol)
    assert values.launches > before[0]
    assert pm.pair_matmul_f32.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                                2048, 4096, 16384])
def test_slab_tail_matches_plain(cuda, w2, dtype):
    """The slab form with row counts under w2 (NaN and random keys past
    them), empty and full rows: exact against the plain version, which
    adds in the kernel's order."""
    rng = np.random.default_rng(w2)
    rows = max(3, (1 << 16) // w2)
    keys = rng.integers(0, max(2, w2 // 4), (rows, w2)).astype(np.int32)
    row_len = rng.integers(0, w2 + 1, rows).astype(np.int32)
    row_len[0], row_len[1] = 0, w2
    vals = rng.standard_normal((rows, w2))
    vals[np.arange(w2)[None, :] >= row_len[:, None]] = np.nan
    k, v, rl = (torch.from_numpy(x).to(cuda) for x in (keys, vals, row_len))
    v = v.to(dtype)
    before = et.esc_tail.launches
    out = et.esc_tail(k, v, rl, w2=w2)
    torch.cuda.synchronize()
    assert et.esc_tail.launches == before + 1
    for a, b in zip(out, et.esc_tail_plain(k, v, rl, w2=w2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w2,path", [(2, "warp"), (64, "warp"),
                                     (256, "warp"), (512, "tile"),
                                     (1024, "tile"), (4096, "tile"),
                                     (8192, "tile"), (16384, "wide"),
                                     (65536, "wide"), (131072, "wide")])
def test_tail_kernel_path_by_width(cuda, w2, path):
    """``csrc/esc_tail.cu`` dispatches segments of w2 slots to the path
    that ``esc_tail.path_for`` names (the kernel's C entry
    ``esc_tail_path``, which launches nothing), and serves no width that
    is not a power of two."""
    import ctypes
    from mh_spgemm_torch import _build
    fn = _build.load("esc_tail").esc_tail_path
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_int
    assert ("warp", "tile", "wide")[fn(w2)] == path == et.path_for(w2)
    assert fn(w2 * 3) == -1


def tile_rows(w2: int) -> int:
    """Rows of one kernel tile at segment width w2: 256 slots a warp on
    the warp path, max(w2, 2048) a block on the tile path."""
    return (256 if w2 <= 256 else max(w2, 2048)) // w2


def slab_on_card(keys, vals, row_len, dtype, offset: int):
    """The slab's planes on the card, each a view ``offset`` elements into
    its buffer (not on a 16-byte boundary for an odd offset)."""
    dev = torch.device("cuda")

    def view(x, dt):
        buf = torch.zeros(offset + x.size, dtype=dt, device=dev)
        buf[offset:] = torch.from_numpy(x.reshape(-1)).to(dev, dt)
        return buf[offset:].view(x.shape)

    return (view(keys, torch.int32), view(vals, dtype),
            torch.from_numpy(row_len).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("W", [3, 5, 6, 12, 24, 48, 96, 100, 192, 384, 768,
                               1536, 3072, 6144, 8191])
def test_padded_slab_tail_matches_plain(cuda, W, dtype, offset):
    """Rows of W slots, W not a power of two, sorted in segments of the
    next power of two: bit for bit the plain version (which pads by hand),
    one launch, with a partial last tile where a tile holds more than one
    row, row counts under W (NaN and random keys past them), an empty and
    a full row; 16-byte lane copies where W is a multiple of 4 and the
    planes are aligned, slot by slot otherwise."""
    w2 = et.pad_w2(W)
    per = tile_rows(w2)
    rows = per * max(3, (1 << 16) // (per * w2)) + max(1, per // 2)
    rng = np.random.default_rng(W)
    keys = rng.integers(0, max(2, W // 4), (rows, W)).astype(np.int32)
    row_len = rng.integers(0, W + 1, rows).astype(np.int32)
    row_len[0], row_len[1] = W, 0
    vals = rng.standard_normal((rows, W))
    vals[np.arange(W)[None, :] >= row_len[:, None]] = np.nan
    k, v, rl = slab_on_card(keys, vals, row_len, dtype, offset)
    before = et.esc_tail.launches
    out = et.esc_tail(k, v, rl, w2=w2)
    torch.cuda.synchronize()
    assert et.esc_tail.launches == before + 1
    for a, b in zip(out, et.esc_tail_plain(k, v, rl, w2=w2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                                2048, 4096, 8192])
def test_pow2_slab_tail_unchanged(cuda, w2, dtype):
    """At W = w2 the kernel keeps the contract that held it before rows
    could be padded: bit for bit the bitonic network and scan of
    ``_tail_plain`` on the masked [rows, w2] slab itself (the plain
    version the earlier kernel equalled), a partial last tile included."""
    per = tile_rows(w2)
    rows = per * max(3, (1 << 16) // (per * w2)) + max(1, per // 2)
    rng = np.random.default_rng(w2 + 7)
    keys = rng.integers(0, max(2, w2 // 4), (rows, w2)).astype(np.int32)
    row_len = rng.integers(0, w2 + 1, rows).astype(np.int32)
    vals = rng.standard_normal((rows, w2))
    k, v, rl = slab_on_card(keys, vals, row_len, dtype, 0)
    oK, oV, cnt = et.esc_tail(k, v, rl, w2=w2)
    live = torch.arange(w2, device=cuda)[None, :] < rl.long()[:, None]
    pK, pV, pc = et._tail_plain(torch.where(live, k, I32_MAX),
                                torch.where(live, v, 0.0))
    assert torch.equal(oK.view(-1), pK) and torch.equal(cnt, pc)
    assert torch.equal(oV.view(-1), pV)


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", ["er_192", "powerlaw_16_384"])
def test_bucketed_padded_classes_take_the_kernel(cuda, matrix):
    """A plan on the 1.5x width grid (the legacy replan's) on the card:
    every class takes the tail kernel, the W = 192 and 384 classes padded
    to 256 and 512, no slot the sort tail; C is the oracle's, cold and
    warm."""
    A = {"er_192": lambda: gen.random_uniform(2000, nnz_per_row=12, seed=9),
         "powerlaw_16_384": lambda: gen.powerlaw(6000, avg_nnz=8,
                                                 seed=42)}[matrix]()
    plan = bk.plan_buckets(A.ptr, A.col, A.ptr, precompute=False)
    assert any(c.W & (c.W - 1) for c in plan.classes)
    st = BucketedState(plan=plan, device=cuda, route="kernel")
    cfg = SpGEMMConfig(dma_fill="off", planned="off")
    ref = oracle_spgemm(A, A)
    before = et.esc_tail.launches
    for _ in range(2):
        C, st = spgemm_bucketed(A, A, cfg, state=st)
        assert C.host().equals(ref, tol=1e-9)
    assert st.plan.tail_slots["sort"] == 0
    assert st.plan.tail_padded_slots > 0
    assert st.plan.stats()["padded_tail_slots"] == st.plan.tail_padded_slots
    assert et.esc_tail.launches >= before + 2 * len(plan.classes)


def check_both_tails(keys, vals, row_len, w2: int, dtype, offset: int = 0):
    """Both tail forms on one input against their plain versions, keys,
    values and counts bit for bit; each wrapper launches once.  With
    ``offset``, every plane is a view that starts ``offset`` elements into
    its buffer (not on a 16-byte boundary for an odd offset)."""
    dev = torch.device("cuda")

    def view(x, dt):
        buf = torch.zeros(offset + x.size, dtype=dt, device=dev)
        buf[offset:] = torch.from_numpy(x.reshape(-1)).to(dev, dt)
        return buf[offset:].view(x.shape)

    k = view(keys, torch.int32)
    v = view(vals, dtype)
    rl = torch.from_numpy(row_len).to(dev)
    before = (et.esc_tail.launches, et.esc_tail_flat.launches)
    out = et.esc_tail(k, v, rl, w2=w2)
    torch.cuda.synchronize()
    for a, b in zip(out, et.esc_tail_plain(k, v, rl, w2=w2)):
        assert torch.equal(a, b)
    live = torch.arange(w2, device=k.device)[None, :] < rl.long()[:, None]
    fk = view(torch.where(live, k, I32_MAX).cpu().numpy().reshape(-1),
              torch.int32)
    fv = view(torch.where(live, v, 0.0).cpu().numpy().reshape(-1), dtype)
    oK, oV, cnt = et.esc_tail_flat(fk, fv, w2=w2)
    torch.cuda.synchronize()
    assert (et.esc_tail.launches, et.esc_tail_flat.launches) == (
        before[0] + 1, before[1] + 1)
    pK, pV, pc = et.esc_tail_flat_plain(fk, fv, w2=w2)
    assert torch.equal(oK, pK) and torch.equal(cnt, pc)
    assert torch.equal(oV, pV)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2,rows", [(8, 5), (64, 3), (2, 3), (128, 7),
                                     (512, 3), (1024, 3), (8192, 3),
                                     (32768, 3)])
def test_tails_partial_tile(cuda, w2, rows, dtype):
    """Slot counts that are not a multiple of the kernel's tile (256
    slots a warp on the warp path, max(w2, 2048) a block on the tile
    path; at w2 >= 2048 a tile is one row): the last tile is partial
    (NaN and random keys past each row's count in the slab form; row 0
    full)."""
    rng = np.random.default_rng(w2 * rows)
    keys = rng.integers(0, max(2, w2 // 4), (rows, w2)).astype(np.int32)
    row_len = rng.integers(0, w2 + 1, rows).astype(np.int32)
    row_len[0] = w2
    vals = rng.standard_normal((rows, w2))
    vals[np.arange(w2)[None, :] >= row_len[:, None]] = np.nan
    check_both_tails(keys, vals, row_len, w2, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [2, 32, 256, 512, 1024, 8192, 16384])
def test_tails_equal_keys_and_empty_tiles(cuda, w2, dtype):
    """One whole tile (256 slots on the warp path, max(w2, 2048) on the
    tile path) whose keys are all equal, then an all-empty tile (every
    row count 0), then a tile of full rows of distinct keys in
    descending order."""
    per = (256 if w2 <= 256 else max(w2, 2048)) // w2
    keys = np.empty((3 * per, w2), dtype=np.int32)
    keys[:per] = 12345
    keys[per:2 * per] = np.random.default_rng(w2).integers(0, 9, (per, w2))
    keys[2 * per:] = np.arange(w2)[::-1][None, :]
    row_len = np.full(3 * per, w2, dtype=np.int32)
    row_len[per:2 * per] = 0
    vals = np.random.default_rng(w2 + 1).standard_normal(keys.shape)
    check_both_tails(keys, vals, row_len, w2, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [16, 256, 512, 1024, 8192, 16384])
def test_tails_unaligned_planes(cuda, w2, dtype):
    """Planes that do not start on a 16-byte boundary (contiguous views at
    an odd offset) take the slot-by-slot loads and stores of the warp
    and tile paths; then both forms at an odd offset, with row counts
    under w2, a full row and an empty one."""
    k, v = tail_inputs(w2, 40, seed=w2 + 5)
    keys = torch.from_numpy(np.concatenate([[0], k]).astype(np.int32))
    vals = torch.from_numpy(np.concatenate([[0.0], v])).to(dtype)
    keys, vals = keys.to(cuda)[1:], vals.to(cuda)[1:]
    assert keys.data_ptr() % 16 and vals.data_ptr() % 16
    oK, oV, cnt = et.esc_tail_flat(keys, vals, w2=w2)
    pK, pV, pc = et.esc_tail_flat_plain(keys, vals, w2=w2)
    assert torch.equal(oK, pK) and torch.equal(cnt, pc)
    assert torch.equal(oV, pV)
    rng = np.random.default_rng(w2 + 6)
    rows = 5
    skeys = rng.integers(0, max(2, w2 // 4), (rows, w2)).astype(np.int32)
    row_len = rng.integers(0, w2 + 1, rows).astype(np.int32)
    row_len[0], row_len[1] = w2, 0
    svals = rng.standard_normal((rows, w2))
    check_both_tails(skeys, svals, row_len, w2, dtype, offset=1)


WIDE_WS = [8193, 10001, 12288, 16384, 24576, 98304, 196608]


def wide_rows(W: int, keyspan: int, seed: int):
    """Rows of W slots: row 0 full, row 1 empty, row 2 full of one key,
    row 3 full of distinct keys in descending order, row 4 full of keys
    that each come twice, W / 2 apart (so in different pieces), the rest
    with random counts; keys drawn from ``keyspan`` columns, NaN values
    past each count."""
    rng = np.random.default_rng(seed)
    rows = max(6, (1 << 19) // W)
    keys = rng.integers(0, keyspan, (rows, W)).astype(np.int32)
    row_len = rng.integers(0, W + 1, rows).astype(np.int32)
    row_len[[0, 2, 3, 4]], row_len[1] = W, 0
    keys[2] = 7
    keys[3] = np.arange(W)[::-1]
    keys[4] = np.arange(W) % (W // 2)
    vals = rng.standard_normal((rows, W))
    vals[np.arange(W)[None, :] >= row_len[:, None]] = np.nan
    return keys, vals, row_len


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("keyspan", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("W", WIDE_WS)
def test_wide_slab_tail_matches_plain(cuda, W, dtype, keyspan, offset):
    """Rows wider than 8192 on the wide path (pieces on the tile path, then
    merge rounds): bit for bit the plain version, and the same bits again
    on a second run; keys drawn from W / 4 columns (most keys of a piece
    meet a twin in the merges) or from 4W (few do), 16-byte copies where
    W is a multiple of 4 and the planes are aligned, slot by slot
    otherwise."""
    span = max(2, W // 4) if keyspan == "dense" else 4 * W
    keys, vals, row_len = wide_rows(W, span, seed=W + len(keyspan))
    k, v, rl = slab_on_card(keys, vals, row_len, dtype, offset)
    w2 = et.pad_w2(W)
    before = et.esc_tail.launches
    out = et.esc_tail(k, v, rl, w2=w2)
    again = et.esc_tail(k, v, rl, w2=w2)
    torch.cuda.synchronize()
    assert et.esc_tail.launches == before + 2
    for a, b, c in zip(out, again, et.esc_tail_plain(k, v, rl, w2=w2)):
        assert torch.equal(a, c) and torch.equal(a, b)


@pytest.mark.cuda
def test_wide_path_uses_many_blocks_a_row(cuda):
    """A row of 786,432 slots (the widest class of the g500_s15_ef16
    benchmark's plan) is 96 pieces, a block each, and every merge round
    splits its pairs into tiles of 2048 positions, a block each: the
    scratch holds the second planes, 96 piece counts, 48 run counts and
    the most tiles of a round, 512 (2 pairs of 256 tiles when 3 runs
    merge).  The kernel equals its plain version there."""
    lib = et._kernel_fn(torch.float64, slab=True)[0]
    W = 786432
    nbytes = lib.esc_tail_flat_scratch_bytes(W, W, 8)
    assert nbytes == W * 12 + 4 * (96 + 48 + 512)
    keys, vals, row_len = wide_rows(W, W // 3, seed=5)
    k, v, rl = slab_on_card(keys[:1], vals[:1], row_len[:1], torch.float64,
                            0)
    out = et.esc_tail(k, v, rl, w2=et.pad_w2(W))
    for a, b in zip(out, et.esc_tail_plain(k, v, rl, w2=et.pad_w2(W))):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bucketed_kronecker_takes_no_sort_tail(cuda):
    """A scale-11 Graph500 Kronecker matrix (the g500_s15_ef16 benchmark's
    generator) squared by the bucketed engine under the default config:
    its classes past 8192 take the wide path, no slot the sort tail, it
    reads each slab row's products and every slot of a flat class, and C
    is the oracle's, cold and warm."""
    from spgemm_bench import gen as sg
    M = sg.rmat(11, 16, 0.57, 0.19, 0.19, permute=True, symmetric=True,
                rng=np.random.default_rng(11))
    A = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig()
    C, st = spgemm_bucketed(A, A, cfg, device=cuda)
    assert C.host().equals(ref, tol=1e-9)
    C, st = spgemm_bucketed(A, A, cfg, state=st)
    assert C.host().equals(ref, tol=1e-9)
    assert st.plan.tail_slots["sort"] == 0
    wide_cls = [c for c in st.plan.classes if c.W > 8192]
    wide = sum(c.W * c.rb * c.nchunks for c in wide_cls)
    assert wide > 0 and st.plan.stats()["wide_tail_slots"] == wide
    prod = np.zeros(A.M + 1, np.int64)     # products a row, a last 0
    np.add.at(prod, np.repeat(np.arange(A.M), np.diff(A.ptr)),
              np.diff(A.ptr)[A.col])
    live = sum(c.W * c.rb * c.nchunks if c.pre else int(prod[c.rows_g].sum())
               for c in wide_cls)
    assert st.plan.stats()["wide_tail_live_slots"] == live


@pytest.mark.cuda
@pytest.mark.parametrize("nplanes", [1, 2, 3])
def test_ragged_fill_matches_plain(cuda, nplanes):
    """Runs of a forced fill plan, all chunks in one launch, against the
    plain version on the covered words (exact)."""
    A = gen.powerlaw(3000, avg_nnz=8, seed=9)
    vwords = max(1, nplanes - 1)
    plan = bk.plan_buckets(A.ptr, A.col, A.ptr, vwords=vwords,
                           dma_fill="on", area_cap=1 << 14)
    vals = A.val.astype(np.float64 if vwords == 2 else np.float32)
    for c in plan.classes:
        pairs = torch.from_numpy(bk.build_pairs_planar(
            A.col, vals, vwords, c.wrows)).to(cuda)
        kw = dict(out_rows=nplanes * c.out_rows, nplanes=nplanes,
                  src_stride_rows=pairs.shape[0] // (1 + vwords),
                  dst_stride=c.out_rows * 128)
        wr = torch.from_numpy(c.win_row).to(cuda)
        rn = torch.from_numpy(c.runs).to(cuda)
        before = rf.ragged_fill.launches
        got = rf.ragged_fill(wr, rn, pairs, **kw)
        torch.cuda.synchronize()
        assert rf.ragged_fill.launches == before + 1
        want = rf.ragged_fill_plain(wr, rn, pairs, **kw)
        cov = torch.zeros_like(want, dtype=torch.bool).view(c.nchunks, -1)
        slot = torch.arange(c.W, device=cuda)[None, :] < torch.from_numpy(
            c.row_len).to(cuda).reshape(-1, 1)
        slot = slot.reshape(c.nchunks, -1)
        for p in range(nplanes):
            lo = p * c.out_rows * 128
            cov[:, lo: lo + c.rb * c.W] = slot
        cov = cov.view_as(want)
        assert torch.equal(got[cov], want[cov])


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_fill_engine_on_card(cuda, value_dtype):
    A = gen.banded(3000, band=40, nnz_per_row=30, seed=2)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(value_dtype=value_dtype, dma_fill="on")
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    before = (rf.ragged_fill.launches, et.esc_tail.launches)
    state = None
    for _ in range(3):                        # cold, then warm
        C, state = spgemm_bucketed(A, A, config=cfg, state=state,
                                   device=cuda)
        assert C.host().equals(ref, tol=tol)
    assert state.plan.ext is not None
    assert rf.ragged_fill.launches > before[0]
    assert et.esc_tail.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dma_fill", ["auto", "on", "off"])
def test_masked_on_card(cuda, dma_fill):
    A = gen.powerlaw(3000, avg_nnz=6, seed=5)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(mode="masked", dma_fill=dma_fill)
    state = None
    for _ in range(3):                        # cold, then warm
        C, state = spgemm_masked(A, A, config=cfg, state=state, device=cuda)
        assert C.host().equals(ref, tol=1e-9)


@pytest.mark.cuda
def test_blockdense_windowed_on_card(cuda):
    A = gen.banded(3000, band=60, nnz_per_row=30, seed=4)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(mode="blockdense", dma_fill="on")
    before = rf.ragged_fill.launches
    state = None
    for _ in range(3):
        C, state = spgemm_blockdense(A, A, config=cfg, state=state,
                                     device=cuda)
        assert C.host().equals(ref, tol=1e-9)
    assert state.plan.ext is not None
    assert rf.ragged_fill.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("nplanes", [1, 2, 3])
@pytest.mark.parametrize("S,T", [(1000, 4096), (30000, 2000), (5000, 300000)])
def test_pgather_matches_plain(cuda, S, T, nplanes):
    """Every output word against the plain version, and the scheduled
    positions against the table read at their sources (exact); the
    planes are read in place, one of them strided."""
    rng = np.random.default_rng(S + nplanes)
    src = rng.integers(0, T, S).astype(np.int64)
    wblk, rowsel, lane, perm = pn.plan_pgather(src, T)
    sched = [torch.from_numpy(x).to(cuda) for x in (wblk, rowsel, lane)]
    words = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (T, 2),
                                          dtype=np.int64).astype(np.int32))
    words = words.to(cuda)
    tabs = [words[:, 0], words[:, 1], words[:, 0].contiguous() + 7][:nplanes]
    before = pn.pgather.launches
    out = pn.pgather(tabs, *sched)
    torch.cuda.synchronize()
    assert pn.pgather.launches == before + 1
    assert torch.equal(out, pn.pgather_plain(tabs, *sched))
    live = torch.from_numpy(np.flatnonzero(perm >= 0)).to(cuda)
    at = torch.from_numpy(src[perm[perm >= 0]]).to(cuda)
    for p, t in enumerate(tabs):
        assert torch.equal(out[p][live], t[at])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["pair12", "pair01", "apart"])
def test_pgather_f64_pair_paths(cuda, layout):
    """Both load paths word for word against the plain version: planes
    1-2 (or 0-1) the two words of one f64 tensor, read with one 8-byte
    load, and planes that are no such pair, read one word at a time."""
    rng = np.random.default_rng(11)
    T, S = 50000, 40000
    src = rng.integers(0, T + 300, S).astype(np.int64)   # some past the end
    wblk, rowsel, lane, _ = pn.plan_pgather(src, T)
    sched = [torch.from_numpy(x).to(cuda) for x in (wblk, rowsel, lane)]
    vals = torch.from_numpy(rng.standard_normal(T)).to(cuda)
    col = torch.from_numpy(rng.integers(0, 9999, T).astype(np.int32)).to(cuda)
    w = vals.view(torch.int32)
    tabs = {"pair12": [col, w[0::2], w[1::2]], "pair01": [w[0::2], w[1::2]],
            "apart": [w[1::2], w[0::2], col]}[layout]
    assert pn._f64_pair(tabs) == {"pair12": 1, "pair01": 0,
                                  "apart": -1}[layout]
    out = pn.pgather(tabs, *sched)
    torch.cuda.synchronize()
    assert torch.equal(out, pn.pgather_plain(tabs, *sched))


@pytest.mark.cuda
@pytest.mark.parametrize("nplanes", [1, 2, 3])
@pytest.mark.parametrize("m,hold_w2", [(1024, 1), (1024, 8), (16384, 2048),
                                       (32768, 2048), (65536, 64),
                                       (65536, 1024), (131072, 8),
                                       (131072, 32768)])
def test_proute_matches_plain(cuda, m, hold_w2, nplanes):
    """Three networks at once: every word against the plain version, and
    without the hold against out[dest] = in (exact).  Masks of random bits
    check that each position applies its own bit."""
    rng = np.random.default_rng(m + hold_w2 + nplanes)
    nb = 3
    dest = np.stack([rng.permutation(m) for _ in range(nb)])
    masks, nst = pn.plan_routes(dest)
    planes = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (nplanes, nb, m),
                                           dtype=np.int64).astype(np.int32))
    flags = torch.from_numpy((rng.random((nb, m)) < 0.1).astype(np.int32))
    x, mk, fl = planes.to(cuda), torch.from_numpy(masks).to(cuda), \
        flags.to(cuda)
    before = pn.proute.launches
    out = pn.proute(x, mk, nst, hold_w2=hold_w2, flags=fl)
    torch.cuda.synchronize()
    assert pn.proute.launches == before + 1
    assert torch.equal(out, pn.proute_plain(x, mk, nst, hold_w2=hold_w2,
                                            flags=fl))
    if hold_w2 == 1:
        want = torch.empty_like(x)
        d = torch.from_numpy(dest).to(cuda)
        for b in range(nb):
            want[:, b, d[b]] = x[:, b]
        assert torch.equal(out, want)
    rand = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, masks.shape,
                                         dtype=np.int64).astype(np.int32))
    rand = rand.to(cuda)
    assert torch.equal(pn.proute(x, rand, nst, hold_w2=hold_w2, flags=fl),
                       pn.proute_plain(x, rand, nst, hold_w2=hold_w2,
                                       flags=fl))


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_planned_engine_on_card(cuda, value_dtype):
    """The default config plans this matrix's classes on the planned
    frontend on the card; cold and warm calls (the warm ones through the
    planned extraction) give the oracle's C."""
    A = gen.powerlaw(3000, avg_nnz=5, seed=42)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(value_dtype=value_dtype)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    before = (pn.pgather.launches, pn.proute.launches)
    state = None
    for _ in range(3):                        # cold, then warm
        C, state = spgemm_bucketed(A, A, config=cfg, state=state,
                                   device=cuda)
        assert C.host().equals(ref, tol=tol)
    assert state.planned == "on"
    assert any(c.pf for c in state.plan.classes)
    assert state.plan.ext is not None or state.plan.ext_pf is not None
    assert pn.pgather.launches > before[0] and pn.proute.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("vr", [1, 336])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_halo_exchange_matches_plain(cuda, d, vr):
    """One launch moves every shard's blocks (shards in separate
    allocations on the card), exact on every word."""
    rng = np.random.default_rng(d * 1000 + vr)
    sends = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (d, vr, 128),
                                           dtype=np.int64).astype(np.int32)
                              ).to(cuda) for _ in range(d)]
    before = rfx.halo_exchange.launches
    got = rfx.halo_exchange(sends, n_devices=d)
    torch.cuda.synchronize()
    assert rfx.halo_exchange.launches == before + 1
    for g, w in zip(got, rfx.halo_exchange_plain(sends, n_devices=d)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("first,count", [(0, 8), (0, 4), (4, 4), (7, 1),
                                         (2, 3)])
def test_halo_exchange_subset_matches_plain(cuda, first, count):
    """One launch into the receiving shards first .. first + count - 1
    alone (what a process of a multi-process mesh pulls), new tensors and
    given ones, equals the plain version's subset, exact."""
    d = 8
    rng = np.random.default_rng(first * 10 + count)
    sends = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (d, 3, 128),
                                           dtype=np.int64).astype(np.int32)
                              ).to(cuda) for _ in range(d)]
    want = rfx.halo_exchange_plain(sends, n_devices=d, dst_first=first,
                                   dst_count=count)
    out = [torch.empty_like(sends[0]) for _ in range(count)]
    before = rfx.halo_exchange.launches
    for got in (rfx.halo_exchange(sends, n_devices=d, dst_first=first,
                                  dst_count=count),
                rfx.halo_exchange(sends, n_devices=d, dst_first=first,
                                  dst_count=count, out=out)):
        torch.cuda.synchronize()
        assert len(got) == count
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(g is o for g, o in zip(got, out))
    assert rfx.halo_exchange.launches == before + 2


@pytest.mark.cuda
def test_multiprocess_worker_on_card(cuda, tmp_path):
    """Two ranks of ``parallel.worker`` on the card, two shards each (the
    payload by CUDA IPC): every C equals the oracle, the ranks' Cs agree,
    and the ragged "pallas" call launched halo_exchange in both ranks."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from mh_spgemm_torch.parallel import worker
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    calls = ("bucketed:ragged:pallas", "bucketed:ragged:xla",
             "bucketed:allgather:xla", "bucketed:grid2d:xla",
             "bucketed:ragged_overlap:xla:force", "esc:ragged:xla")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mh_spgemm_torch.parallel.worker", str(port),
         str(r), "2", "2", "--device", "cuda", "--matrix", "powerlaw",
         "--calls", ",".join(calls), "--out", str(tmp_path), "--save-c",
         "--timeout", "120"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
        assert f"rank {r}: multiprocess dist OK" in log
    A = worker.load("powerlaw")
    ref = oracle_spgemm(A, A)
    recs = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    for r0, r1 in zip(*recs):
        assert r0["call"] == r1["call"] and r0["digest"] == r1["digest"]
        for r in range(2):
            tag = r0["call"].replace(":", "-")
            z = np.load(tmp_path / f"rank{r}_powerlaw_{tag}.npz")
            C = CSR(M=int(z["shape"][0]), N=int(z["shape"][1]),
                    ptr=z["ptr"], col=z["col"], val=z["val"])
            assert C.equals(ref, tol=1e-9), (r, r0["call"])
        halo = (r0["launches"]["halo_exchange"],
                r1["launches"]["halo_exchange"])
        if r0["call"] == "bucketed:ragged:pallas":
            assert min(halo) > 0
        else:
            assert max(halo) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_dist_ragged_pallas_on_card(cuda, value_dtype):
    """spgemm_dist's ragged strategy on 4 shards of the card under
    comm_backend="pallas" (the halo_exchange kernel), cold and warm,
    against the oracle, and bit for bit against "xla"."""
    A = gen.powerlaw(3000, avg_nnz=5, seed=42)
    ref = oracle_spgemm(A, A)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    mesh = make_row_mesh(4)
    assert all(d.type == "cuda" for d in mesh.devices)
    before = (rfx.halo_exchange.launches, et.esc_tail.launches)
    st = {}
    for _ in range(3):                        # cold, then warm
        C = spgemm_dist(A, None, mesh, b_strategy="ragged", state=st,
                        config=SpGEMMConfig(value_dtype=value_dtype,
                                            comm_backend="pallas"))
        assert C.equals(ref, tol=tol)
    assert rfx.halo_exchange.launches == before[0] + 3
    assert et.esc_tail.launches > before[1]
    X = spgemm_dist(A, None, mesh, b_strategy="ragged",
                    config=SpGEMMConfig(value_dtype=value_dtype))
    assert np.array_equal(X.col, C.col) and np.array_equal(X.val, C.val)


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["esc", "masked"])
def test_device_engines_on_card(cuda, mode, value_dtype):
    """spgemm on padded device operands (the fused ESC engine and the
    product-granularity masked pipeline) on the card against the oracle,
    cold and then warm through the plan; the warm calls, queued under
    no_fence, make no host synchronization (torch's sync debug mode
    raises on one)."""
    from mh_spgemm_torch.pipeline import make_plan, no_fence, spgemm
    A = gen.powerlaw(3000, avg_nnz=5, seed=42)
    ref = oracle_spgemm(A, A)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    cfg = SpGEMMConfig(mode=mode, value_dtype=value_dtype)
    dA = A.device(cfg.vdtype, pad=True)
    assert dA.ptr.is_cuda and dA.val.dtype == cfg.vdtype
    plan = make_plan(dA, dA)
    C = spgemm(dA, dA, config=cfg, plan=plan)
    assert C.val.is_cuda and C.host().equals(ref, tol=tol)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with no_fence():
            for _ in range(3):
                C = spgemm(dA, dA, config=cfg, plan=plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert C.host().equals(ref, tol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["replicate", "allgather", "ragged"])
def test_dist_esc_on_card(cuda, strategy):
    """spgemm_dist(engine="esc") on 4 shards of the card, cold and warm,
    against the oracle."""
    A = gen.powerlaw(3000, avg_nnz=5, seed=42)
    ref = oracle_spgemm(A, A)
    st = {}
    for _ in range(2):
        C = spgemm_dist(A, None, make_row_mesh(4), b_strategy=strategy,
                        state=st, engine="esc")
        assert C.equals(ref, tol=1e-9)


def engine_calls(A, B, mode: str, n: int = 2, device="cuda"):
    """``n`` calls of one engine on ``device``, the first cold and the
    rest warm through the state (or SpGEMMPlan) the first returned;
    ``auto`` takes the engine ``choose_engine`` picks.  Yields host C
    each."""
    from mh_spgemm_torch.pipeline import choose_engine, make_plan, spgemm
    cfg = SpGEMMConfig(mode=mode)
    if mode == "auto":
        mode = choose_engine(A, B, cfg, device=device)
    if mode == "esc":
        dA = A.device(cfg.vdtype, pad=True, device=device)
        dB = B.device(cfg.vdtype, pad=True, device=device) \
            if B is not A else dA
        plan = make_plan(dA, dB)
        for _ in range(n):
            yield spgemm(dA, dB, config=cfg, plan=plan).host()
        return
    run = {"bucketed": spgemm_bucketed, "blockdense": spgemm_blockdense,
           "masked": spgemm_masked}[mode]
    state = None
    for _ in range(n):
        C, state = run(A, B, config=cfg, state=state, device=device)
        yield C.host()


@pytest.mark.cuda
def test_rect_tall0_masked_on_card(cuda):
    """The class-based masked engine on a B wider than it is tall (its
    mask stage gathers B's tile counts at B's column indices, clamped),
    cold and warm, against the oracle; the card's context stays usable."""
    from mh_spgemm_torch.bench import structured
    A, B = structured.make_case("rect_tall", 0)
    ref = oracle_spgemm(A, B)
    for C in engine_calls(A, B, "masked", 3):
        assert C.equals(ref, tol=1e-9)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("diag_full_row", 6), ("rect_tall", 9)])
def test_clone_cap_cases_under_default_config(cuda, case):
    """Cases whose chunks would clone a window row more than 64 times,
    under DEFAULT_CONFIG (planned on the card), cold and warm."""
    from mh_spgemm_torch.bench import structured
    A, B = structured.make_case(*case)
    ref = oracle_spgemm(A, B)
    for C in engine_calls(A, B, "bucketed", 3):
        assert C.equals(ref, tol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bucketed", "blockdense", "masked", "esc",
                                  "auto"])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_degenerate_cases_on_card(cuda, kind, mode):
    """The catalog's degenerate shapes (1 x 1, 1 x N by N x 1, empty,
    one entry in the last row, N x 3 by 3 x N) through each engine on the
    card, cold and warm: no kernel is launched on empty input."""
    from mh_spgemm_torch.bench import structured
    A, B = structured.make_case("degenerate", kind)
    ref = oracle_spgemm(A, B)
    for C in engine_calls(A, B, mode):
        assert C.equals(ref, tol=1e-9)
    torch.cuda.synchronize()
