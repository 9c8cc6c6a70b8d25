"""The bucketed engine's gather frontend: its plain version
(``ops/bucketed.front_gather_plain``) against an expansion of the plan's
entry arrays in numpy, one entry at a time, on plans that the planner
makes (keys, products and row counts bit for bit); the plan's
``gather_front_slots`` and ``gather_front_live_slots`` counters; the
benchmark's two readers of the kernel (``front.gather_ms.warm`` and
``front.gather_roofline_pct``); and, on a CUDA device, the kernel
``csrc/gather_front.cu`` against the plain version at the benchmark's
widths, and the bucketed engine's C with the kernel against its C with
the plain version, bit for bit.

This file imports neither JAX nor the JAX package; the CUDA tests skip
where there is no CUDA device (``python -m pytest --noconftest
tests/test_torch_gather_front.py`` on the card).
"""

import numpy as np
import pytest
import torch

from mh_spgemm_torch import CSR, SpGEMMConfig, pipeline
from mh_spgemm_torch.ops import bucketed as bk
from mh_spgemm_torch.ops import gather_front as gf

I32_MAX = 2**31 - 1
CPU = torch.device("cpu")
DTYPES = [torch.float64, torch.float32]
NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}
# the kernel's tile of slots a block (csrc/gather_front.cu, kTile)
KERNEL_TILE = 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rmat(scale: int, a: float, b: float, c: float, symmetric: bool,
         seed: int):
    """The benchmark's R-MAT generator: Erdos-Renyi at a = b = c = 0.25,
    the Graph500 Kronecker graph at 0.57 / 0.19 / 0.19 (permuted,
    symmetric)."""
    from spgemm_bench import gen as sg
    return sg.rmat(scale, 16, a, b, c, permute=symmetric,
                   symmetric=symmetric, rng=np.random.default_rng([seed, 0]))


def with_empty_rows(M, every: int):
    """``M`` with every ``every``-th row emptied: the entries of A that
    point at such a row of B have no product, and the planner drops
    them."""
    keep = np.repeat(np.arange(M.M) % every != 0, np.diff(M.ptr))
    ptr = np.zeros(M.M + 1, np.int32)
    np.cumsum(np.where(np.arange(M.M) % every != 0, np.diff(M.ptr), 0),
              out=ptr[1:])
    return CSR(M=M.M, N=M.N, ptr=ptr, col=M.col[keep], val=M.val[keep])


def gather_plan(shape: str):
    """(A, B, plan) of one shape, every non-fill class on the gather
    frontend (the 1.5x grid of the replanned and distributed plans):
    ``er``, an Erdos-Renyi square; ``kron``, a Graph500 Kronecker square
    with rows past 8192 products; ``forced``, an Erdos-Renyi A times a B
    with empty rows, in classes forced wider, taller and with more entry
    room than the rows need (pad rows, pad entries, empty chunks)."""
    if shape == "er":
        M = rmat(9, 0.25, 0.25, 0.25, False, seed=5)
        A = B = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
        plan = bk.plan_buckets(A.ptr, A.col, B.ptr, precompute=False)
    elif shape == "kron":
        M = rmat(10, 0.57, 0.19, 0.19, True, seed=7)
        A = B = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
        plan = bk.plan_buckets(A.ptr, A.col, B.ptr, precompute=False)
        assert max(c.W for c in plan.classes) > 8192
    else:
        M = rmat(8, 0.25, 0.25, 0.25, False, seed=9)
        A = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
        B = with_empty_rows(A, 5)
        plan = bk.plan_buckets(A.ptr, A.col, B.ptr, precompute=False,
                               forced={384: (48, 8, 1024, False),
                                       1024: (16, 3, 2048, False)})
        assert all((c.ent_dst == c.rb * c.W).any() for c in plan.classes)
        assert all((c.rows_g < 0).any() for c in plan.classes)
    assert plan.classes and all(c.frontend == "gather" for c in plan.classes)
    return A, B, plan


def expand_numpy(c, a_val, b_col, b_val):
    """A class's (K, prod, row_len) by copying each entry's B span into
    its slots, the product in the value type: the frontend's definition,
    independent of the plain version's seeded planes and held scan."""
    RW = c.rb * c.W
    K = np.full((c.nchunks, RW), I32_MAX, np.int32)
    P = np.zeros((c.nchunks, RW), b_val.dtype)
    for ch in range(c.nchunks):
        for dst, src, ln, ai in zip(c.ent_dst[ch], c.ent_src[ch],
                                    c.ent_len[ch], c.ent_aidx[ch]):
            if dst >= RW or ln == 0:
                continue
            K[ch, dst: dst + ln] = b_col[src: src + ln]
            P[ch, dst: dst + ln] = a_val[ai] * b_val[src: src + ln]
    K, P = K.reshape(-1, c.W), P.reshape(-1, c.W)
    return K, P, (K != I32_MAX).sum(axis=1).astype(np.int32)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ["er", "kron", "forced"])
def test_plain_gather_matches_entry_expansion(shape, dtype):
    A, B, plan = gather_plan(shape)
    npdt = NP_DTYPES[dtype]
    a_np, b_np = A.val.astype(npdt), B.val.astype(npdt)
    bk.upload_plan(plan, CPU)
    a_val, b_val = torch.from_numpy(a_np), torch.from_numpy(b_np)
    b_col = torch.from_numpy(B.col.astype(np.int32))
    for c, d in zip(plan.classes, plan.dev):
        K, prod, valid = bk.front_gather_plain(d, a_val, b_col, b_val,
                                               W=c.W, rb=c.rb)
        rK, rP, rl = expand_numpy(c, a_np, B.col, b_np)
        assert torch.equal(K, torch.from_numpy(rK))
        assert torch.equal(bits(prod), bits(torch.from_numpy(rP)))
        assert torch.equal(valid.sum(dim=1, dtype=torch.int32),
                           torch.from_numpy(rl))
        # the wrapper on CPU tensors: the plain version, with row counts
        wK, wP, wl = bk.front_gather(d, a_val, b_col, b_val, W=c.W, rb=c.rb)
        assert torch.equal(wK, K) and torch.equal(bits(wP), bits(prod))
        assert torch.equal(wl, torch.from_numpy(rl))


def test_stats_carry_the_gather_front_counters():
    """``gather_front_slots`` and ``gather_front_live_slots``, set where
    the plan is uploaded: 0 on the CPU, whose runs launch nothing; off
    the CPU (the meta device stands in for the card here) the gather
    classes' slots and their entries' products (``ent_len``'s sum)."""
    A, B, plan = gather_plan("er")
    before = gf.gather_front.launches
    a_val = torch.from_numpy(A.val)
    b_col = torch.from_numpy(B.col.astype(np.int32))
    bk.run_bucketed(plan, a_val, b_col, torch.from_numpy(B.val),
                    route="kernel")
    stats = plan.stats()
    assert stats["gather_front_slots"] == 0
    assert stats["gather_front_live_slots"] == 0
    assert gf.gather_front.launches == before
    bk.upload_plan(plan, "meta")
    stats = plan.stats()
    assert stats["gather_front_slots"] == sum(
        c.W * c.rb * c.nchunks for c in plan.classes)
    assert stats["gather_front_live_slots"] == plan.intprod == sum(
        int(c.ent_len.sum()) for c in plan.classes)
    bk.upload_plan(plan, CPU)
    assert plan.stats()["gather_front_slots"] == 0
    assert plan.stats()["gather_front_live_slots"] == 0
    _, st = pipeline.spgemm_bucketed(A, A, SpGEMMConfig(), device=CPU)
    stats = st.plan.stats()
    assert (stats["gather_front_slots"],
            stats["gather_front_live_slots"]) == (0, 0)
    assert gf.gather_front.launches == before


def _reader(name: str):
    from spgemm_bench import harness
    return harness.load_part("metrics", name)


@pytest.mark.parametrize("value_dtype,value_bytes",
                         [("float64", 8), ("float32", 4)])
@pytest.mark.parametrize("nnz_b", [883_000, 50_000_000])
def test_gather_front_readers(value_dtype, value_bytes, nnz_b):
    """None without the kernel, the counters or the input; the kernel's
    device ms a call, and the byte bound ``(4 + value bytes) x (slots +
    min(live, nnz(B)))`` at 3.35e12 B/s over it, on a synthetic run (B
    smaller than the covered slots, as in both benchmark cells, and
    larger)."""
    from spgemm_bench import gen, harness, profile
    ms, pct = (_reader("front.gather_ms.warm"),
               _reader("front.gather_roofline_pct"))
    run = harness.Run("c", {"value_dtype": value_dtype}, {}, 1, 1.0, True,
                      "cpu")
    assert ms.read(run) is None and pct.read(run) is None
    run.profile = profile.Profile(
        calls=2, window_s=1e-2, busy_s=5e-3,
        by_name={"tail_warp<double, 8>": [2, 4e-4]}, idle={})
    run.counters = {"plan": {"gather_front_slots": 40_000_000,
                             "gather_front_live_slots": 33_000_000}}
    assert ms.read(run) is None and pct.read(run) is None
    run.profile.by_name["gather_front<double>"] = [2, 6e-4]
    assert ms.read(run) == pytest.approx(0.3)
    assert pct.read(run) is None                   # no input: no B
    run.A = gen.Matrix(M=1, N=1, ptr=np.array([0, nnz_b], np.int32),
                       col=np.zeros(0, np.int32), val=np.zeros(0))
    words = 40_000_000 + min(33_000_000, nnz_b)
    want = 100 * (4 + value_bytes) * words / 3.35e12 / 0.3e-3
    assert pct.read(run) == pytest.approx(want)
    assert 0 < pct.read(run) <= 100
    run.counters = {"plan": {"gather_front_slots": 0,
                             "gather_front_live_slots": 0}}
    assert pct.read(run) is None
    run.counters = {}
    assert pct.read(run) is None


# -- on the card -------------------------------------------------------------

def synthetic_class(W: int, rows: int, rb: int, dtype, seed: int):
    """Entry arrays of a gather class of ``rows`` rows of W slots in
    chunks of ``rb`` rows, one chunk more than they fill (empty rows), and
    the operands they point into.  B's row 0 holds W nonzeros and row 1
    more than a kernel tile; row 0 of the class has no entry, row 1 is
    one entry that spans it whole, row 2 starts with B's row 1 where it
    fits, and the rest take random short B rows up to a random count.
    Every chunk ends in pad entries (``ent_dst = rb * W``, length 0)."""
    rng = np.random.default_rng(seed)
    long_len = KERNEL_TILE + 3000
    short = rng.integers(1, 65, 4096)
    b_len = np.concatenate([[W, long_len], short]).astype(np.int64)
    b_ptr = np.concatenate([[0], np.cumsum(b_len)])
    nnz_b = int(b_ptr[-1])
    b_col = rng.integers(0, 1 << 20, nnz_b).astype(np.int32)
    b_val = rng.standard_normal(nnz_b).astype(NP_DTYPES[dtype])
    a_val = rng.standard_normal(1 << 16).astype(NP_DTYPES[dtype])
    nchunks = -(-rows // rb) + 1
    per_chunk = [[] for _ in range(nchunks)]     # (dst, src, len, aidx)
    for r in range(rows):
        if r == 0:
            picks = []
        elif r == 1:
            picks = [0]
        else:
            lead = [1] if r == 2 and long_len <= W else []
            target = rng.integers(0, W + 1)
            idx = rng.integers(2, b_len.size, W)
            lens = np.cumsum(b_len[idx]) + sum(b_len[k] for k in lead)
            picks = lead + idx[lens <= target].tolist()
        off = 0
        for k in picks:
            per_chunk[r // rb].append(((r % rb) * W + off, b_ptr[k],
                                       b_len[k], rng.integers(0, 1 << 16)))
            off += b_len[k]
        assert off <= W
    eb = max(len(e) for e in per_chunk) + 3
    ent = np.zeros((4, nchunks, eb), np.int32)
    ent[0] = rb * W
    for ch, es in enumerate(per_chunk):
        if es:
            ent[:, ch, : len(es)] = np.array(es, dtype=np.int64).T
    return ent, a_val, b_col, b_val


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,rows,rb", [
    (192, 300, 64), (256, 300, 64), (384, 300, 48), (512, 200, 32),
    (768, 200, 32), (393216, 5, 2), (786432, 3, 2)])
def test_kernel_matches_plain(cuda, W, rows, rb, dtype):
    """er_s17_ef16's gather widths (192-768) and g500_s15_ef16's (393216,
    786432): keys, products' bits and row counts equal the plain
    version's."""
    ent, a_np, bc_np, bv_np = synthetic_class(W, rows, rb, dtype, seed=W)
    d = {k: torch.from_numpy(ent[i]).to(cuda) for i, k in enumerate(
        ("ent_dst", "ent_src", "ent_len", "ent_aidx"))}
    a_val, b_col, b_val = (torch.from_numpy(x).to(cuda)
                           for x in (a_np, bc_np, bv_np))
    before = gf.gather_front.launches
    K, prod, row_len = bk.front_gather(d, a_val, b_col, b_val, W=W, rb=rb)
    torch.cuda.synchronize()
    assert gf.gather_front.launches == before + 1
    pK, pP, valid = bk.front_gather_plain(d, a_val, b_col, b_val, W=W, rb=rb)
    assert torch.equal(K, pK)
    assert torch.equal(bits(prod), bits(pP))
    assert torch.equal(row_len, valid.sum(dim=1, dtype=torch.int32))
    assert int(row_len[1]) == W and int(row_len[0]) == 0


def _plain_front(d, a_val, b_col, b_val, *, W, rb):
    K, prod, valid = bk.front_gather_plain(d, a_val, b_col, b_val, W=W, rb=rb)
    return K, prod, valid.sum(dim=1, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["er", "kron"])
def test_engine_c_matches_plain_frontend(cuda, shape, monkeypatch):
    """The bucketed engine on the two benchmark generators at a small
    scale, replanned onto the 1.5x grid as the benchmark's plans are, with
    the fill frontend off (at this scale the card's cost model would fill
    every class): C with the kernel, cold and warm, equals bit for bit C
    with the plain version put in the kernel's place."""
    if shape == "er":
        M = rmat(12, 0.25, 0.25, 0.25, False, seed=3)
    else:
        M = rmat(11, 0.57, 0.19, 0.19, True, seed=3)
    A = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
    monkeypatch.setattr(bk, "needs_replan", lambda plan: True)
    cfg = SpGEMMConfig(dma_fill="off")

    def two_calls():
        C, st = pipeline.spgemm_bucketed(A, A, cfg, device=cuda)
        W, st = pipeline.spgemm_bucketed(A, A, cfg, state=st)
        return [x.host() for x in (C, W)], st

    before = gf.gather_front.launches
    got, st = two_calls()
    gathers = [c for c in st.plan.classes if c.frontend == "gather"]
    assert st.replanned and gathers
    assert gf.gather_front.launches - before == 2 * len(gathers)
    stats = st.plan.stats()
    assert stats["gather_front_slots"] == sum(
        c.W * c.rb * c.nchunks for c in gathers)
    assert stats["gather_front_live_slots"] == sum(
        int(c.ent_len.sum()) for c in gathers)
    monkeypatch.setattr(bk.gf, "gather_front", _plain_front)
    want, _ = two_calls()
    for g, w in zip(got, want):
        assert np.array_equal(g.ptr, w.ptr) and np.array_equal(g.col, w.col)
        assert np.array_equal(g.val.view(np.int64), w.val.view(np.int64))
