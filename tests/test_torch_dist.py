"""The port's distributed layer (``mh_spgemm_torch/parallel/``) against the
JAX package's (``mh_spgemm_tpu/parallel/``) on the CPU.

The port's shards run on the CPU (``devices=["cpu"]``, several shards on
one device); the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``, its Pallas kernels in interpret mode.

- Host planners, array for array: ``balance_bounds``, ``partition_rows``,
  ``plan_ragged_fetch`` and ``plan_col_blocks`` (banded, power-law, M=9 at
  D=8 with empty trailing shards, rectangular), and ``plan_buckets`` with
  ``b_starts`` / ``b_lens`` / ``forced`` and ``plan_buckets_sharded``
  (replicated, gathered and halo layouts, 2-D bounds), with the fill off,
  forced (port "on" against JAX "interpret") and by the cost model (port
  "auto" against JAX "auto" with its TPU switch on).  The JAX sharded planner
  calls its module's ``plan_buckets``, patched here to plan planar fill
  streams, the port's only encoding.
- Plans carried across: the port run on the JAX sharded plans
  (``plan_from_arrays``) gives the port's own C exactly.
- Results: C of every strategy equals the scipy oracle and, in six
  settings, the JAX package's ``spgemm_dist`` under ``CSR.equals``
  (1e-9; the JAX side carries f64 values as Dekker pairs where the port
  moves raw words, so values agree to the comparator, not bit for bit;
  1e-4 in f32, where the tails add in other orders).  The port's two
  exchange backends give the same C bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mh_spgemm_tpu import SpGEMMConfig as JConfig
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_tpu.ops import ragged_fill as jrf
from mh_spgemm_tpu.parallel import mesh as jmesh
from mh_spgemm_tpu.parallel import spgemm_dist as jsd
from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.errors import SpGEMMError
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import remote_fetch as trf
from mh_spgemm_torch.parallel import comm
from mh_spgemm_torch.parallel import spgemm_dist as tsd
from mh_spgemm_torch.parallel.mesh import make_grid_mesh, make_row_mesh

CPU = ["cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's torch ops run on one thread here: the test workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rectangular():
    rng = np.random.default_rng(23)
    A = CSR.from_coo(60, 90, rng.integers(0, 60, 250),
                     rng.integers(0, 90, 250), rng.standard_normal(250),
                     sum_duplicates=True)
    B = CSR.from_coo(90, 40, rng.integers(0, 90, 220),
                     rng.integers(0, 40, 220), rng.standard_normal(220),
                     sum_duplicates=True)
    return A, B


# name -> (A, B, D)
CASES = {
    "banded": lambda: (gen.banded(120, band=9, nnz_per_row=5, seed=21),
                       None, 4),
    "powerlaw": lambda: (gen.powerlaw(300, avg_nnz=5, seed=22), None, 8),
    "m9_d8": lambda: (gen.random_uniform(9, nnz_per_row=3, seed=77), None,
                      8),
    "rectangular": lambda: rectangular() + (4,),
}
# port dma_fill -> JAX dma_fill
FILL = {"off": "off", "on": "interpret", "auto": "auto"}


def case(name):
    A, B, D = CASES[name]()
    return A, (A if B is None else B), D


def jcsr(X: CSR) -> JCSR:
    return JCSR(M=X.M, N=X.N, ptr=X.ptr, col=X.col, val=X.val)


def assert_same(a, b, what: str) -> None:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


def assert_fields_equal(t, j, names) -> None:
    for f in names:
        assert_same(getattr(t, f), getattr(j, f), f)


PART_FIELDS = ("n_shards", "rows_per_shard", "nnz_cap", "ptr", "col", "val",
               "nnz", "bounds")


@pytest.mark.parametrize("name", sorted(CASES))
def test_partitions_match_jax(name):
    A, B, D = case(name)
    jb = jsd.balance_bounds(jcsr(A), jcsr(B), D)
    tb = tsd.balance_bounds(A, B, D)
    assert_same(tb, jb, "bounds")
    for bounds in (None, tb):
        for dt in (np.float64, np.float32):
            assert_fields_equal(
                tsd.partition_rows(A, D, value_dtype=dt, bounds=bounds),
                jsd.partition_rows(jcsr(A), D, value_dtype=dt,
                                   bounds=bounds), PART_FIELDS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_fetch_plan_matches_jax(name):
    A, B, D = case(name)
    bounds = tsd.balance_bounds(A, B, D)
    tp = tsd.plan_ragged_fetch(A, B, tsd.partition_rows(A, D, bounds=bounds),
                               tsd.partition_rows(B, D))
    jp = jsd.plan_ragged_fetch(
        jcsr(A), jcsr(B), jsd.partition_rows(jcsr(A), D, bounds=bounds),
        jsd.partition_rows(jcsr(B), D))
    assert_fields_equal(tp, jp, ("r_cap", "v_cap", "n_cap", "send_src",
                                 "recv_start", "recv_len", "a_col_remap"))


@pytest.mark.parametrize("dc", [2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_col_blocks_match_jax(name, dc):
    _, B, _ = case(name)
    t, j = tsd.plan_col_blocks(B, dc), jsd.plan_col_blocks(jcsr(B), dc)
    assert_same(t[0], j[0], "cbounds")
    for k, what in ((1, "ptrs"), (2, "cols"), (3, "vals")):
        assert len(t[k]) == len(j[k]) == dc
        for a, b in zip(t[k], j[k]):
            assert_same(a, b, what)


# ---------------------------------------------------------------------------
# Sharded bucket plans
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("W", "rb", "nchunks", "eb", "rows_g", "ent_dst", "ent_src",
               "ent_len", "ent_aidx", "hold_passes", "seg_passes", "fill",
               "stride", "wrows", "out_rows", "win_row", "runs", "row_len",
               "pre", "pf")


def assert_plans_equal(tp, jp) -> None:
    assert (tp.m, tp.m_cap, tp.intprod) == (jp.m, jp.m_cap, jp.intprod)
    assert_same(tp.slab_row_start, jp.slab_row_start, "slab_row_start")
    assert len(tp.classes) == len(jp.classes)
    for tc, jc in zip(tp.classes, jp.classes):
        assert jc.G == 1 and jc.planar == jc.fill
        assert_fields_equal(tc, jc, PLAN_FIELDS)


def sharded_args(A, B, D, strategy):
    """The sharded planner's arguments as the 1-D strategies build them
    (from the port's host planners, which equal the JAX ones)."""
    bounds = tsd.balance_bounds(A, B, D)
    part = tsd.partition_rows(A, D, bounds=bounds)
    R = part.rows_per_shard
    blens = np.diff(B.ptr).astype(np.int64)
    kw = dict(min_width=2, vwords=2, bounds=bounds)
    if strategy == "replicate":
        return (A.ptr, A.col, D, R), dict(kw, b_ptr=B.ptr)
    bpart = tsd.partition_rows(B, D)
    if strategy == "allgather":
        RB, bcap = bpart.rows_per_shard, bpart.nnz_cap
        own = np.arange(B.M) // RB
        starts = (own * bcap + (B.ptr[:-1] - B.ptr[own * RB])).astype(
            np.int64)
        return (A.ptr, A.col, D, R), dict(kw, b_starts=starts, b_lens=blens)
    fp = tsd.plan_ragged_fetch(A, B, part, bpart)
    return (A.ptr, A.col, D, R), dict(
        kw, b_starts=[fp.recv_start[d].astype(np.int64) for d in range(D)],
        b_lens=[fp.recv_len[d].astype(np.int64) for d in range(D)],
        a_col_shards=[fp.a_col_remap[d][: int(part.nnz[d])]
                      for d in range(D)])


@pytest.fixture
def jax_planar(monkeypatch):
    """The JAX sharded planner planning planar fill streams."""
    monkeypatch.setattr(jbk, "plan_buckets",
                        functools.partial(jbk.plan_buckets, planar=True))


@pytest.mark.parametrize("fill", ["off", "on", "auto"])
@pytest.mark.parametrize("strategy", ["replicate", "allgather", "ragged"])
@pytest.mark.parametrize("name", ["powerlaw", "m9_d8", "rectangular"])
def test_sharded_plans_match_jax(name, strategy, fill, jax_planar,
                                 monkeypatch):
    """Port "auto" (as a state prepared for the card resolves it) against
    JAX "auto" with its TPU switch on."""
    if fill == "auto":
        monkeypatch.setattr(jrf, "on_tpu", lambda: True)
    A, B, D = case(name)
    pos, kw = sharded_args(A, B, D, strategy)
    tplans = tbk.plan_buckets_sharded(*pos, dma_fill=fill, **kw)
    jplans = jbk.plan_buckets_sharded(*pos, dma_fill=FILL[fill], **kw)
    assert len(tplans) == len(jplans) == D
    for tp, jp in zip(tplans, jplans):
        assert_plans_equal(tp, jp)
    specs = {tuple(tbk.class_spec(c) for c in p.classes) for p in tplans}
    assert len(specs) == 1
    if fill == "on" and name != "m9_d8":
        assert any(c.fill for c in tplans[0].classes)


@pytest.mark.parametrize("fill", ["off", "on"])
def test_grid_plans_match_jax(fill, jax_planar):
    """2-D bounds: the grid's virtual shards repeat row ranges."""
    A, B, _ = case("banded")
    bounds = tsd.balance_bounds(A, B, 2)
    R = tsd.partition_rows(A, 2, bounds=bounds).rows_per_shard
    vb = np.array([[bounds[r], bounds[r + 1]] for r in range(2)
                   for _ in range(2)], dtype=np.int64)
    kw = dict(b_ptr=B.ptr, min_width=2, vwords=1, bounds=vb)
    for tp, jp in zip(
            tbk.plan_buckets_sharded(A.ptr, A.col, 4, R, dma_fill=fill, **kw),
            jbk.plan_buckets_sharded(A.ptr, A.col, 4, R,
                                     dma_fill=FILL[fill], **kw)):
        assert_plans_equal(tp, jp)


@pytest.mark.parametrize("fill", ["off", "on"])
def test_plan_buckets_layout_and_forced_match_jax(fill):
    """One shard of the halo layout: free, then forced to a union with a
    width this shard has no rows for, and to widths too narrow (both
    raise ValueError)."""
    A, B, D = case("powerlaw")
    pos, kw = sharded_args(A, B, D, "ragged")
    d = 3
    lo, hi = int(kw["bounds"][d]), int(kw["bounds"][d + 1])
    ptr = (A.ptr[lo:hi + 1] - A.ptr[lo]).astype(A.ptr.dtype)
    col = kw["a_col_shards"][d]
    common = dict(min_width=2, vwords=2, b_starts=kw["b_starts"][d],
                  b_lens=kw["b_lens"][d])

    def both(**extra):
        return (tbk.plan_buckets(ptr, col, None, dma_fill=fill,
                                 precompute=False, planned="off",
                                 **common, **extra),
                jbk.plan_buckets(ptr, col, None, dma_fill=FILL[fill],
                                 planar=True, **common, **extra))

    free_t, free_j = both()
    assert_plans_equal(free_t, free_j)
    forced = {c.W: (c.rb, c.nchunks + 1, c.eb, c.fill)
              for c in free_t.classes}
    forced[4096] = (2, 1, 8, fill == "on")
    assert_plans_equal(*both(forced=forced))
    narrow = {2: (8, 1, 8, False)}        # the shard's rows need more
    for planner in (tbk.plan_buckets, jbk.plan_buckets):
        with pytest.raises(ValueError, match="narrower"):
            planner(ptr, col, None, forced=narrow, **common)


def test_empty_shard_gets_forced_classes():
    """A shard with no rows still holds every union class (all padding),
    and the engine's bounds-aware trim keeps its rows out of C."""
    A, B, D = case("m9_d8")
    pos, kw = sharded_args(A, B, D, "ragged")
    plans = tbk.plan_buckets_sharded(*pos, dma_fill="off", **kw)
    empty = [d for d in range(D) if kw["bounds"][d + 1] == kw["bounds"][d]]
    assert empty
    for d in empty:
        assert len(plans[d].classes) == len(plans[0].classes) > 0
        assert all((c.rows_g < 0).all() for c in plans[d].classes)


def jax_fields(p) -> dict:
    return {"m": p.m, "m_cap": p.m_cap, "intprod": p.intprod,
            "slab_row_start": p.slab_row_start, "dma_fill": p.dma_fill,
            "vwords": p.vwords, "classes": [vars(c) for c in p.classes]}


@pytest.mark.parametrize("fill", ["off", "on"])
@pytest.mark.parametrize("strategy", ["allgather", "ragged"])
def test_port_runs_jax_sharded_plans(strategy, fill, jax_planar,
                                     monkeypatch):
    """Each shard's plan rebuilt by plan_from_arrays from the JAX sharded
    plan gives the port's own C, exactly."""
    A = gen.powerlaw(300, avg_nnz=5, seed=22)
    mesh = make_row_mesh(4, devices=CPU)
    cfg = SpGEMMConfig(dma_fill=fill)
    own = tsd.spgemm_dist(A, None, mesh, config=cfg, b_strategy=strategy)

    def from_jax(*a, dma_fill, **kw):
        return [tbk.plan_from_arrays(jax_fields(p)) for p in
                jbk.plan_buckets_sharded(*a, dma_fill=FILL[dma_fill], **kw)]

    monkeypatch.setattr(tbk, "plan_buckets_sharded", from_jax)
    st = {}
    C = tsd.spgemm_dist(A, None, mesh, config=cfg, b_strategy=strategy,
                        state=st)
    assert C.equals(own, tol=0.0)
    assert any(c.fill for c in st["plans"][0].classes) == (fill == "on")
    assert C.equals(oracle_spgemm(A, A), tol=1e-9)


def test_pairs_planar_device_matches_host():
    rng = np.random.default_rng(3)
    col = rng.integers(0, 1000, 777).astype(np.int32)
    for dt, vw in ((np.float64, 2), (np.float32, 1)):
        val = rng.standard_normal(777).astype(dt)
        want = tbk.build_pairs_planar(col, val, vw, 32)
        got = tbk.pairs_planar_device(torch.from_numpy(col),
                                      torch.from_numpy(val), vw, 32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

def jax_dist(A, B, strategy, n, jcfg, grid=None):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    mesh = jmesh.make_grid_mesh(*grid) if grid else jmesh.make_row_mesh(n)
    return jsd.spgemm_dist(jcsr(A), None if B is None else jcsr(B), mesh,
                           config=jcfg, b_strategy=strategy)


JAX_SETTINGS = {
    # id: (matrix, D, strategy, port config, JAX config, grid)
    "replicate": ("powerlaw", 8, "replicate", {}, {}, None),
    "allgather-rect": ("rectangular", 4, "allgather", {}, {}, None),
    "ragged-xla": ("banded", 4, "ragged", {}, {}, None),
    "ragged-pallas-fill": ("banded", 4, "ragged",
                           dict(comm_backend="pallas", dma_fill="on"),
                           dict(comm_backend="pallas",
                                dma_fill="interpret"), None),
    "ragged_overlap": ("powerlaw", 4, "ragged_overlap", {}, {}, None),
    "grid2d-2x2": ("banded", 4, "grid2d", {}, {}, (2, 2)),
}


@pytest.mark.parametrize("sid", sorted(JAX_SETTINGS))
def test_dist_matches_jax_and_oracle(sid, monkeypatch):
    monkeypatch.setenv("MHSPGEMM_FORCE_OVERLAP", "1")
    name, D, strategy, tkw, jkw, grid = JAX_SETTINGS[sid]
    A, B, _ = CASES[name]()
    ref = oracle_spgemm(A, A if B is None else B)
    mesh = (make_grid_mesh(*grid, devices=CPU) if grid
            else make_row_mesh(D, devices=CPU))
    st = {}
    C = tsd.spgemm_dist(A, B, mesh, config=SpGEMMConfig(**tkw),
                        b_strategy=strategy, state=st)
    if strategy == "ragged_overlap":
        assert isinstance(st["plans"], tuple)         # the overlap ran
    J = jax_dist(A, B, strategy, D, JConfig(**jkw), grid)
    assert np.array_equal(C.ptr, J.ptr) and np.array_equal(C.col, J.col)
    assert C.equals(J, tol=1e-9)
    assert C.equals(ref, tol=1e-9)


STRATEGIES = ["replicate", "allgather", "ragged", "ragged_overlap"]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_dist_matches_oracle(name, strategy, monkeypatch):
    """Every 1-D strategy at the case's D and at D=1, forced overlap."""
    monkeypatch.setenv("MHSPGEMM_FORCE_OVERLAP", "1")
    A, B, D = CASES[name]()
    ref = oracle_spgemm(A, A if B is None else B)
    for n in (1, D):
        C = tsd.spgemm_dist(A, B, make_row_mesh(n, devices=CPU),
                            b_strategy=strategy)
        assert C.equals(ref, tol=1e-9), n


@pytest.mark.parametrize("grid", [(2, 2), (4, 2), (2, 4)])
def test_grid2d_matches_oracle(grid):
    for A in (gen.banded(120, band=9, nnz_per_row=5, seed=31),
              gen.powerlaw(300, avg_nnz=5, seed=32),
              gen.random_uniform(101, nnz_per_row=4, seed=33)):
        C = tsd.spgemm_dist(A, None, make_grid_mesh(*grid, devices=CPU),
                            b_strategy="grid2d")
        assert C.equals(oracle_spgemm(A, A), tol=1e-9)


@pytest.mark.parametrize("strategy", STRATEGIES + ["grid2d"])
def test_f32_fill_and_warm_state(strategy, monkeypatch):
    """f32 (1e-4) and the forced fill (1e-9), each cold and then twice
    warm through the state, which skips planning."""
    monkeypatch.setenv("MHSPGEMM_FORCE_OVERLAP", "1")
    A = gen.powerlaw(300, avg_nnz=5, seed=22)
    ref = oracle_spgemm(A, A)
    mesh = (make_grid_mesh(2, 2, devices=CPU) if strategy == "grid2d"
            else make_row_mesh(4, devices=CPU))
    for cfg, tol in ((SpGEMMConfig(value_dtype="float32"), 1e-4),
                     (SpGEMMConfig(dma_fill="on"), 1e-9)):
        st = {}
        for call in range(3):
            C = tsd.spgemm_dist(A, None, mesh, config=cfg,
                                b_strategy=strategy, state=st)
            assert C.val.dtype == np.dtype(cfg.value_dtype)
            assert C.equals(ref, tol=tol), call
        plans = st["plans"]
        first = plans[0][0] if isinstance(plans, tuple) else plans[0]
        if cfg.dma_fill == "on":
            assert any(c.fill for c in first.classes)


def test_warm_state_skips_planning(monkeypatch):
    A = gen.banded(100, band=7, nnz_per_row=4, seed=30)
    mesh = make_row_mesh(4, devices=CPU)
    st = {}
    C0 = tsd.spgemm_dist(A, None, mesh, b_strategy="ragged", state=st)

    def no_planning(*a, **k):
        raise AssertionError("a warm call planned again")

    monkeypatch.setattr(tbk, "plan_buckets_sharded", no_planning)
    for _ in range(2):
        C = tsd.spgemm_dist(A, None, mesh, b_strategy="ragged", state=st)
        assert C.equals(C0, tol=0.0)


@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["powerlaw", "m9_d8"])
def test_backends_bit_for_bit(name, value_dtype):
    """ragged under "xla" (torch all_to_all) and "pallas" (the
    halo_exchange wrapper, its plain version on CPU shards) give the same
    C bit for bit."""
    A, B, D = CASES[name]()
    mesh = make_row_mesh(D, devices=CPU)
    out = {}
    for backend in ("xla", "pallas"):
        cfg = SpGEMMConfig(value_dtype=value_dtype, comm_backend=backend)
        out[backend] = tsd.spgemm_dist(A, B, mesh, config=cfg,
                                       b_strategy="ragged")
    x, p = out["xla"], out["pallas"]
    assert np.array_equal(x.ptr, p.ptr) and np.array_equal(x.col, p.col)
    assert x.val.dtype == p.val.dtype and np.array_equal(x.val, p.val)
    assert trf.halo_exchange.launches == 0              # CPU: no kernel


def test_all_to_all_matches_halo_exchange_plain():
    rng = np.random.default_rng(1)
    D = 5
    sends = [torch.from_numpy(rng.integers(0, 99, (D, 2, 128)).astype(
        np.int32)) for _ in range(D)]
    got = comm.all_to_all(sends, [torch.device("cpu")] * D)
    want = trf.halo_exchange_plain(sends, n_devices=D)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_overlap_falls_back_on_cpu_mesh(monkeypatch):
    """The plan-time model rejects the overlap split on a CPU mesh, as in
    the JAX package; the result is the same."""
    monkeypatch.delenv("MHSPGEMM_FORCE_OVERLAP", raising=False)
    A = gen.powerlaw(300, avg_nnz=5, seed=22)
    st = {}
    C = tsd.spgemm_dist(A, None, make_row_mesh(4, devices=CPU),
                        b_strategy="ragged_overlap", state=st)
    assert not isinstance(st["plans"], tuple)          # plain ragged ran
    assert C.equals(oracle_spgemm(A, A), tol=1e-9)


def test_chunked_fallback(monkeypatch):
    """A shard plan overflow (a ValueError) falls back to row-chunked
    execution."""
    A = gen.powerlaw(300, avg_nnz=5, seed=33)
    ref = oracle_spgemm(A, A)
    calls = {"n": 0}
    real = tsd._spgemm_dist_bucketed

    def flaky(Asub, B, mesh_, config, b_strategy, state):
        calls["n"] += 1
        if calls["n"] == 1 and Asub.M == A.M:
            raise ValueError("padded slab exceeds int32 (simulated)")
        return real(Asub, B, mesh_, config, b_strategy, state)

    monkeypatch.setattr(tsd, "_spgemm_dist_bucketed", flaky)
    C = tsd.spgemm_dist(A, None, make_row_mesh(4, devices=CPU),
                        b_strategy="allgather")
    assert calls["n"] >= 2 and C.equals(ref, tol=1e-9)


def test_unported_and_unknown_settings_raise():
    A = gen.tiny_fixture()
    mesh = make_row_mesh(2, devices=CPU)
    # the flat ESC engine is ported: it runs (tests/test_torch_dist_esc.py)
    assert tsd.spgemm_dist(A, None, mesh, engine="esc").equals(
        oracle_spgemm(A, A), tol=1e-9)
    with pytest.raises(SpGEMMError):
        tsd.spgemm_dist(A, None, mesh, engine="flat")
    with pytest.raises(SpGEMMError):
        tsd.spgemm_dist(A, None, mesh, b_strategy="scatter")
    with pytest.raises(SpGEMMError, match="make_grid_mesh"):
        tsd.spgemm_dist(A, None, mesh, b_strategy="grid2d")
    with pytest.raises(ValueError, match="comm_backend"):
        tsd.spgemm_dist(A, None, mesh,
                        config=SpGEMMConfig(comm_backend="nccl"))
