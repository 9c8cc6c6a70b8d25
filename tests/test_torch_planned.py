"""The port's planned frontend and planned extraction (``ops/planned.py``,
``attach_planned``, ``front_planned``, ``bucketed_extract_planned``), the
long-span demotion and the legacy replan, against the JAX package on the
CPU.

- Host schedulers: ``plan_pgather``, ``plan_route`` and ``_stage_list``
  give the JAX functions' arrays exactly, on ``tests/test_planned.py``'s
  cases.
- Plain versions: ``pgather_plain`` and ``proute_plain`` equal the JAX
  ``pgather`` and ``proute`` run with ``interpret=True`` on every output
  word (schedule pads and network pads included), exact, for 1, 2 and 3
  planes and ``hold_w2`` in {1, 8, 1024}, with flags that leave some
  segments without a head.
- Plans: the port's ``plan_buckets(planned="on")`` equals the JAX
  planner's with ``planned="interpret"`` array for array, ``pf_host`` and
  ``pf_spec`` included (the JAX spec's interpret flag aside); so does the
  state ``prepare_bucketed_state`` makes where classes are demoted (and,
  past the 0.6 share, replanned), against the JAX pipeline with
  ``planned="interpret"`` and ``df32="on"``; and so do the planned
  extraction's schedules (``ext_pf``).
- Results: C of ``spgemm_bucketed(planned="on")``, cold and warm (the warm
  calls through the planned extraction), equals the JAX package's C
  (``planned="interpret"``, ``df32="on"`` for f64) and the oracle's under
  ``CSR.equals``: 1e-9 in f64 (the JAX side carries f64 as a Dekker pair,
  the port as the value's two raw words, so values agree to the
  comparator, not bit for bit), 1e-4 in f32 (the two tails add in other
  orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mh_spgemm_tpu as jm
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_tpu.ops import planned as jpn
from mh_spgemm_tpu.pipeline import prepare_bucketed_state as jprepare
from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.errors import DeviceError, SpGEMMError
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import planned as tpn
from mh_spgemm_torch.pipeline import (BucketedState, prepare_bucketed_state,
                                      spgemm_bucketed)

CPU = torch.device("cpu")
MATRICES = {
    "tiny_fixture": lambda: gen.tiny_fixture(),
    "banded": lambda: gen.banded(300, band=12, nnz_per_row=6, seed=5),
    "powerlaw": lambda: gen.powerlaw(400, avg_nnz=5, seed=42),
}
CLASS_FIELDS = ("W", "rb", "nchunks", "eb", "rows_g", "ent_dst", "ent_src",
                "ent_len", "ent_aidx", "hold_passes", "seg_passes", "pre",
                "slot_src", "slot_aidx", "fill", "pf")
GATHER_CASES = [(1000, 4096, 0), (5000, 2000, 1), (100, 100000, 2),
                (1, 64, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' torch ops run on one thread here: the test
    workers share the host's cores, and torch's thread pool, spinning
    against the other workers, slows them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcsr(A: CSR) -> JCSR:
    return JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col, val=A.val)


def assert_same(a, b, what: str) -> None:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


def assert_plans_equal(tp, jp) -> None:
    """Every class field, the planned schedules among them; the JAX
    spec's interpret flag (its fifth entry) has no counterpart."""
    assert (tp.m, tp.m_cap, tp.intprod) == (jp.m, jp.m_cap, jp.intprod)
    assert np.array_equal(tp.slab_row_start, jp.slab_row_start)
    assert len(tp.classes) == len(jp.classes)
    for tc, jc in zip(tp.classes, jp.classes):
        assert jc.G == 1
        for f in CLASS_FIELDS:
            assert_same(getattr(tc, f), getattr(jc, f), f)
        if jc.pf:
            assert tc.pf_spec == jc.pf_spec[:4] + jc.pf_spec[5:]
            assert set(tc.pf_host) == set(jc.pf_host)
            for k, v in jc.pf_host.items():
                assert_same(tc.pf_host[k], v, k)
        else:
            assert tc.pf_host is None and tc.pf_spec == ()


def jax_planned_plan(A, B, vwords: int):
    return jbk.plan_buckets(A.ptr, A.col, B.ptr, min_width=2, vwords=vwords,
                            dma_fill="off", planar=True, group="off",
                            precompute=True, planned="interpret")


# ---------------------------------------------------------------------------
# Host schedulers and plain versions against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,seed", GATHER_CASES)
def test_plan_pgather_matches_jax(S, T, seed):
    src = np.random.default_rng(seed).integers(0, T, S).astype(np.int64)
    for a, b in zip(tpn.plan_pgather(src, T), jpn.plan_pgather(src, T)):
        assert_same(a, b, "plan_pgather")


@pytest.mark.parametrize("m", [2, 1024, 4096, 16384])
def test_plan_route_matches_jax(m):
    """Random permutations and the routes the planner builds (a gather
    schedule's live positions to their slots, pads to the free ones)."""
    rng = np.random.default_rng(m)
    assert tpn._stage_list(m) == jpn._stage_list(m)
    dests = [rng.permutation(m).astype(np.int64)]
    if m >= 1024:
        src = rng.integers(0, 3 * m, m // 3).astype(np.int64)
        sch = tpn.plan_pgather(src, 0)
        if sch[3].size <= m:
            dests.append(tpn.route_dest(sch[3], m, rng.permutation(m)))
    for dest in dests:
        masks, nst = tpn.plan_route(dest, m)
        jm_, jn = jpn.plan_route(dest, m)
        assert nst == jn
        assert_same(masks, jm_, "masks")
    both = tpn.plan_routes(np.stack(dests))[0]
    for k, dest in enumerate(dests):
        assert np.array_equal(both[k], jpn.plan_route(dest, m)[0])


@pytest.mark.parametrize("nplanes", [1, 2, 3])
@pytest.mark.parametrize("S,T,seed", GATHER_CASES)
def test_pgather_plain_matches_jax_interpret(S, T, seed, nplanes):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, T, S).astype(np.int64)
    wblk, rowsel, lane, perm = tpn.plan_pgather(src, T)
    tabs = [rng.integers(-2**31, 2**31 - 1, T + 1200, dtype=np.int64)
            .astype(np.int32) for _ in range(nplanes)]
    want = jpn.pgather([jnp.asarray(t) for t in tabs], jnp.asarray(wblk),
                       jnp.asarray(rowsel), jnp.asarray(lane), interpret=True)
    sched = [torch.from_numpy(x) for x in (wblk, rowsel, lane)]
    before = tpn.pgather.launches
    got = tpn.pgather([torch.from_numpy(t) for t in tabs], *sched)
    assert tpn.pgather.launches == before          # CPU tensors: plain
    assert got.shape == (nplanes, wblk.size * 1024)
    for p in range(nplanes):
        assert np.array_equal(got[p].numpy(), np.asarray(want[p]))
        live = perm >= 0
        assert np.array_equal(got[p].numpy()[live], tabs[p][src[perm[live]]])


@pytest.mark.parametrize("nplanes", [1, 2, 3])
@pytest.mark.parametrize("hold_w2", [1, 8, 1024])
@pytest.mark.parametrize("m", [1024, 2048])
def test_proute_plain_matches_jax_interpret(m, hold_w2, nplanes):
    """Random flags leave some segments without a head (the passes then
    leave zeros or copies there, in both packages alike); a second run has
    a head at every segment start, as the A route's flags do."""
    rng = np.random.default_rng(m + hold_w2 + nplanes)
    dest = rng.permutation(m).astype(np.int64)
    masks, nst = tpn.plan_route(dest, m)
    vals = rng.integers(-2**31, 2**31 - 1, (nplanes, m),
                        dtype=np.int64).astype(np.int32)
    sparse = (rng.random(m) < 0.05).astype(np.int32)
    heads = sparse.copy()
    heads[::hold_w2] = 1
    for flags in (sparse, heads):
        want = jpn.proute([jnp.asarray(v) for v in vals], jnp.asarray(masks),
                          nst, hold_w2=hold_w2, flags=jnp.asarray(flags),
                          interpret=True)
        got = tpn.proute(torch.from_numpy(vals), torch.from_numpy(masks), nst,
                         hold_w2=hold_w2, flags=torch.from_numpy(flags))
        for p in range(nplanes):
            assert np.array_equal(got[p].numpy(), np.asarray(want[p]))
        if hold_w2 == 1:
            ref = np.zeros_like(vals)
            ref[:, dest] = vals
            assert np.array_equal(got.numpy(), ref)


def test_proute_batches_networks():
    """Leading batch dimensions are independent networks."""
    rng = np.random.default_rng(5)
    m = 2048
    dest = np.stack([rng.permutation(m) for _ in range(3)])
    masks, nst = tpn.plan_routes(dest)
    vals = rng.integers(0, 1 << 30, (2, 3, m)).astype(np.int32)
    got = tpn.proute(torch.from_numpy(vals), torch.from_numpy(masks), nst)
    for b in range(3):
        one = tpn.proute(torch.from_numpy(vals[:, b]),
                         torch.from_numpy(masks[b]), nst)
        assert torch.equal(got[:, b], one)


def test_f64_pair_detection():
    """The kernel reads two neighbouring planes with one 8-byte load only
    where they are the low and high words of one f64 array, in order."""
    v = torch.zeros(100, dtype=torch.float64)
    w = v.view(torch.int32)
    col = torch.zeros(100, dtype=torch.int32)
    assert tpn._f64_pair([col, w[0::2], w[1::2]]) == 1
    assert tpn._f64_pair([w[0::2], w[1::2]]) == 0
    assert tpn._f64_pair([w[1::2], w[0::2]]) == -1           # swapped
    assert tpn._f64_pair([w[0::2], w[1::2][:99]]) == -1      # lengths differ
    assert tpn._f64_pair([w[1:-1][0::2], w[1:-1][1::2]]) == -1  # misaligned
    assert tpn._f64_pair([col, col]) == -1
    assert tpn._f64_pair([w[0::2]]) == -1
    assert tpn._nstages(1024) == len(tpn._stage_list(1024))
    assert tpn._nstages(131072) == len(tpn._stage_list(131072))


def test_wrappers_check_their_inputs():
    """Shapes, types, stage counts and devices the kernels do not take
    raise; a device without a kernel raises DeviceError."""
    wblk, rowsel, lane, _ = tpn.plan_pgather(np.arange(300), 300)
    sched = [torch.from_numpy(x) for x in (wblk, rowsel, lane)]
    tab = torch.arange(300, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpn.pgather([tab] * 4, *sched)
    with pytest.raises(ValueError):
        tpn.pgather([tab.long()], *sched)
    with pytest.raises(ValueError):
        tpn.pgather([tab], sched[0], sched[1][:, :64], sched[2])
    masks, nst = tpn.plan_route(np.arange(1024), 1024)
    x = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpn.proute(x, torch.from_numpy(masks), nst + 1)
    with pytest.raises(ValueError):
        tpn.proute(x[:, :512], torch.from_numpy(masks)[:, :512], 45)
    with pytest.raises(ValueError):
        tpn.proute(x, torch.from_numpy(masks), nst, hold_w2=3,
                   flags=torch.ones(1024, dtype=torch.int32))
    meta = torch.device("meta")
    with pytest.raises(DeviceError):
        tpn.pgather([tab.to(meta)], *[s.to(meta) for s in sched])
    with pytest.raises(DeviceError):
        tpn.proute(x.to(meta), torch.from_numpy(masks).to(meta), nst)


# ---------------------------------------------------------------------------
# Plans against the JAX planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vwords", [2, 1])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_planned_planner_matches_jax(name, vwords):
    A = MATRICES[name]()
    tp = tbk.plan_buckets(A.ptr, A.col, A.ptr, vwords=vwords, planned="on")
    assert_plans_equal(tp, jax_planned_plan(A, A, vwords))
    assert any(c.pf for c in tp.classes)
    assert all(c.frontend == ("planned" if c.pf else "pre")
               for c in tp.classes)


def test_planned_planner_matches_jax_chunked():
    """A small area cap cuts classes into several chunks, each with its
    own schedules; a rectangular B."""
    A = gen.powerlaw(500, avg_nnz=6, seed=3)
    B = A.transpose()
    for vwords in (2, 1):
        tp = tbk.plan_buckets(A.ptr, A.col, B.ptr, area_cap=1 << 10,
                              vwords=vwords, planned="on")
        jp = jbk.plan_buckets(A.ptr, A.col, B.ptr, min_width=2,
                              area_cap=1 << 10, vwords=vwords,
                              dma_fill="off", planar=True, group="off",
                              precompute=True, planned="interpret")
        assert_plans_equal(tp, jp)
        assert max(c.nchunks for c in tp.classes if c.pf) > 1


def long_span(demote_only: bool) -> CSR:
    """Three A rows that each reference ten B rows of 5000 nonzeros (W =
    65536, one row a chunk: past the planned frontend's chunk cap, so the
    class is demoted), plus A rows over short B rows.  With
    ``demote_only`` the short rows hold most of the slots and the plan is
    kept; otherwise the demoted class dominates and the pipeline
    replans."""
    rng = np.random.default_rng(11)
    n = 20000
    long_rows = [np.sort(rng.choice(n, 5000, replace=False))
                 for _ in range(10)]
    rows = [np.full(5000, r) for r in range(10)]
    cols = list(long_rows)
    for r in range(10, n):                  # short B rows of 3 nonzeros
        rows.append(np.full(3, r))
        cols.append(rng.choice(n, 3, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    a_rows = [np.full(10, i) for i in range(3)]
    a_cols = [rng.choice(10, 10, replace=False) for _ in range(3)]
    nshort = 20000 if demote_only else 40
    for i in range(3, 3 + nshort):
        a_rows.append(np.full(2, i))
        a_cols.append(rng.choice(np.arange(10, n), 2, replace=False))
    a_rows, a_cols = np.concatenate(a_rows), np.concatenate(a_cols)
    B = CSR.from_coo(n, n, rows, cols, rng.standard_normal(rows.size))
    A = CSR.from_coo(3 + nshort, n, a_rows, a_cols,
                     rng.standard_normal(a_rows.size))
    return A, B


@pytest.mark.parametrize("case", ["demote", "replan"])
def test_demotion_and_replan_match_jax(case):
    """The long-span demotion and the legacy-replan rule: the port's state
    holds the JAX pipeline's plan, and C equals the oracle."""
    A, B = long_span(case == "demote")
    st = prepare_bucketed_state(A, B, SpGEMMConfig(planned="on"),
                                device="cpu")
    jst = jprepare(jcsr(A), jcsr(B), jm.SpGEMMConfig(
        mode="bucketed", planned="interpret", df32="on"))
    assert st.planned == "on" and st.replanned == (case == "replan")
    assert_plans_equal(st.plan, jst.plan)
    fronts = [c.frontend for c in st.plan.classes]
    if case == "replan":
        assert set(fronts) == {"gather"}
    else:
        assert "gather" in fronts and "planned" in fronts
        assert [c.W for c in st.plan.classes if not c.pre] == [65536]
    ref = oracle_spgemm(A, B)
    for _ in range(2):
        C, st = spgemm_bucketed(A, B, config=SpGEMMConfig(planned="on"),
                                state=st)
        assert C.host().equals(ref, tol=1e-9)


@pytest.mark.parametrize("name", ["banded", "powerlaw"])
def test_planned_extract_matches_jax(name):
    """ext_pf and its spec from the learned row counts, as the JAX
    planner's attach_static_extract makes them (interpret flag aside)."""
    A = MATRICES[name]()
    crow = np.diff(oracle_spgemm(A, A).ptr)
    tp = tbk.plan_buckets(A.ptr, A.col, A.ptr, planned="on")
    jp = jax_planned_plan(A, A, 2)
    tbk.warm_plan_from_crow(tp, crow)
    jbk.warm_plan_from_crow(jp, crow)
    assert np.array_equal(tp.ext_src_h, jp.ext_src_h)
    assert tp.ext is None and tp.ext_pf is not None
    assert tp.ext_pf_spec == jp.ext_pf_spec[:4]
    for k, v in jp.ext_pf.items():
        assert_same(tp.ext_pf[k], v, k)


# ---------------------------------------------------------------------------
# Results against the JAX package and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["banded", "powerlaw"])
def test_planned_path_matches_jax_and_oracle(name, value_dtype, monkeypatch):
    A = MATRICES[name]()
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    J = jm.spgemm_host(jcsr(A), config=jm.SpGEMMConfig(
        mode="bucketed", value_dtype=value_dtype, planned="interpret",
        df32="on", dma_fill="off"))
    ref = oracle_spgemm(A, A)
    calls = []
    planned_extract = tbk.bucketed_extract_planned

    def spy(*a, **k):
        calls.append(1)
        return planned_extract(*a, **k)

    monkeypatch.setattr(tbk, "bucketed_extract_planned", spy)
    cfg = SpGEMMConfig(value_dtype=value_dtype, planned="on")
    state = None
    for call in range(3):
        C, state = spgemm_bucketed(A, A, config=cfg, state=state,
                                   device="cpu")
        H = C.host()
        assert np.array_equal(H.ptr, J.ptr) and np.array_equal(H.col, J.col)
        assert H.equals(J, tol=tol) and H.equals(ref, tol=tol), call
        assert len(calls) == call            # warm calls only
    assert any(c.pf for c in state.plan.classes)
    assert state.plan.ext is None and state.plan.ext_pf is not None


def test_device_stage_on_jax_planned_plan():
    """A JAX plan with planned classes, carried across by
    plan_from_arrays, runs on the port and gives the port's own C."""
    A = MATRICES["powerlaw"]()
    jp = jax_planned_plan(A, A, 2)
    fields = {"m": jp.m, "m_cap": jp.m_cap, "intprod": jp.intprod,
              "slab_row_start": jp.slab_row_start,
              "classes": [vars(c) for c in jp.classes]}
    plan = tbk.plan_from_arrays(fields)
    assert [c.frontend for c in plan.classes] == ["planned"] * len(jp.classes)
    assert_plans_equal(plan, jp)
    own, _ = spgemm_bucketed(A, A, config=SpGEMMConfig(planned="on"),
                             device="cpu")
    st = BucketedState(plan=plan, device=CPU, route="kernel", planned="on")
    for _ in range(2):
        C, st = spgemm_bucketed(A, A, config=SpGEMMConfig(planned="on"),
                                state=st)
        assert C.host().equals(own.host(), tol=0.0)


def test_state_keeps_its_planned():
    """A warm call runs a state only under the planned setting it was
    prepared for, as resolved for its device: "on" and "off" refuse each
    other's state, and on the CPU "auto" (off there) takes "off"'s."""
    A = MATRICES["banded"]()
    on, off, auto = (SpGEMMConfig(planned=v) for v in ("on", "off", "auto"))
    _, st_on = spgemm_bucketed(A, A, config=on, device="cpu")
    _, st_off = spgemm_bucketed(A, A, config=off, device="cpu")
    assert st_on.planned == "on" and st_off.planned == "off"
    for cfg, st in ((off, st_on), (auto, st_on), (on, st_off)):
        with pytest.raises(SpGEMMError, match="planned"):
            spgemm_bucketed(A, A, config=cfg, state=st)
    C, _ = spgemm_bucketed(A, A, config=auto, state=st_off)
    assert C.host().equals(oracle_spgemm(A, A), tol=1e-9)


def test_chunked_and_host_run_planned():
    """spgemm_chunked (a planned state per row range) and spgemm_host
    under planned="on" give the oracle's C."""
    from mh_spgemm_torch import spgemm_chunked, spgemm_host
    A = gen.powerlaw(500, avg_nnz=6, max_row=120, seed=8)
    cfg = SpGEMMConfig(planned="on")
    ref = oracle_spgemm(A, A)
    parts = spgemm_chunked(A, A, config=cfg, max_products=A.intprod(A) // 5,
                           device="cpu")
    assert parts.equals(ref, tol=1e-9)
    assert spgemm_host(A, config=cfg, device="cpu").equals(ref, tol=1e-9)
