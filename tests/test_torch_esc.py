"""The port's DeviceCSR-level engines (``pipeline.spgemm`` with
``mode="esc"`` and the product-granularity ``mode="masked"``) and their
stages against the JAX package, on the CPU.

Inputs come from ``mh_spgemm_tpu.bench.gen`` with fixed seeds and are
uploaded by both packages' ``CSR.device(pad=True)``, so both see the same
capacity-padded arrays.

- Stages, array for array: ``expand_segments``, ``expand_products`` and
  ``expand_products_sl``, ``seg_scan`` (add and OR), ``compact_multi``
  (its fill tail and dropped flags), ``bin_rows``, ``group_size`` and
  ``scan_passes`` are equal.  ``symbolic``: ``crow_nnz``,
  ``ctiles_row``, ``totals``, ``run_id_unsorted``, ``sort_row``,
  ``sort_tcol`` and ``is_end`` are equal; ``or_mask`` is equal at the run
  ends only (inside a run it depends on the order of equal keys).
  ``c_structure`` is equal.  ``numeric_esc``: ``cptr``, ``crow_nnz``,
  ``col_cap`` and ``nnz_total`` equal, ``val_cap`` within 1e-9.
  ``finish_masked``: the structure equal, the values within 1e-9 (its
  ``index_add_`` adds in another order than XLA's scatter, and on the
  card by atomics).  Tile masks are compared as their 32 bits.
- Engines: C of ``spgemm`` (esc, masked and the default) and of
  ``spgemm_host(mode="esc")`` equals the JAX package's C and the scipy
  oracle's under ``CSR.equals`` (1e-9 in f64, 1e-4 in f32), on the
  matrices of ``tests/test_pipeline.py``; a warm plan gives the same C.
- Guards: the masked budget and the int32 limits raise ``SpGEMMError``
  where the JAX package's raise.

The JAX side's compiles dominate: the matrices are few and small, and the
stage tests reuse the engine tests' shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mh_spgemm_tpu as jm
import mh_spgemm_tpu.pipeline as jpl
from mh_spgemm_tpu.bench import gen as jgen
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.errors import SpGEMMError as JSpGEMMError
from mh_spgemm_tpu.ops import binning as jbin
from mh_spgemm_tpu.ops import expand as jex
from mh_spgemm_tpu.ops import mask as jmask
from mh_spgemm_tpu.ops import numeric as jnum
from mh_spgemm_tpu.ops import scan as jscan
from mh_spgemm_tpu.ops import symbolic as jsym
import mh_spgemm_torch as tm
import mh_spgemm_torch.pipeline as tpl
from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.errors import SpGEMMError
from mh_spgemm_torch.ops import binning as tbin
from mh_spgemm_torch.ops import expand as tex
from mh_spgemm_torch.ops import mask as tmask
from mh_spgemm_torch.ops import numeric as tnum
from mh_spgemm_torch.ops import scan as tscan
from mh_spgemm_torch.ops import symbolic as tsym
from mh_spgemm_torch.ops.shapes import quantize

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's torch ops run on one thread here: the test workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rect_pair():
    rng = np.random.default_rng(6)
    A = JCSR.from_coo(50, 80, rng.integers(0, 50, 300),
                      rng.integers(0, 80, 300), rng.standard_normal(300),
                      sum_duplicates=True)
    B = JCSR.from_coo(80, 30, rng.integers(0, 80, 200),
                      rng.integers(0, 30, 200), rng.standard_normal(200),
                      sum_duplicates=True)
    return A, B


# (A, B or None for A @ A), all JAX-package CSRs
PAIRS = {
    "tiny_fixture": lambda: (jgen.tiny_fixture(), None),
    "banded": lambda: (jgen.banded(200, band=12, nnz_per_row=6, seed=1),
                       None),
    "random": lambda: (jgen.random_uniform(150, nnz_per_row=5, seed=2),
                       None),
    "powerlaw": lambda: (jgen.powerlaw(300, avg_nnz=5, seed=3), None),
    "kron": lambda: (jgen.kron(scale=8, edge_factor=4, seed=4), None),
    "diag_blocks": lambda: (jgen.diag_blocks(128, block=8, seed=5), None),
    "rect": _rect_pair,
    "single": lambda: (JCSR.from_coo(4, 4, [1], [2], [3.0]),
                       JCSR.from_coo(4, 4, [2], [0], [2.0])),
    "cancel": lambda: (JCSR.from_coo(2, 2, [0, 0, 1, 1], [0, 1, 0, 1],
                                     [1.0, -1.0, 1.0, 1.0]), None),
}
STAGE_PAIRS = ("powerlaw", "rect", "kron")


def port(J) -> CSR:
    return CSR.from_arrays(J.M, J.N, J.ptr, J.col, J.val)


def operands(name):
    JA, JB = PAIRS[name]()
    JB = JA if JB is None else JB
    return JA, JB, port(JA), port(JB)


def np_(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def equal(t, j, what=""):
    a, b = np_(t), np_(j)
    if b.dtype == np.uint32:
        a = a.view(np.uint32)
    assert a.shape == b.shape and np.array_equal(a, b), what


def close(t, j, tol=1e-9, what=""):
    a, b = np_(t).astype(np.float64), np_(j).astype(np.float64)
    d = np.abs(a - b)
    assert a.shape == b.shape and bool(
        ((a == b) | (d < tol) | (d < tol * np.abs(b))).all()), what


def devices(name, dtype=torch.float64):
    """Both packages' padded device operands of a pair."""
    JA, JB, A, B = operands(name)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jdA = JA.device(jd, pad=True)
    jdB = JB.device(jd, pad=True) if JB is not JA else jdA
    tdA = A.device(dtype, pad=True, device=CPU)
    tdB = B.device(dtype, pad=True, device=CPU)
    return jdA, jdB, tdA, tdB


def test_device_upload_matches_jax():
    jdA, _, tdA, _ = devices("powerlaw")
    for f in ("ptr", "col", "val"):
        equal(getattr(tdA, f), getattr(jdA, f), f)
    assert (tdA.m_pad, tdA.nnz_pad, tdA.nnz) == (jdA.m_pad, jdA.nnz_pad,
                                                 jdA.nnz)
    assert tdA.ptr.dtype == torch.int32 and tdA.device.type == "cpu"
    A = operands("powerlaw")[2]
    assert CSR.from_scipy(A.to_scipy()).equals(A, tol=0.0)
    assert np.array_equal(A.row_nnz(), np.diff(A.ptr))
    B = A.copy()
    B.val[0] += 1.0
    assert not B.equals(A, tol=0.0)


# -- stages ------------------------------------------------------------------

@pytest.mark.parametrize("total", [1, 17, 40, 64])
def test_expand_segments_matches_jax(total):
    rng = np.random.default_rng(total)
    lens = (rng.integers(0, 5, 24) * (rng.random(24) < 0.7)).astype(
        np.int32)
    lens[-3:] = 0                         # trailing empty segments
    t = tex.expand_segments(torch.from_numpy(lens), total)
    j = jex.expand_segments(jnp.asarray(lens), total)
    for f in ("seg_id", "offset", "starts"):
        equal(getattr(t, f), getattr(j, f), f)


@pytest.mark.parametrize("name", STAGE_PAIRS)
def test_expand_products_matches_jax(name):
    jdA, jdB, tdA, tdB = devices(name)
    total = quantize(operands(name)[2].intprod(operands(name)[3]))
    t = tex.expand_products(tdA.ptr, tdA.col, tdB.ptr, total, tdA.nnz_pad)
    j = jex.expand_products(jdA.ptr, jdA.col, jdB.ptr, total, jdA.nnz_pad)
    for f in ("crow", "src", "a_idx", "valid"):
        equal(getattr(t, f), getattr(j, f), f)
    # explicit segments with a valid count short of the true nnz
    ac = tdA.col.long()
    starts, lens = tdB.ptr[ac], tdB.ptr[ac + 1] - tdB.ptr[ac]
    jc = jdA.col
    keep = tdA.nnz // 2
    t = tex.expand_products_sl(tdA.ptr, tdA.col, starts, lens, total,
                               tdA.nnz_pad,
                               a_nnz_valid=torch.tensor(keep))
    j = jex.expand_products_sl(jdA.ptr, jc, jdB.ptr[jc],
                               jdB.ptr[jc + 1] - jdB.ptr[jc], total,
                               jdA.nnz_pad, a_nnz_valid=jnp.int32(keep))
    for f in ("crow", "src", "a_idx", "valid"):
        equal(getattr(t, f), getattr(j, f), f)


@pytest.mark.parametrize("max_seg", [1, 3, 8, 64])
def test_seg_scan_matches_jax(max_seg):
    rng = np.random.default_rng(max_seg)
    n = 300
    flags = rng.random(n) < 0.2
    flags[0] = True
    # no segment longer than max_seg
    run = 0
    for i in range(n):
        run = 1 if flags[i] else run + 1
        if run > max_seg:
            flags[i], run = True, 1
    vals = rng.standard_normal(n)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    tf = torch.from_numpy(flags)
    equal(tscan.seg_scan(torch.add, tf, torch.from_numpy(vals), max_seg),
          jscan.seg_scan(jnp.add, jnp.asarray(flags), jnp.asarray(vals),
                         max_seg), "add")
    equal(tscan.seg_sum_at_runs(torch.from_numpy(vals), tf, max_seg),
          jscan.seg_sum_at_runs(jnp.asarray(vals), jnp.asarray(flags),
                                max_seg), "seg_sum_at_runs")
    equal(tscan.seg_scan(torch.bitwise_or, tf,
                         torch.from_numpy(bits.view(np.int32)), max_seg),
          jscan.seg_scan(jnp.bitwise_or, jnp.asarray(flags),
                         jnp.asarray(bits), max_seg), "or")


@pytest.mark.parametrize("out_size", [5, 40, 120])
def test_compact_multi_matches_jax(out_size):
    rng = np.random.default_rng(out_size)
    flags = rng.random(100) < 0.4          # about 40 set: 5 drops most
    a = rng.integers(-50, 50, 100).astype(np.int32)
    b = rng.standard_normal(100)
    t = tscan.compact_multi((torch.from_numpy(a), torch.from_numpy(b)),
                            torch.from_numpy(flags), out_size)
    j = jscan.compact_multi((jnp.asarray(a), jnp.asarray(b)),
                            jnp.asarray(flags), out_size)
    for x, y in zip(t, j):
        equal(x, y)
    equal(tscan.compact(torch.from_numpy(a), torch.from_numpy(flags),
                        out_size, fill=-7),
          jscan.compact(jnp.asarray(a), jnp.asarray(flags), out_size,
                        fill=-7), "fill")
    idx = np.array([0, 3, 7])
    incl = np.cumsum(b[:7])
    equal(tscan.cum_at(torch.from_numpy(incl), torch.from_numpy(idx)),
          jscan.cum_at(jnp.asarray(incl), jnp.asarray(idx)), "cum_at")


def test_binning_matches_jax():
    rng = np.random.default_rng(11)
    work = rng.integers(0, 5000, 257).astype(np.int32)
    bounds = SpGEMMConfig().bin_bounds
    t = tbin.bin_rows(torch.from_numpy(work), bounds)
    j = jbin.bin_rows(jnp.asarray(work), bounds)
    for f in t._fields:
        equal(getattr(t, f), getattr(j, f), f)
    for flop, nnz in ((0, 0), (1, 1), (100, 7), (5000, 3), (10**6, 900),
                      (64, 64)):
        assert tbin.group_size(flop, nnz) == jbin.group_size(flop, nnz)
    for g in (0, 1, 2, 3, 64, 65):
        assert tbin.scan_passes(g) == jbin.scan_passes(g)


def _symbolic_pair(name):
    jdA, jdB, tdA, tdB = devices(name)
    jst = jmask.mask_stage(jdB.ptr, jdB.col, jdA.ptr, jdA.col)
    tst = tmask.mask_stage(tdB.ptr, tdB.col, tdA.ptr, tdA.col)
    t_prime = int(np.asarray(jst.totals)[1])
    max_group = jpl.make_plan(jdA, jdB).max_group
    assert tpl.make_plan(tdA, tdB).max_group == max_group
    total = quantize(t_prime)
    jsr = jsym.symbolic(jdA.ptr, jdA.col, jst.mask, total, max_group)
    tsr = tsym.symbolic(tdA.ptr, tdA.col, tst.mask, total, max_group)
    return jdA, jdB, tdA, tdB, jst, tst, jsr, tsr


@pytest.mark.parametrize("name", STAGE_PAIRS)
def test_symbolic_and_structure_match_jax(name):
    *_, jsr, tsr = _symbolic_pair(name)
    for f in ("crow_nnz", "ctiles_row", "totals", "run_id_unsorted",
              "sort_row", "sort_tcol", "is_end"):
        equal(getattr(tsr, f), getattr(jsr, f), f)
    ends = np.asarray(jsr.is_end)
    equal(tsr.or_mask.numpy()[ends], np.asarray(jsr.or_mask)[ends],
          "or_mask at run ends")
    nnz_c, tc = (int(x) for x in np.asarray(jsr.totals))
    jcs = jsym.c_structure(jsr, quantize(tc), quantize(nnz_c))
    tcs = tsym.c_structure(tsr, quantize(tc), quantize(nnz_c))
    for f in jcs._fields:
        equal(getattr(tcs, f), getattr(jcs, f), f)


@pytest.mark.parametrize("name", STAGE_PAIRS)
def test_finish_masked_matches_jax(name):
    jdA, jdB, tdA, tdB, jst, tst, jsr, tsr = _symbolic_pair(name)
    intprod = int(np.asarray(jst.totals)[2])
    nnz_c, tc = (int(x) for x in np.asarray(jsr.totals))
    caps = (quantize(intprod), quantize(tc), quantize(nnz_c))
    jcs, jval = jnum.finish_masked(jdA.ptr, jdA.col, jdA.val, jdB.ptr,
                                   jdB.col, jdB.val, jst.mask, jsr, *caps)
    tcs, tval = tnum.finish_masked(tdA.ptr, tdA.col, tdA.val, tdB.ptr,
                                   tdB.col, tdB.val, tst.mask, tsr, *caps)
    for f in jcs._fields:
        equal(getattr(tcs, f), getattr(jcs, f), f)
    close(tval, jval, what="values")
    close(tnum.numeric_masked(tdA.ptr, tdA.col, tdA.val, tdB.ptr, tdB.col,
                              tdB.val, tst.mask, tsr, tcs, tdA.nnz_pad,
                              caps[0], caps[2]), jval)


@pytest.mark.parametrize("name", STAGE_PAIRS)
def test_numeric_esc_matches_jax(name):
    jdA, jdB, tdA, tdB = devices(name)
    total = quantize(operands(name)[2].intprod(operands(name)[3]))
    max_group = jpl.make_plan(jdA, jdB).max_group
    j = jnum.numeric_esc(jdA.ptr, jdA.col, jdA.val, jdB.ptr, jdB.col,
                         jdB.val, total, total, max_group)
    t = tnum.numeric_esc(tdA.ptr, tdA.col, tdA.val, tdB.ptr, tdB.col,
                         tdB.val, total, total, max_group)
    for f in ("cptr", "crow_nnz", "col_cap", "nnz_total"):
        equal(getattr(t, f), getattr(j, f), f)
    close(t.val_cap, j.val_cap, what="val_cap")


# -- engines -----------------------------------------------------------------

def _jax_c(JA, JB, mode, value_dtype="float64"):
    cfg = jm.SpGEMMConfig(mode=mode, value_dtype=value_dtype)
    jdA = JA.device(cfg.vdtype, pad=True)
    jdB = JB.device(cfg.vdtype, pad=True) if JB is not JA else jdA
    return port(jm.spgemm(jdA, jdB, config=cfg).host())


@pytest.mark.parametrize("mode", ["esc", "masked", "bucketed"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_matches_jax(name, mode):
    """spgemm on padded device operands: esc, masked, and the default
    mode ("bucketed", served by ESC at this level); a warm plan gives the
    same C."""
    JA, JB, A, B = operands(name)
    ref = oracle_spgemm(A, B)
    cfg = SpGEMMConfig(mode=mode)
    dA = A.device(cfg.vdtype, pad=True, device=CPU)
    dB = B.device(cfg.vdtype, pad=True, device=CPU)
    plan = tm.make_plan(dA, dB)
    C = tm.spgemm(dA, dB, config=cfg, plan=plan)
    assert isinstance(plan, tm.SpGEMMPlan) and plan.nnz_c == ref.nnz
    Ch = C.host()
    assert Ch.equals(ref, tol=1e-9)
    assert Ch.equals(_jax_c(JA, JB, mode), tol=1e-9)
    Cw = tm.spgemm(dA, dB, config=cfg, plan=plan).host()
    assert Cw.equals(Ch, tol=0.0)


@pytest.mark.parametrize("name", ["banded", "rect", "cancel"])
def test_spgemm_host_esc(name):
    JA, JB, A, B = operands(name)
    cfg = SpGEMMConfig(mode="esc")
    t = tm.Timing()
    C = tm.spgemm_host(A, None if JB is JA else B, config=cfg, timing=t,
                       device=CPU)
    ref = oracle_spgemm(A, B)
    assert C.nnz == ref.nnz and C.equals(ref, tol=1e-9)
    J = jm.spgemm_host(JA, None if JB is JA else JB,
                       config=jm.SpGEMMConfig(mode="esc"))
    assert C.equals(port(J), tol=1e-9)
    assert t.numeric > 0 and t.total() > 0


def test_aat_and_empty():
    JA = jgen.banded(100, band=7, nnz_per_row=4, seed=7)
    A = port(JA)
    cfg = SpGEMMConfig(mode="esc", aat=True)
    C = tm.spgemm_host(A, config=cfg, device=CPU)
    assert C.equals(oracle_spgemm(A, A.transpose()), tol=1e-9)
    Z = CSR.from_coo(10, 10, [], [], [])
    for mode in ("esc", "masked"):
        cfg = SpGEMMConfig(mode=mode)
        dZ = Z.device(cfg.vdtype, pad=True, device=CPU)
        C = tm.spgemm(dZ, dZ, config=cfg).host()
        assert C.nnz == 0 and C.ptr.tolist() == [0] * 11
    C = tm.spgemm_host(Z, config=SpGEMMConfig(mode="esc"), device=CPU)
    assert C.nnz == 0 and C.ptr.tolist() == [0] * 11


@pytest.mark.parametrize("mode", ["esc", "masked"])
def test_float32(mode):
    JA = jgen.banded(100, band=9, nnz_per_row=5, seed=8)
    A = port(JA)
    cfg = SpGEMMConfig(mode=mode, value_dtype="float32", tolerance=1e-4)
    dA = A.device(cfg.vdtype, pad=True, device=CPU)
    C = tm.spgemm(dA, dA, config=cfg).host()
    assert C.val.dtype == np.float32
    assert C.equals(oracle_spgemm(A, A), tol=1e-4)
    assert C.equals(_jax_c(JA, JA, mode, "float32"), tol=1e-4)


def test_masked_agrees_with_esc():
    A = port(jgen.powerlaw(200, avg_nnz=6, seed=9))
    out = []
    for mode in ("masked", "esc"):
        cfg = SpGEMMConfig(mode=mode)
        dA = A.device(cfg.vdtype, pad=True, device=CPU)
        out.append(tm.spgemm(dA, dA, config=cfg).host())
    assert out[0].equals(out[1], tol=1e-12)


def test_seven_phases_recorded():
    A = port(jgen.banded(200, band=12, nnz_per_row=6, seed=1))
    cfg = SpGEMMConfig(mode="masked")
    dA = A.device(cfg.vdtype, pad=True, device=CPU)
    t = tm.Timing()
    tm.spgemm(dA, dA, config=cfg, timing=t)
    assert t.form_mask_matrix_b > 0 and t.calculate_c_nnz > 0
    assert t.numeric > 0 and t.total() > 0
    assert abs(t.total() - (t.mem_alloc + t.symbolic_binning +
                            t.calculate_c_nnz + t.malloc_c_col_val +
                            t.numeric_binning + t.numeric)) < 1e-9


# -- guards ------------------------------------------------------------------

def _both_raise(cfg_kw, mode="masked", name="banded"):
    JA, _, A, _ = operands(name)
    jcfg = jm.SpGEMMConfig(mode=mode, **cfg_kw)
    jd = JA.device(jcfg.vdtype, pad=True)
    with pytest.raises(JSpGEMMError):
        jm.spgemm(jd, jd, config=jcfg)
    cfg = SpGEMMConfig(mode=mode, **cfg_kw)
    td = A.device(cfg.vdtype, pad=True, device=CPU)
    with pytest.raises(SpGEMMError):
        tm.spgemm(td, td, config=cfg)


def test_masked_budget_raises_as_jax():
    A = port(jgen.banded(200, band=12, nnz_per_row=6, seed=1))
    budget = A.intprod(A) - 1
    _both_raise({"masked_max_products": budget})
    # at the budget it runs
    cfg = SpGEMMConfig(mode="masked", masked_max_products=budget + 1)
    dA = A.device(cfg.vdtype, pad=True, device=CPU)
    assert tm.spgemm(dA, dA, config=cfg).host().equals(
        oracle_spgemm(A, A), tol=1e-9)


@pytest.mark.parametrize("mode,limit", [
    ("masked", "t_prime"), ("masked", "intprod"), ("esc", "intprod")])
def test_int32_guards_raise_as_jax(mode, limit, monkeypatch):
    """The int32 limit made tiny in both packages: the masked pipeline's
    symbolic-stream and product-stream guards, and ESC's."""
    JA, _, A, _ = operands("banded")
    t_prime = int(np.asarray(jmask.mask_stage(
        *(jnp.asarray(x) for x in (JA.ptr, JA.col, JA.ptr, JA.col))
    ).totals)[1])
    intprod = A.intprod(A)
    assert t_prime < intprod
    cut = t_prime if limit == "t_prime" else intprod
    monkeypatch.setattr(jpl, "_INT32_MAX", cut)
    monkeypatch.setattr(tpl, "_INT32_MAX", cut)
    _both_raise({}, mode=mode)
    monkeypatch.setattr(jpl, "_INT32_MAX", cut + 1)
    monkeypatch.setattr(tpl, "_INT32_MAX", cut + 1)
    if limit == "t_prime":                 # the product guard still holds
        _both_raise({}, mode=mode)


def test_cli_esc_matches_jax(tmp_path, capsys):
    """``--mode esc`` through both CLIs: the check passes and nnz(C) and
    the product count agree."""
    import json

    from mh_spgemm_tpu.bench.driver import main as jax_main
    from mh_spgemm_torch.bench.driver import main as port_main
    from mh_spgemm_torch.io.mmio import write_mtx

    path = str(tmp_path / "band.mtx")
    write_mtx(path, port(jgen.banded(200, band=12, nnz_per_row=6, seed=1)))
    got = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        assert main([path, "--mode", "esc", "--check", "--json",
                     "--iters", "1", *extra]) == 0
        out = capsys.readouterr().out
        got.append(json.loads([ln for ln in out.splitlines()
                               if ln.startswith("{")][0]))
    assert [g["check"] for g in got] == ["pass", "pass"]
    assert (got[0]["nnz_C"], got[0]["intprod"]) == (got[1]["nnz_C"],
                                                    got[1]["intprod"])
