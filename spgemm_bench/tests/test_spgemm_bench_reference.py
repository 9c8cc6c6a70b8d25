"""The plain reference against scipy, the comparison, and the control:
the reference in float32 in the program's place must fail the limit that
the program's float64 output keeps."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spgemm_bench import check, gen, harness, reference
from mh_spgemm_torch import SpGEMMConfig
from mh_spgemm_torch.pipeline import spgemm_host, CSR

import spgemm_bench_fixtures as fx

CASES = fx.SHAPES + [("banded", None)]


def _matrix(generator, seed):
    if generator is None:
        return fx.banded(700, 30, 11, seed)
    return fx.matrix(generator, seed)


def _scipy(A):
    return sp.csr_matrix((A.val, A.col, A.ptr), shape=(A.M, A.N))


def _with_empty_rows(A):
    """A with every fifth row emptied."""
    keep = np.repeat(np.arange(A.M) % 5 != 0, np.diff(A.ptr))
    lens = np.diff(A.ptr) * (np.arange(A.M) % 5 != 0)
    ptr = np.zeros(A.M + 1, dtype=np.int32)
    np.cumsum(lens, out=ptr[1:])
    return gen.Matrix(A.M, A.N, ptr, A.col[keep], A.val[keep])


@pytest.mark.parametrize("name,generator", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("budget", [1 << 26, 1000])
def test_reference_equals_scipy(name, generator, budget):
    A = _with_empty_rows(_matrix(generator, 5))
    C = _scipy(A) @ _scipy(A)
    C.sort_indices()
    blocks = list(reference.product(A, A, "cpu", budget=budget))
    if budget == 1000:
        assert len(blocks) > 2
    counts = torch.cat([b.counts for b in blocks]).numpy()
    assert np.array_equal(counts, np.diff(C.indptr))
    assert np.array_equal(torch.cat([b.col for b in blocks]).numpy(),
                          C.indices)
    np.testing.assert_allclose(torch.cat([b.val for b in blocks]).numpy(),
                               C.data, rtol=1e-12, atol=1e-12)
    absC = abs(_scipy(A)) @ abs(_scipy(A))
    absC.sort_indices()
    np.testing.assert_allclose(torch.cat([b.scale for b in blocks]).numpy(),
                               absC.data, rtol=1e-12)
    full = reference.as_csr(A, A, "cpu")
    assert np.array_equal(full.ptr.numpy(), C.indptr)


def _program(A):
    return spgemm_host(CSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col, val=A.val),
                       None, SpGEMMConfig(mode="auto"), device="cpu")


def _limit():
    return min(harness.load_json(harness.ROOT, c["file"])["check"]["val_gap"]
               for c in fx.real_bench()["configs"])


def test_program_output_compares_clean():
    A = fx.matrix(fx.SHAPES[0][1], 2)
    r = check.compare(A, A, [_program(A)], "cpu")
    assert r["shape_wrong"] == r["rows_wrong"] == r["entries_wrong"] == 0
    assert r["val_gap"] < _limit()
    assert r["nnz_c"] == (_scipy(A) @ _scipy(A)).nnz


@pytest.mark.parametrize("name,generator", CASES, ids=[c[0] for c in CASES])
def test_control_fails_the_limit(name, generator):
    """The reference in float32 reads above every configuration's
    ``val_gap`` limit; the program's float64 output below it."""
    A = _matrix(generator, 8)
    ctl = reference.as_csr(A, A, "cpu", torch.float32)
    r_ctl = check.compare(A, A, [ctl], "cpu")
    r_prog = check.compare(A, A, [_program(A)], "cpu")
    assert r_ctl["rows_wrong"] == r_ctl["entries_wrong"] == 0
    assert r_ctl["val_gap"] > 100 * _limit()
    assert r_prog["val_gap"] < _limit() / 100


def _altered(C, **kw):
    return dataclasses.replace(C, **kw)


def test_comparison_catches_each_fault():
    A = fx.banded(500, 20, 9, seed=4)
    C = _program(A)
    val = C.val.copy()
    val[7] *= 1 + 1e-9
    col = C.col.copy()
    col[3] = (col[3] + 1) % A.N
    ptr = C.ptr.copy()
    ptr[200:] = ptr[200:] + 1
    half = C.ptr.copy()
    half[A.M // 2:] = half[A.M // 2]
    readings = check.compare(
        A, A, [_altered(C, val=val), _altered(C, col=col),
               _altered(C, ptr=ptr), _altered(C, ptr=half)], "cpu")
    assert readings["val_gap"] > 1e-12
    assert readings["entries_wrong"] >= 1
    assert readings["rows_wrong"] >= A.M // 2
    ok, rows = check.judge({**readings, "calls_failed": 0,
                            "outputs_missing": 0},
                           {"val_gap": _limit(),
                            **{k: 0 for k in check.EXACT}})
    assert not ok and len(rows) == 1 + len(check.EXACT)


def test_shape_faults_are_counted():
    A = fx.matrix(fx.SHAPES[2][1], 6)
    C = _program(A)
    short = _altered(C, col=C.col[:-1], val=C.val[:-1])
    r = check.compare(A, A, [short, _altered(C, M=C.M - 1,
                                            ptr=C.ptr[:-1])], "cpu")
    assert r["shape_wrong"] == 2
