"""The generator (R-MAT, of which ER is the uniform case), the warm mix's
second operand, and the cold mix's block permutation."""

import numpy as np
import pytest
import scipy.sparse as sp

from spgemm_bench import gen, harness

import spgemm_bench_fixtures as fx


def _same(A, B):
    return (A.M == B.M and A.N == B.N and np.array_equal(A.ptr, B.ptr)
            and np.array_equal(A.col, B.col)
            and np.array_equal(A.val, B.val) and A.val.dtype == B.val.dtype)


def _scipy(A):
    return sp.csr_matrix((A.val, A.col, A.ptr), shape=(A.M, A.N))


def test_configuration_states_its_matrix():
    """Each configuration's sizes are those its generator makes, checked
    at a tiny scale of the same generator (the full size is made on the
    card only)."""
    for c in fx.real_bench()["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        p = cfg["generator"]["params"]
        assert cfg["rows"] == cfg["cols"] == 2 ** p["scale"]
        assert cfg["edges"] == p["edge_factor"] * 2 ** p["scale"]
        assert cfg["scale"] == p["scale"]
        assert cfg["edge_factor"] == p["edge_factor"]
        small = dict(cfg["generator"], params={**p, "scale": 8})
        A = gen.make(small, 3)
        assert A.M == A.N == 256
        assert 0.97 * 256 * p["edge_factor"] <= A.nnz \
            <= 256 * p["edge_factor"]


@pytest.mark.parametrize("name,generator", fx.SHAPES,
                         ids=[n for n, _ in fx.SHAPES])
def test_matrix_is_canonical_and_follows_the_seed(name, generator):
    A = gen.make(generator, 2**31 + 5)
    assert _same(A, gen.make(generator, 2**31 + 5))
    assert not np.array_equal(A.col, gen.make(generator, 2**31 + 6).col)
    rows = np.repeat(np.arange(A.M, dtype=np.int64), np.diff(A.ptr))
    keys = rows * A.N + A.col
    assert np.all(np.diff(keys) > 0) and A.ptr[0] == 0
    assert A.col.dtype == A.ptr.dtype == np.int32


def test_er_is_uniform_and_g500_is_skewed():
    er = gen.make(fx.SHAPES[0][1], 1)
    lens = np.diff(er.ptr)
    assert abs(lens.mean() - 7) < 0.1 and lens.max() < 25
    cols = np.bincount(er.col, minlength=er.N)
    assert cols.max() < 25
    g = gen.make(fx.SHAPES[1][1], 1)
    glens = np.diff(g.ptr)
    assert glens.max() > 10 * glens.mean()
    S = _scipy(g)
    S.data[:] = 1
    assert (S != S.T).nnz == 0          # every edge with its reverse


def test_second_operand_keeps_the_structure():
    A = gen.make(fx.SHAPES[0][1], 4)
    B = gen.revalued(A, 4, 1)
    assert np.array_equal(A.ptr, B.ptr) and np.array_equal(A.col, B.col)
    assert not np.any(A.val == B.val)
    assert _same(B, gen.revalued(A, 4, 1))
    assert not np.array_equal(B.val, gen.revalued(A, 5, 1).val)


def _block_pairs(A, bs=128):
    """Block pairs (A block (I, K) with A block (K, J)) of C = A @ A."""
    nb = -(-A.M // bs)
    rows = np.repeat(np.arange(A.M) // bs, np.diff(A.ptr))
    P = sp.csr_matrix((np.ones(rows.size), (rows, A.col // bs)),
                      shape=(nb, nb))
    P.data[:] = 1
    return int((P @ P).sum())


CASES = [("er_partial_block", fx.SHAPES[0][1], 1000),
         ("g500", fx.SHAPES[1][1], None),
         ("banded", None, 1024)]


def _case(generator, n, seed=3):
    if generator is None:
        return fx.banded(n, 150, 20, seed)
    A = gen.make(generator, seed)
    if n is not None and n < A.M:      # a last partial block
        keep = A.ptr[n]
        sub = A.col[:keep] < n
        rows = np.repeat(np.arange(n), np.diff(A.ptr[:n + 1]))
        A = gen.from_coo(n, n, rows[sub], A.col[:keep][sub],
                         A.val[:keep][sub])
    return A


@pytest.mark.parametrize("name,generator,n", CASES,
                         ids=[c[0] for c in CASES])
def test_block_permutation_keeps_the_work(name, generator, n):
    """P A P^T keeps intprod, nnz(C) and the 128 x 128 block pairs of
    C = A @ A, and its C is P C P^T."""
    A = _case(generator, n)
    P = gen.block_permuted(A, 128, np.random.default_rng([4, 2, 0]))
    assert not np.array_equal(P.col, A.col)
    assert gen.intprod(P, P) == gen.intprod(A, A)
    Ca, Cp = _scipy(A) @ _scipy(A), _scipy(P) @ _scipy(P)
    assert Ca.nnz == Cp.nnz
    assert _block_pairs(P) == _block_pairs(A)
    rows = np.repeat(np.arange(P.M), np.diff(P.ptr))
    # recover the relabelling from a permuted identity
    I = gen.Matrix(A.M, A.N, np.arange(A.M + 1, dtype=np.int32),
                   np.arange(A.M, dtype=np.int32),
                   np.arange(A.M, dtype=np.float64))
    PI = gen.block_permuted(I, 128, np.random.default_rng([4, 2, 0]))
    old = PI.val.astype(np.int64)
    np.testing.assert_allclose(Cp.toarray(), Ca.toarray()[np.ix_(old, old)],
                               rtol=1e-12, atol=1e-12)
    assert np.all(np.diff(P.col.astype(np.int64) + rows * P.N) > 0)


def test_permutations_follow_the_seed():
    A = gen.make(fx.SHAPES[0][1], 1)
    draw = lambda *t: gen.block_permuted(A, 128, np.random.default_rng(t))
    assert _same(draw(7, 2, 3), draw(7, 2, 3))
    assert not _same(draw(7, 2, 3), draw(7, 2, 4))
    assert not _same(draw(7, 2, 3), draw(8, 2, 3))
