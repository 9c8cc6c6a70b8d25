"""Seeded synthetic matrices from the run's ``--seed``: the R-MAT
(Kronecker) generator of the Graph500 benchmark, which with equal
quadrant probabilities makes Erdos-Renyi matrices, and the canonical
COO-to-CSR step (rows, then columns ascending; duplicates summed).

It imports numpy only.  A matrix is a :class:`Matrix` of plain arrays;
the harness hands the same arrays to the program and to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Matrix:
    """Canonical CSR: ``ptr`` int32[M+1], ``col`` int32[nnz] ascending
    within each row, no duplicate coordinates, ``val`` float64[nnz]."""

    M: int
    N: int
    ptr: np.ndarray
    col: np.ndarray
    val: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.ptr[-1])


def from_coo(M: int, N: int, rows, cols, vals, dtype=np.float64) -> Matrix:
    """Sort by (row, col) and sum duplicate coordinates in the order they
    were drawn."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=dtype)
    # a stable sort on one key: the order of np.lexsort((cols, rows))
    order = np.argsort(rows * N + cols, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        keep = np.empty(rows.size, dtype=bool)
        keep[0] = True
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        seg = np.cumsum(keep) - 1
        summed = np.zeros(int(seg[-1]) + 1, dtype=dtype)
        np.add.at(summed, seg, vals)
        rows, cols, vals = rows[keep], cols[keep], summed
    ptr = np.zeros(M + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=M), out=ptr[1:])
    return Matrix(M=M, N=N, ptr=ptr, col=cols.astype(np.int32), val=vals)


def rmat(scale: int, edge_factor: int, a: float, b: float, c: float,
         permute: bool, symmetric: bool,
         rng: np.random.Generator) -> Matrix:
    """The R-MAT / Kronecker recursion of the Graph500 generator: 2**scale
    vertices, edge_factor * 2**scale directed edges, each descending
    ``scale`` levels into the quadrant (a, b; c, d = 1 - a - b - c) of
    its row and column bits.  ``permute`` relabels the vertices by a
    random permutation; ``symmetric`` adds every edge's reverse.  Values
    are standard normal, one an edge, and duplicate edges are summed.
    With a = b = c = d = 0.25 every edge is uniform: an Erdos-Renyi
    graph."""
    n, m = 1 << scale, edge_factor << scale
    ab, a_norm, c_norm = a + b, a / (a + b), c / (1.0 - a - b)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        row_bit = rng.random(m) > ab
        col_bit = rng.random(m) > np.where(row_bit, c_norm, a_norm)
        rows |= row_bit.astype(np.int64) << level
        cols |= col_bit.astype(np.int64) << level
    if permute:
        p = rng.permutation(n)
        rows, cols = p[rows], p[cols]
    vals = rng.standard_normal(m)
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        vals = np.concatenate([vals, vals])
    return from_coo(n, n, rows, cols, vals)


FAMILIES = {"rmat": rmat}


def make(generator: dict, seed: int) -> Matrix:
    """The configuration's matrix (``{"family", "params"}``) for the
    run's seed."""
    rng = np.random.default_rng([seed % 2**64, 0])
    return FAMILIES[generator["family"]](rng=rng, **generator["params"])


def revalued(A: Matrix, seed: int, k: int) -> Matrix:
    """A's structure with the ``k``-th set of standard normal values
    drawn from the run's seed (the warm mix's second operand)."""
    rng = np.random.default_rng([seed % 2**64, 1, k])
    return dataclasses.replace(A, val=rng.standard_normal(A.nnz))


def intprod(A: Matrix, B: Matrix) -> int:
    """Products of C = A @ B: the sum over A's entries of B's row
    lengths (a product costs two floating-point operations)."""
    blen = np.diff(B.ptr).astype(np.int64)
    return int(blen[A.col].sum())


def block_permuted(A: Matrix, bs: int, rng: np.random.Generator) -> Matrix:
    """P A P^T for a random permutation P of A's whole ``bs``-row blocks,
    applied to rows and columns alike; a last partial block stays last,
    so every block stays aligned.  C = A @ A then becomes P C P^T: the
    same products, nnz(C) and count of ``bs`` x ``bs`` block pairs."""
    n = A.M
    assert A.M == A.N, "a block permutation needs a square matrix"
    nfull = n // bs
    old_of_new = np.arange(n, dtype=np.int64)
    blocks = rng.permutation(nfull)
    old_of_new[: nfull * bs] = (blocks[:, None] * bs
                                + np.arange(bs)[None, :]).reshape(-1)
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[old_of_new] = np.arange(n)
    lens = np.diff(A.ptr).astype(np.int64)
    new_lens = lens[old_of_new]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_lens, out=ptr[1:])
    # the source entry of each new entry, row by row in the new order
    src = (np.repeat(A.ptr[old_of_new].astype(np.int64) - ptr[:-1],
                     new_lens) + np.arange(ptr[-1]))
    rows = np.repeat(np.arange(n, dtype=np.int64), new_lens)
    cols = new_of_old[A.col[src]]
    order = np.argsort(rows * n + cols, kind="stable")
    return Matrix(M=n, N=n, ptr=ptr.astype(np.int32),
                  col=cols[order].astype(np.int32), val=A.val[src][order])
