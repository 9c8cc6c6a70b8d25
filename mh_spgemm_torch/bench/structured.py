"""Structured pathological-matrix catalog — the port's copy of
``mh_spgemm_tpu/bench/structured.py`` (``FAMILIES``, :func:`catalog`,
:func:`make_case`), built on the port's ``CSR.from_coo``.

A deterministic 400-case sweep over the structure families that make
SpGEMM implementations fail: dense-row spikes, empty row/column bands,
diagonal-plus-full-row, near-dense tiles, class-width-boundary row sizes,
extreme rectangles, cancellation patterns and degenerate shapes.  Every
case equals the JAX package's bit for bit (shapes, ``ptr``, ``col``,
``val``, and whether B is A).  ``python -m mh_spgemm_torch.bench.soak``
runs every case through every engine against the scipy oracle.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from ..csr import CSR


def _csr(m, n, rows, cols, vals=None, seed=0) -> CSR:
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if vals is None:
        vals = np.random.default_rng(seed).standard_normal(rows.size)
    return CSR.from_coo(m, n, rows, cols, np.asarray(vals, np.float64),
                        sum_duplicates=True)


def spike(i: int) -> CSR:
    """Banded matrix with a few FULL rows (dense-row fallback path)."""
    rng = np.random.default_rng(100 + i)
    n = 40 + 17 * i
    band = 2 + (i % 7)
    r = np.repeat(np.arange(n), 4)
    c = np.clip(r + rng.integers(-band, band + 1, r.size), 0, n - 1)
    dense_rows = rng.choice(n, size=1 + i % 3, replace=False)
    dr = np.repeat(dense_rows, n)
    dc = np.tile(np.arange(n), dense_rows.size)
    return _csr(n, n, np.concatenate([r, dr]), np.concatenate([c, dc]),
                seed=i)


def empty_bands(i: int) -> CSR:
    """Alternating bands of fully EMPTY rows and columns."""
    rng = np.random.default_rng(200 + i)
    n = 50 + 13 * i
    period = 2 + (i % 5)
    r = rng.integers(0, n, 6 * n)
    c = rng.integers(0, n, 6 * n)
    keep = ((r // period) % 2 == 0) & ((c // period) % 2 == 1)
    if not keep.any():
        keep[:1] = True
    return _csr(n, n, r[keep], c[keep], seed=i)


def diag_full_row(i: int) -> CSR:
    """Identity plus one full row and one full column."""
    n = 30 + 11 * i
    k = i % n
    r = np.concatenate([np.arange(n), np.full(n, k), np.arange(n)])
    c = np.concatenate([np.arange(n), np.arange(n), np.full(n, k)])
    return _csr(n, n, r, c, seed=i)


def dense_tiles(i: int) -> CSR:
    """Near-dense square tiles on the diagonal + sparse coupling."""
    rng = np.random.default_rng(300 + i)
    t = 8 + (i % 3) * 12                   # tile edge
    nt = 2 + i % 5
    n = t * nt
    rows, cols = [], []
    for b in range(nt):
        rr, cc = np.meshgrid(np.arange(t), np.arange(t))
        mask = rng.random((t, t)) < 0.8
        rows.append((b * t + rr[mask]).ravel())
        cols.append((b * t + cc[mask]).ravel())
    extra = rng.integers(0, n, 3 * n)
    rows.append(extra)
    cols.append(rng.integers(0, n, 3 * n))
    return _csr(n, n, np.concatenate(rows), np.concatenate(cols), seed=i)


def width_edge(i: int) -> CSR:
    """Rows whose intermediate-product counts sit EXACTLY on the bucket
    width-class boundaries (pow2, pow2 +- 1, 1.5*pow2)."""
    k = 3 + (i % 8)                        # B rows have 2^k-ish lengths
    base = 1 << k
    lens = [base - 1, base, base + 1, (3 * base) // 2,
            (3 * base) // 2 + 1, 2 * base]
    n = max(64, 2 * max(lens) + 8)
    rows, cols = [np.arange(n)], [np.arange(n)]       # diagonal
    for j, ln in enumerate(lens):
        rows.append(np.full(ln, j))
        cols.append((np.arange(ln) * (1 + i % 3)) % n)
    return _csr(n, n, np.concatenate(rows), np.concatenate(cols), seed=i)


def staircase(i: int) -> CSR:
    """Monotone consecutive column blocks (maximal run merging)."""
    n = 60 + 10 * i
    w = 3 + i % 9
    r = np.repeat(np.arange(n), w)
    c = (np.repeat(np.arange(n), w) + np.tile(np.arange(w), n)) % n
    return _csr(n, n, r, c, seed=i)


def comb(i: int) -> CSR:
    """Every p-th row/column populated only (stride patterns)."""
    n = 64 + 9 * i
    p = 2 + i % 4
    r = np.repeat(np.arange(0, n, p), 8)
    rng = np.random.default_rng(400 + i)
    c = (rng.integers(0, n // p, r.size) * p) % n
    return _csr(n, n, r, c, seed=i)


def rect_tall(i: int) -> Tuple[CSR, CSR]:
    """Tall-thin A times short-wide B."""
    rng = np.random.default_rng(500 + i)
    m, k, n = 300 + 20 * i, 8 + i % 17, 200 + 15 * i
    A = _csr(m, k, rng.integers(0, m, 4 * m), rng.integers(0, k, 4 * m),
             seed=i)
    B = _csr(k, n, rng.integers(0, k, 5 * k), rng.integers(0, n, 5 * k),
             seed=i + 1)
    return A, B


def cancel(i: int) -> Tuple[CSR, CSR]:
    """Products that cancel to EXPLICIT zeros (structure preserved)."""
    n = 20 + 7 * i
    r = np.concatenate([np.arange(n), np.arange(n)])
    c = np.concatenate([np.zeros(n, np.int64), np.ones(n, np.int64)])
    v = np.concatenate([np.ones(n), -np.ones(n)])
    A = _csr(n, n, r, c, v)
    rb = np.array([0, 1])
    cb = np.array([i % n, i % n])
    B = _csr(n, n, rb, cb, np.ones(2))
    return A, B


def degenerate(i: int) -> Tuple[CSR, CSR]:
    """Tiny and empty shapes: 1x1, 1xN, Nx1, empty rows everywhere."""
    kind = i % 5
    if kind == 0:
        A = _csr(1, 1, [0], [0], [2.0])
        return A, A
    if kind == 1:
        n = 5 + i
        A = _csr(1, n, np.zeros(n), np.arange(n))
        B = _csr(n, 1, np.arange(n), np.zeros(n))
        return A, B
    if kind == 2:
        n = 5 + i
        A = CSR.from_coo(n, n, np.zeros(0), np.zeros(0), np.zeros(0))
        return A, A
    if kind == 3:
        n = 5 + i
        A = _csr(n, n, [n - 1], [0], [1.0])      # single entry, last row
        return A, A
    n = 5 + i
    A = _csr(n, 3, np.arange(n), np.arange(n) % 3)
    B = _csr(3, n, np.arange(3), np.arange(3))
    return A, B


FAMILIES: Dict[str, Tuple[Callable, int]] = {
    "spike": (spike, 50),
    "empty_bands": (empty_bands, 50),
    "diag_full_row": (diag_full_row, 45),
    "dense_tiles": (dense_tiles, 45),
    "width_edge": (width_edge, 50),
    "staircase": (staircase, 45),
    "comb": (comb, 40),
    "rect_tall": (rect_tall, 30),
    "cancel": (cancel, 25),
    "degenerate": (degenerate, 20),
}


def catalog() -> List[Tuple[str, int]]:
    """The full deterministic 400-case list as (family, index) pairs."""
    out = []
    for name, (_, count) in FAMILIES.items():
        out.extend((name, i) for i in range(count))
    return out


def make_case(name: str, i: int):
    """Returns (A, B) for a catalog entry (B may equal A)."""
    got = FAMILIES[name][0](i)
    if isinstance(got, tuple):
        return got
    return got, got
