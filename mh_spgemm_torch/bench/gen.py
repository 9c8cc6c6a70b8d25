"""Deterministic synthetic matrix generators (the same numpy draws as
``mh_spgemm_tpu.bench.gen``, so a seed gives a bit-identical matrix in
both packages).

* ``banded``      FEM/stencil-like: columns clustered near the diagonal.
* ``random``      uniform scatter (cage-like).
* ``powerlaw``    web/circuit graphs: Zipf row lengths, hub columns.
* ``kron``        RMAT/Kronecker graphs.
* ``diag_blocks`` dense diagonal blocks.

All return canonical CSR (sorted, duplicates summed).
"""

from __future__ import annotations

import numpy as np

from ..csr import CSR


def banded(n: int, band: int = 16, nnz_per_row: int = 12,
           seed: int = 0, dtype=np.float64) -> CSR:
    """Random entries clustered within +-band of the diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    off = rng.integers(-band, band + 1, size=rows.size)
    cols = np.clip(rows + off, 0, n - 1)
    vals = rng.standard_normal(rows.size)
    return CSR.from_coo(n, n, rows, cols, vals, sum_duplicates=True,
                        dtype=dtype)


def random_uniform(n: int, nnz_per_row: int = 8, seed: int = 0,
                   dtype=np.float64) -> CSR:
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n, size=rows.size)
    vals = rng.standard_normal(rows.size)
    return CSR.from_coo(n, n, rows, cols, vals, sum_duplicates=True,
                        dtype=dtype)


def powerlaw(n: int, avg_nnz: int = 8, alpha: float = 1.8,
             max_row: int | None = None, seed: int = 0,
             dtype=np.float64) -> CSR:
    """Zipf row lengths, preferential-attachment-ish columns."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=n).astype(np.int64)
    max_row = max_row or max(64, n // 64)
    lens = np.minimum(raw * avg_nnz // max(1, int(raw.mean())), max_row)
    lens = np.maximum(lens, 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = (n * rng.power(3.0, size=rows.size)).astype(np.int64) % n
    vals = rng.standard_normal(rows.size)
    return CSR.from_coo(n, n, rows, cols, vals, sum_duplicates=True,
                        dtype=dtype)


def kron(scale: int = 12, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         dtype=np.float64) -> CSR:
    """RMAT/Kronecker generator (Graph500-style)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(m)
        bit_r = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(bit_r == 0, a / (a + b), c / (1 - a - b))
        bit_c = (r2 >= thr).astype(np.int64)
        rows |= bit_r << lvl
        cols |= bit_c << lvl
    vals = rng.standard_normal(m)
    return CSR.from_coo(n, n, rows, cols, vals, sum_duplicates=True,
                        dtype=dtype)


def diag_blocks(n: int, block: int = 8, seed: int = 0,
                dtype=np.float64) -> CSR:
    """Dense diagonal blocks (FEM supernode pattern)."""
    rng = np.random.default_rng(seed)
    nb = n // block
    base = np.arange(nb, dtype=np.int64) * block
    r = (base[:, None, None] +
         np.arange(block)[None, :, None]).repeat(block, axis=2)
    c = (base[:, None, None] +
         np.arange(block)[None, None, :]).repeat(block, axis=1)
    rows, cols = r.reshape(-1), c.reshape(-1)
    vals = rng.standard_normal(rows.size)
    return CSR.from_coo(n, n, rows, cols, vals, sum_duplicates=True,
                        dtype=dtype)


def tiny_fixture() -> CSR:
    """Small handwritten matrix with empty rows, duplicate-tile columns
    and a dense-ish row."""
    rows = [0, 0, 0, 1, 2, 2, 3, 3, 3, 3, 5, 5, 5, 5, 5, 5, 5, 5,
            33, 33, 34, 35, 35]
    cols = [0, 3, 33, 1, 2, 34, 0, 1, 2, 3, 0, 5, 10, 15, 20, 25, 30, 35,
            2, 33, 34, 0, 35]
    vals = [1.0, 2.0, -1.5, 3.0, 0.5, 1.0, 1.0, -2.0, 4.0, 0.25,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
            2.0, -1.0, 0.5, 3.0, 1.5]
    return CSR.from_coo(36, 36, rows, cols, vals)


FAMILIES = {
    "banded": banded,
    "random": random_uniform,
    "powerlaw": powerlaw,
    "kron": kron,
    "diag_blocks": diag_blocks,
}
