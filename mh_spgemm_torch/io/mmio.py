"""Matrix Market I/O (same behaviour as ``mh_spgemm_tpu.io.mmio``).

Coordinate format with fields ``real``/``integer``/``pattern``/
``complex`` (pattern entries get 1.0, complex keeps the real part);
symmetric, hermitian and skew-symmetric matrices are expanded;
indices become 0-based, columns are sorted within rows, and duplicate
coordinates are kept.  The native parser is used when the host library
is built, else numpy.
"""

from __future__ import annotations

import gzip
import os
from typing import Tuple

import numpy as np

from ..csr import CSR
from ..errors import MatrixFormatError, require
from ..utils import native


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_banner(path: str) -> Tuple[str, str, str]:
    """Return (format, field, symmetry) from the %%MatrixMarket banner."""
    with _open(path) as f:
        line = f.readline()
    parts = line.strip().split()
    require(len(parts) == 5 and parts[0].lower() == "%%matrixmarket",
            MatrixFormatError, f"bad MatrixMarket banner in {path}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:])
    require(obj == "matrix", MatrixFormatError, "only 'matrix' objects")
    return fmt, field, symmetry


def read_mtx(path: str, dtype=np.float64) -> CSR:
    """Read a .mtx (optionally .mtx.gz) file into a CSR matrix."""
    fmt, field, symmetry = read_banner(path)
    require(fmt == "coordinate", MatrixFormatError,
            "only coordinate-format .mtx files are supported")
    is_pattern = field == "pattern"
    is_complex = field == "complex"
    symmetric = symmetry in ("symmetric", "hermitian")
    skew = symmetry == "skew-symmetric"

    data = None
    if not path.endswith(".gz"):
        data = native.parse_mtx_body(path, is_pattern, is_complex)
    if data is None:
        data = _numpy_parse(path, is_pattern, is_complex)
    M, N, rows, cols, vals = data
    vals = vals.astype(dtype, copy=False)

    if symmetric or skew:
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, -vals[off] if skew else vals[off]]))
    return CSR.from_coo(M, N, rows, cols, vals, is_symmetric=symmetric,
                        dtype=dtype)


def _numpy_parse(path, is_pattern, is_complex):
    with _open(path) as f:
        header = None
        for line in f:
            s = line.strip()
            if not s or s.startswith("%"):
                continue
            header = s
            break
        require(header is not None, MatrixFormatError, "missing size line")
        parts = header.split()
        require(len(parts) == 3, MatrixFormatError, "bad size line")
        M, N, nnz = int(parts[0]), int(parts[1]), int(parts[2])
        raw = np.loadtxt(f, dtype=np.float64, max_rows=nnz, ndmin=2)
    if nnz == 0:
        raw = np.zeros((0, 2 if is_pattern else 3))
    require(raw.shape[0] == nnz, MatrixFormatError,
            f"expected {nnz} entries, got {raw.shape[0]}")
    rows = raw[:, 0].astype(np.int64) - 1
    cols = raw[:, 1].astype(np.int64) - 1
    if is_pattern:
        vals = np.ones(nnz, dtype=np.float64)
    else:
        vals = raw[:, 2].astype(np.float64)  # complex: real part only
    return M, N, rows, cols, vals


def write_mtx(path: str, A: CSR) -> None:
    """Write a CSR matrix as coordinate real general .mtx."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{A.M} {A.N} {A.nnz}\n")
        rows = np.repeat(np.arange(A.M), np.diff(A.ptr))
        np.savetxt(f, np.column_stack(
            [rows + 1, np.asarray(A.col) + 1, np.asarray(A.val)]),
            fmt="%d %d %.17g")


def extract_matrix_name(path: str) -> str:
    """Basename without the .mtx / .mtx.gz extension."""
    base = os.path.basename(path)
    for ext in (".mtx.gz", ".mtx"):
        if base.endswith(ext):
            return base[: -len(ext)]
    return os.path.splitext(base)[0]
