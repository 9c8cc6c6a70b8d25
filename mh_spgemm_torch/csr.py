"""CSR matrix containers of the PyTorch port.

:class:`CSR` is the host matrix (numpy arrays), with the same
construction, transpose, comparison and upload (:meth:`CSR.device`) as
``mh_spgemm_tpu.csr.CSR``; :class:`DeviceCSR` holds torch tensors on an
explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .errors import MatrixFormatError, ShapeMismatchError, require
from .timing import span


@dataclasses.dataclass
class CSR:
    """Host-resident CSR matrix: ``ptr`` int32[M+1], ``col`` int32[nnz],
    ``val`` value_dtype[nnz], columns ascending within each row."""

    M: int
    N: int
    ptr: np.ndarray
    col: np.ndarray
    val: np.ndarray
    is_symmetric: bool = False

    @property
    def nnz(self) -> int:
        return int(self.ptr[-1])

    # -- construction ------------------------------------------------------

    @classmethod
    def from_coo(cls, M: int, N: int, rows, cols, vals,
                 is_symmetric: bool = False, sum_duplicates: bool = False,
                 dtype=np.float64) -> "CSR":
        """Build CSR from coordinate triples; sorts columns within rows.
        Duplicate coordinates are kept unless ``sum_duplicates``."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=dtype)
        require(rows.shape == cols.shape == vals.shape, MatrixFormatError,
                "COO arrays must have equal length")
        if rows.size:
            require(int(rows.min()) >= 0 and int(rows.max()) < M,
                    MatrixFormatError, "row index out of range")
            require(int(cols.min()) >= 0 and int(cols.max()) < N,
                    MatrixFormatError, "col index out of range")
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            keep = np.empty(rows.size, dtype=bool)
            keep[0] = True
            keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            seg = np.cumsum(keep) - 1
            new_vals = np.zeros(int(seg[-1]) + 1, dtype=dtype)
            np.add.at(new_vals, seg, vals)
            rows, cols, vals = rows[keep], cols[keep], new_vals
        ptr = np.zeros(M + 1, dtype=np.int32)
        np.add.at(ptr, rows + 1, 1)
        np.cumsum(ptr, out=ptr)
        return cls(M=M, N=N, ptr=ptr.astype(np.int32),
                   col=cols.astype(np.int32), val=vals,
                   is_symmetric=is_symmetric)

    @classmethod
    def from_arrays(cls, M: int, N: int, ptr, col, val,
                    is_symmetric: bool = False) -> "CSR":
        """Wrap existing CSR arrays (for example a JAX-package ``CSR``'s
        ``.ptr/.col/.val``) as a port CSR; the arrays are copied."""
        ptr = np.array(ptr, dtype=np.int32)
        col = np.array(col, dtype=np.int32)
        val = np.array(val)
        out = cls(M=int(M), N=int(N), ptr=ptr, col=col, val=val,
                  is_symmetric=is_symmetric)
        out.validate()
        require(col.size == out.nnz and val.size == out.nnz,
                MatrixFormatError, "col/val length must equal ptr[-1]")
        return out

    @classmethod
    def from_scipy(cls, mat, is_symmetric: bool = False) -> "CSR":
        m = mat.tocsr()
        m.sort_indices()
        return cls(M=m.shape[0], N=m.shape[1],
                   ptr=m.indptr.astype(np.int32),
                   col=m.indices.astype(np.int32),
                   val=np.asarray(m.data),
                   is_symmetric=is_symmetric)

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.val, self.col, self.ptr),
                             shape=(self.M, self.N))

    # -- transforms --------------------------------------------------------

    def transpose(self) -> "CSR":
        """B = A^T by a stable counting sort on columns (rows stay
        ascending within each column)."""
        nnz = self.nnz
        tptr = np.zeros(self.N + 1, dtype=np.int32)
        np.add.at(tptr, self.col + 1, 1)
        np.cumsum(tptr, out=tptr)
        tcol = np.empty(nnz, dtype=np.int32)
        tval = np.empty(nnz, dtype=self.val.dtype)
        rows = np.repeat(np.arange(self.M, dtype=np.int32),
                         np.diff(self.ptr))
        dest = tptr[self.col] + _rank_within_group(self.col)
        tcol[dest] = rows
        tval[dest] = self.val
        return CSR(M=self.N, N=self.M, ptr=tptr, col=tcol, val=tval,
                   is_symmetric=self.is_symmetric)

    def copy(self) -> "CSR":
        return CSR(M=self.M, N=self.N, ptr=self.ptr.copy(),
                   col=self.col.copy(), val=self.val.copy(),
                   is_symmetric=self.is_symmetric)

    def device(self, value_dtype: Optional[torch.dtype] = None,
               pad: bool = False, device=None) -> "DeviceCSR":
        """Upload to ``device`` (the card when None; raises without CUDA,
        ``pipeline.resolve_device``) as a :class:`DeviceCSR`, values in
        ``value_dtype`` (a torch dtype; default the host values' type).

        ``pad=True`` quantizes the extents to the grid of
        ``ops/shapes.quantize``: padded rows are empty (``ptr`` repeats
        its last value) and padded nonzeros reference column 0 but lie
        past ``ptr[M]``, so no per-row reduction sees them."""
        from .ops.shapes import pad1, quantize
        from .pipeline import resolve_device

        dev = resolve_device(device)
        ptr, col, val = self.ptr, self.col, self.val
        if pad:
            m_pad = quantize(self.M)
            nnz_pad = quantize(max(1, self.nnz))
            ptr = pad1(ptr, m_pad + 1, fill=ptr[-1])
            col = pad1(col, nnz_pad, fill=0)
            val = pad1(val, nnz_pad, fill=0)
        val = torch.from_numpy(np.ascontiguousarray(val)).to(dev)
        return DeviceCSR(
            M=self.M, N=self.N,
            ptr=torch.from_numpy(np.ascontiguousarray(
                ptr, dtype=np.int32)).to(dev),
            col=torch.from_numpy(np.ascontiguousarray(
                col, dtype=np.int32)).to(dev),
            val=val.to(value_dtype) if value_dtype is not None else val,
            nnz_true=self.nnz)

    # -- analysis ----------------------------------------------------------

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.ptr)

    def intprod(self, B: "CSR") -> int:
        """Intermediate-product count Sigma_i nnz(B[A.col[i]]); a SpGEMM
        does 2 * intprod floating-point operations."""
        require(self.N == B.M, ShapeMismatchError, "A.N must equal B.M")
        bl = np.diff(B.ptr).astype(np.int64)
        return int(bl[self.col].sum())

    def validate(self) -> None:
        require(self.ptr.shape == (self.M + 1,), MatrixFormatError,
                "ptr length must be M+1")
        require(int(self.ptr[0]) == 0, MatrixFormatError, "ptr[0] must be 0")
        require(bool(np.all(np.diff(self.ptr) >= 0)), MatrixFormatError,
                "ptr must be nondecreasing")
        if self.nnz:
            require(int(self.col.min()) >= 0 and int(self.col.max()) < self.N,
                    MatrixFormatError, "column index out of range")

    # -- comparison --------------------------------------------------------

    def equals(self, other: "CSR", tol: float = 1e-9,
               max_report: int = 10, verbose: bool = False) -> bool:
        """Exact nnz / ptr / col match; values within ``tol`` absolute OR
        relative."""
        if self.M != other.M or self.N != other.N:
            return False
        if self.nnz != other.nnz:
            if verbose:
                print(f"nnz mismatch: {self.nnz} vs {other.nnz}")
            return False
        if not np.array_equal(self.ptr, other.ptr):
            return False
        if not np.array_equal(self.col, other.col):
            return False
        a = np.asarray(self.val, dtype=np.float64)
        b = np.asarray(other.val, dtype=np.float64)
        diff = np.abs(a - b)
        ok = (a == b) | (diff < tol) | (diff < tol * np.abs(a))
        if not bool(ok.all()):
            if verbose:
                bad = np.flatnonzero(~ok)[:max_report]
                for j in bad:
                    print(f"value mismatch at {j}: {a[j]} vs {b[j]}")
            return False
        return True

    def __eq__(self, other):  # noqa: D105
        if not isinstance(other, CSR):
            return NotImplemented
        return self.equals(other)

    def __hash__(self):
        return id(self)


def _rank_within_group(keys: np.ndarray) -> np.ndarray:
    """For each element, its 0-based rank among equal keys appearing
    earlier (keys unsorted)."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    is_new = np.ones(keys.size, dtype=np.int64)
    if keys.size:
        is_new[1:] = (sorted_keys[1:] != sorted_keys[:-1]).astype(np.int64)
    grp_start = np.maximum.accumulate(
        np.where(is_new, np.arange(keys.size), 0))
    rank_sorted = np.arange(keys.size) - grp_start
    rank = np.empty(keys.size, dtype=np.int64)
    rank[order] = rank_sorted
    return rank


@dataclasses.dataclass
class DeviceCSR:
    """Device-resident CSR of torch tensors.  ``ptr`` may extend past
    ``M + 1`` and ``col``/``val`` past ``nnz_true`` (capacity padding);
    :meth:`host` trims to the logical sizes."""

    M: int
    N: int
    ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    nnz_true: Optional[int] = None

    @property
    def nnz(self) -> int:
        if self.nnz_true is not None:
            return self.nnz_true
        return int(self.col.shape[0])

    @property
    def m_pad(self) -> int:
        """Padded row count: the extent of ``ptr`` minus one."""
        return int(self.ptr.shape[0]) - 1

    @property
    def nnz_pad(self) -> int:
        """Padded nonzero count: the extent of ``col`` / ``val``."""
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.val.device

    def host(self) -> CSR:
        """The trimmed CSR on the host (the ``readback`` span)."""
        with span("readback"):
            nnz = self.nnz
            return CSR(M=self.M, N=self.N,
                       ptr=self.ptr[: self.M + 1].cpu().numpy(),
                       col=self.col[:nnz].cpu().numpy(),
                       val=self.val[:nnz].cpu().numpy())
