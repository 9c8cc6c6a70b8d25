"""CPU oracle and result verification.

The oracle is scipy's CSR SpGEMM in float64.  Digests let a large result
be checked without moving it off the card: exact-structure hash sums
plus a sign-weighted value sum, computed in numpy for the oracle and in
torch on the result's device.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from .csr import CSR, DeviceCSR
from .errors import VerificationError


def oracle_spgemm(A: CSR, B: CSR) -> CSR:
    """Exact C = A @ B in float64 on the host CPU.

    Every structurally touched column is kept, including entries whose
    value cancels to exactly 0.0; scipy's product prunes those, so the
    structure comes from a pattern product and the values are aligned
    onto it."""
    import scipy.sparse as sp
    a = sp.csr_matrix((A.val.astype(np.float64), A.col, A.ptr),
                      shape=(A.M, A.N))
    b = sp.csr_matrix((B.val.astype(np.float64), B.col, B.ptr),
                      shape=(B.M, B.N))
    c = a @ b
    c.sort_indices()
    pa = sp.csr_matrix((np.ones(A.nnz), A.col, A.ptr), shape=(A.M, A.N))
    pb = sp.csr_matrix((np.ones(B.nnz), B.col, B.ptr), shape=(B.M, B.N))
    s = pa @ pb
    s.sort_indices()

    if s.nnz == c.nnz:
        return CSR(M=c.shape[0], N=c.shape[1],
                   ptr=c.indptr.astype(np.int32),
                   col=c.indices.astype(np.int32), val=c.data)

    n = c.shape[1]
    rows_s = np.repeat(np.arange(s.shape[0], dtype=np.int64),
                       np.diff(s.indptr))
    rows_c = np.repeat(np.arange(c.shape[0], dtype=np.int64),
                       np.diff(c.indptr))
    keys_s = rows_s * n + s.indices
    keys_c = rows_c * n + c.indices
    vals = np.zeros(s.nnz, dtype=np.float64)
    if c.nnz:
        idx = np.minimum(np.searchsorted(keys_c, keys_s), c.nnz - 1)
        hit = keys_c[idx] == keys_s
        vals[hit] = c.data[idx[hit]]
    return CSR(M=s.shape[0], N=s.shape[1], ptr=s.indptr.astype(np.int32),
               col=s.indices.astype(np.int32), val=vals)


def timed_oracle_spgemm(A: CSR, B: CSR) -> Tuple[CSR, float]:
    """Oracle result + wall ms of the plain scipy value product."""
    import scipy.sparse as sp
    a = sp.csr_matrix((A.val.astype(np.float64), A.col, A.ptr),
                      shape=(A.M, A.N))
    b = sp.csr_matrix((B.val.astype(np.float64), B.col, B.ptr),
                      shape=(B.M, B.N))
    t0 = time.perf_counter()
    c = a @ b
    c.sort_indices()
    ms = (time.perf_counter() - t0) * 1e3
    del c
    return oracle_spgemm(A, B), ms


_DIG_MULT = 0x9E3779B1


def _dig_weights_np(n: int) -> tuple:
    i = np.arange(n, dtype=np.int64)
    h = (i * np.int64(_DIG_MULT)) ^ (i >> 7)
    w = (h & np.int64(0xFFFFF)) + np.int64(1)
    s = 1.0 - 2.0 * ((h >> 9) & np.int64(1)).astype(np.float64)
    return w, s


def digest_host(C: CSR) -> dict:
    """Verification digest of a host CSR."""
    with np.errstate(over="ignore"):
        wp, _ = _dig_weights_np(C.ptr.shape[0])
        wc, s = _dig_weights_np(C.nnz)
        v = C.val.astype(np.float64)
        return {
            "nnz": int(C.nnz),
            "hptr": int((C.ptr.astype(np.int64) * wp).sum()),
            "hcol": int((C.col.astype(np.int64) * wc).sum()),
            "wsum": float((s * v).sum()),
            "abs_sum": float(np.abs(v).sum()),
        }


def digest_device(C: DeviceCSR) -> dict:
    """Digest of a DeviceCSR computed on its device (int64 sums wrap
    like numpy's); fetches four scalars instead of the result."""
    n = C.nnz
    dev = C.val.device

    def wsign(k):
        i = torch.arange(k, dtype=torch.int64, device=dev)
        h = (i * _DIG_MULT) ^ (i >> 7)
        w = (h & 0xFFFFF) + 1
        s = 1.0 - 2.0 * ((h >> 9) & 1).to(torch.float64)
        return w, s

    ptr = C.ptr[: C.M + 1].to(torch.int64)
    col = C.col[:n].to(torch.int64)
    v = C.val[:n].to(torch.float64)
    wp, _ = wsign(ptr.shape[0])
    wc, s = wsign(n)
    sums = torch.stack([(ptr * wp).sum(), (col * wc).sum()]).cpu()
    vals = torch.stack([(s * v).sum(), v.abs().sum()]).cpu()
    return {"nnz": n, "hptr": int(sums[0]), "hcol": int(sums[1]),
            "wsum": float(vals[0]), "abs_sum": float(vals[1])}


def digest_check(d_engine: dict, d_oracle: dict,
                 tol: float = 1e-9) -> tuple:
    """Structure must match exactly; the weighted value sum within
    ``tol * (nnz + abs_sum)`` plus a small slack for summation order.
    Returns (ok, reason)."""
    for k in ("nnz", "hptr", "hcol"):
        if d_engine[k] != d_oracle[k]:
            return False, (f"structure mismatch: {k} {d_engine[k]} != "
                           f"{d_oracle[k]}")
    bound = (tol * (d_oracle["nnz"] + d_oracle["abs_sum"])
             + 1e-12 * d_oracle["abs_sum"])
    diff = abs(d_engine["wsum"] - d_oracle["wsum"])
    if diff > bound:
        return False, f"value checksum off by {diff:.3e} (bound {bound:.3e})"
    return True, "pass"


def verify(C: CSR, C_ref: CSR, tol: float = 1e-9, verbose: bool = True,
           raise_on_fail: bool = True) -> bool:
    """Exact nnz/ptr/col, values within ``tol`` abs-or-rel."""
    ok = C.equals(C_ref, tol=tol, verbose=verbose)
    if not ok and raise_on_fail:
        raise VerificationError(
            f"result mismatch: nnz {C.nnz} vs {C_ref.nnz}")
    return ok
