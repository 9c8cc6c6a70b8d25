"""The plain reference: C = A @ B in plain PyTorch, computed again from
the benchmark's own arrays, in blocks of rows so that the largest
product stream fits on the card.

Each block expands its products (row, column, a * b), sorts them by
(row, column) and sums equal keys.  Beside each value it sums the
products' magnitudes, |A| @ |B| at that entry, the scale by which the
comparison measures a value's error.  ``dtype`` is the precision of the
products and the sums: float64 for the reference, float32 for the
lower-precision control.  It imports torch and numpy only: nothing of the
program, and takes nothing that the program has made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# products expanded at once: about 64 bytes each on the card
BLOCK_PRODUCTS = 1 << 26


@dataclasses.dataclass
class Operand:
    """A matrix's arrays on the reference's device, with its row
    pointer on the host to plan blocks without a sync."""

    M: int
    N: int
    ptr_host: np.ndarray
    ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor


def upload(A, device) -> Operand:
    """``A`` (``gen.Matrix``) on ``device``: int64 indices, float64
    values."""
    return Operand(
        M=A.M, N=A.N, ptr_host=A.ptr.astype(np.int64),
        ptr=torch.from_numpy(A.ptr.astype(np.int64)).to(device),
        col=torch.from_numpy(A.col.astype(np.int64)).to(device),
        val=torch.from_numpy(np.asarray(A.val, np.float64)).to(device))


def row_products(A, B) -> np.ndarray:
    """Products of each row of C = A @ B (int64[M], on the host)."""
    blen = np.diff(B.ptr).astype(np.int64)
    per_ent = blen[A.col]
    cs = np.zeros(A.nnz + 1, dtype=np.int64)
    np.cumsum(per_ent, out=cs[1:])
    return cs[A.ptr[1:]] - cs[A.ptr[:-1]]


def row_blocks(A, B, budget: int = BLOCK_PRODUCTS) -> list:
    """Row ranges [r0, r1) of at most ``budget`` products each (a single
    row over the budget is a range of its own)."""
    per_row = row_products(A, B)
    cum = np.zeros(A.M + 1, dtype=np.int64)
    np.cumsum(per_row, out=cum[1:])
    out, r0 = [], 0
    while r0 < A.M:
        r1 = int(np.searchsorted(cum, cum[r0] + budget, side="right")) - 1
        r1 = min(max(r1, r0 + 1), A.M)
        out.append((r0, r1, int(cum[r1] - cum[r0])))
        r0 = r1
    return out


@dataclasses.dataclass
class Block:
    """Rows [r0, r1) of C: entries per row, columns ascending within each
    row, values and |A| @ |B| at each entry."""

    r0: int
    r1: int
    counts: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    scale: torch.Tensor


def product_block(a: Operand, b: Operand, r0: int, r1: int, nprod: int,
                  dtype=torch.float64) -> Block:
    """Rows [r0, r1) of C = A @ B, with ``nprod`` products."""
    dev = a.ptr.device
    nrows = r1 - r0
    e0, e1 = int(a.ptr_host[r0]), int(a.ptr_host[r1])
    if nprod == 0:
        z = torch.zeros(0, dtype=dtype, device=dev)
        return Block(r0, r1, torch.zeros(nrows, dtype=torch.int64,
                                         device=dev),
                     torch.zeros(0, dtype=torch.int64, device=dev), z, z)
    k = a.col[e0:e1]
    bstart = b.ptr[k]
    blen = b.ptr[k + 1] - bstart
    ent = torch.repeat_interleave(
        torch.arange(e1 - e0, device=dev), blen, output_size=nprod)
    first = torch.cumsum(blen, 0) - blen
    bidx = bstart[ent] + torch.arange(nprod, device=dev) - first[ent]
    arow = torch.repeat_interleave(
        torch.arange(nrows, device=dev), torch.diff(a.ptr[r0:r1 + 1]),
        output_size=e1 - e0)
    key = arow[ent] * b.N + b.col[bidx]
    prod = a.val[e0:e1].to(dtype)[ent] * b.val.to(dtype)[bidx]
    del bidx, first, bstart, blen
    skey, order = torch.sort(key)
    del key
    prod = prod[order]
    del order
    new = torch.ones(nprod, dtype=torch.bool, device=dev)
    new[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(new, 0) - 1
    ukey = skey[new]
    del skey, new
    val = torch.zeros(ukey.numel(), dtype=dtype, device=dev)
    val.index_add_(0, seg, prod)
    scale = torch.zeros(ukey.numel(), dtype=dtype, device=dev)
    scale.index_add_(0, seg, prod.abs())
    row = torch.div(ukey, b.N, rounding_mode="floor")
    return Block(r0, r1, torch.bincount(row, minlength=nrows),
                 ukey - row * b.N, val, scale)


def product(A, B, device, dtype=torch.float64,
            budget: int = BLOCK_PRODUCTS):
    """C = A @ B block by block: yields :class:`Block` in row order."""
    a = upload(A, device)
    b = a if B is A else upload(B, device)
    for r0, r1, nprod in row_blocks(A, B, budget):
        yield product_block(a, b, r0, r1, nprod, dtype)


@dataclasses.dataclass
class Csr:
    """C as whole arrays on the reference's device."""

    M: int
    N: int
    ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor


def as_csr(A, B, device, dtype=torch.float64) -> Csr:
    """C = A @ B gathered into one CSR, values in ``dtype``."""
    counts, cols, vals = [], [], []
    for blk in product(A, B, device, dtype):
        counts.append(blk.counts)
        cols.append(blk.col)
        vals.append(blk.val)
    ptr = torch.zeros(A.M + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.cat(counts), 0, out=ptr[1:])
    return Csr(M=A.M, N=B.N, ptr=ptr, col=torch.cat(cols),
               val=torch.cat(vals))
