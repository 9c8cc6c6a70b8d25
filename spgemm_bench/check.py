"""The comparison that decides ``correct``: the program's C against the
plain reference's (``reference.py``), block of rows by block of rows.

Numbers compared, each against a limit of its configuration's
``check`` entry:

* ``shape_wrong``: outputs whose shape, ``ptr[0]`` or stated nnz does not
  fit their own ``ptr`` (limit 0);
* ``rows_wrong``: rows whose end offset ``ptr[i + 1]`` differs from the
  reference's (limit 0);
* ``entries_wrong``: entries whose column differs, counting every entry
  of a block whose row pointer differs (limit 0);
* ``val_gap``: over the entries whose position agrees, the widest
  ``|c - r| / (|A| @ |B|)``: the error of a value against the magnitude
  of the products it sums, which a float64 sum keeps near 2**-53 in any
  order and a float32 sum cannot;
* ``calls_failed`` (limit 0) and ``outputs_missing`` (limit 0), from the
  run: calls that raised, and whether no output was kept to compare.

It imports torch and numpy only; the program's outputs are read, not
imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference

EXACT = ("shape_wrong", "rows_wrong", "entries_wrong", "calls_failed",
         "outputs_missing")


def _tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                         dtype=dtype)


class Output:
    """One output of the program (a host ``CSR`` or a ``DeviceCSR``) as
    tensors on the comparison's device: ``ptr`` trimmed to M + 1 rows,
    the stated nnz beside ``ptr[M]``."""

    def __init__(self, C, device):
        self.M, self.N = int(C.M), int(C.N)
        self.ptr = _tensor(C.ptr[: self.M + 1], device, torch.int64)
        self.col = C.col                 # cast block by block
        self.val = C.val
        stated = getattr(C, "nnz_true", None)
        self.end = int(self.ptr[-1]) if self.ptr.numel() else -1
        self.stated = self.end if stated is None else int(stated)
        self.ok = (self.ptr.numel() == self.M + 1 and self.end >= 0
                   and int(self.ptr[0]) == 0 and self.stated == self.end
                   and len(C.col) >= self.end and len(C.val) >= self.end)

    def cols(self, lo, hi, device):
        return _tensor(self.col[lo:hi], device, torch.int64)

    def vals(self, lo, hi, device):
        return _tensor(self.val[lo:hi], device, torch.float64)


def compare(A, B, outputs: list, device, dtype=torch.float64) -> dict:
    """Every output in ``outputs`` (each C = A @ B as the program returned
    it) against one pass of the reference in ``dtype``; the readings of
    :data:`EXACT` but the run's own, and ``val_gap``, over all of them."""
    outs = [Output(C, device) for C in outputs]
    r = {"shape_wrong": 0, "rows_wrong": 0, "entries_wrong": 0,
         "val_gap": 0.0, "nnz_c": 0}
    for o in outs:
        if not o.ok or o.M != A.M or o.N != B.N:
            r["shape_wrong"] += 1
    live = [o for o in outs if o.M == A.M and o.N == B.N
            and o.ptr.numel() == A.M + 1]
    base = 0
    for blk in reference.product(A, B, device, dtype):
        nu = int(blk.col.numel())
        ref_end = base + torch.cumsum(blk.counts, 0)
        for o in live:
            bad_rows = int((o.ptr[blk.r0 + 1:blk.r1 + 1] != ref_end).sum())
            r["rows_wrong"] += bad_rows
            if bad_rows or int(o.ptr[blk.r0]) != base \
                    or len(o.col) < base + nu:
                r["entries_wrong"] += nu
                continue
            same = o.cols(base, base + nu, device) == blk.col
            r["entries_wrong"] += int((~same).sum())
            diff = (o.vals(base, base + nu, device)
                    - blk.val.to(torch.float64)).abs()
            scale = blk.scale.to(torch.float64)
            gap = torch.where(scale > 0, diff / scale,
                              torch.where(diff > 0, math.inf, 0.0))
            gap = torch.nan_to_num(gap[same], nan=math.inf)
            if gap.numel():
                r["val_gap"] = max(r["val_gap"], float(gap.max()))
        base += nu
    r["nnz_c"] = base
    return r


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit), ...]) for every limited number."""
    rows = [(name, readings[name], limits[name]) for name in limits]
    return all(v <= lim for _, v, lim in rows), rows
