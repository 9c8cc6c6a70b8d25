"""Benchmark suite definitions: the 16-matrix SuiteSparse set by name and
its deterministic synthetic stand-ins (the same families, sizes and
name-derived seeds as ``mh_spgemm_tpu.io.suites``, so both packages
build bit-identical matrices), and the 408-name soak list
(:func:`matrix408_list`), read from a file the caller names."""

from __future__ import annotations

import os
import zlib
from typing import List, Optional

from ..bench import gen
from ..csr import CSR
from .mmio import read_mtx

SIXTEEN_MATRICES = [
    "pdb1HYS", "pwtk", "webbase-1M", "cage12", "cant", "hood", "rma10",
    "scircuit", "shipsec1", "cop20k_A", "mac_econ_fwd500", "offshore",
    "wb-edu", "cage15", "GAP-road", "delaunay_n24",
]


def matrix408_list() -> List[str]:
    """The 408-name SuiteSparse soak list, one matrix name per line of
    the file ``$MATRIX408_LIST`` names.  Raises FileNotFoundError when the
    variable is unset or its file is missing; nothing is downloaded."""
    path = os.environ.get("MATRIX408_LIST")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "set MATRIX408_LIST to a matrix-name list file (one per line)")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


# Structural stand-ins for the 16-matrix suite: (family, kwargs).
SYNTHETIC_16 = {
    "pdb1HYS": ("banded", dict(n=36_000, band=80, nnz_per_row=119)),
    "pwtk": ("banded", dict(n=218_000, band=100, nnz_per_row=53)),
    "webbase-1M": ("powerlaw", dict(n=1_000_000, avg_nnz=3, max_row=4700)),
    "cage12": ("random", dict(n=130_000, nnz_per_row=15)),
    "cant": ("banded", dict(n=62_000, band=64, nnz_per_row=64)),
    "hood": ("banded", dict(n=220_000, band=80, nnz_per_row=48)),
    "rma10": ("banded", dict(n=46_000, band=96, nnz_per_row=50)),
    "scircuit": ("powerlaw", dict(n=170_000, avg_nnz=5, max_row=353)),
    "shipsec1": ("banded", dict(n=140_000, band=128, nnz_per_row=55)),
    "cop20k_A": ("random", dict(n=121_000, nnz_per_row=21)),
    "mac_econ_fwd500": ("powerlaw", dict(n=206_000, avg_nnz=6, max_row=44)),
    "offshore": ("banded", dict(n=259_000, band=128, nnz_per_row=16)),
    "wb-edu": ("powerlaw", dict(n=984_000, avg_nnz=6, max_row=3841)),
    "cage15": ("random", dict(n=500_000, nnz_per_row=19)),
    "GAP-road": ("random", dict(n=1_000_000, nnz_per_row=2)),
    "delaunay_n24": ("random", dict(n=2_000_000, nnz_per_row=6)),
}


def suitesparse_root() -> Optional[str]:
    return os.environ.get("SUITESPARSE_ROOT")


def load_matrix(name: str, allow_synthetic: bool = True) -> CSR:
    """Resolve a suite name or .mtx path: an explicit path, a real
    SuiteSparse file under ``$SUITESPARSE_ROOT``, or the synthetic
    stand-in (seeded by the name's CRC32)."""
    if os.path.exists(name):
        return read_mtx(name)
    root = suitesparse_root()
    if root:
        for cand in (os.path.join(root, name, f"{name}.mtx"),
                     os.path.join(root, f"{name}.mtx")):
            if os.path.exists(cand):
                return read_mtx(cand)
    if not allow_synthetic:
        raise FileNotFoundError(
            f"matrix {name!r} not found under SUITESPARSE_ROOT")
    family, kwargs = SYNTHETIC_16.get(
        name, ("random", dict(n=100_000, nnz_per_row=8)))
    seed = zlib.crc32(name.encode()) % (2**31)
    return gen.FAMILIES[family](seed=seed, **kwargs)
