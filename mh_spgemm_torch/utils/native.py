"""ctypes binding to the native C++ host library
``native/libmhspgemm_host.so`` (built by ``native/build.sh``).

The library is optional and only read: when it is absent every caller
takes its numpy path, which gives identical results.  The port uses two
of its entry points: the bucket planner's descriptor builder and the
Matrix Market body parser.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_IP = ctypes.POINTER(ctypes.c_int32)
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def default_path() -> str:
    """``native/libmhspgemm_host.so`` at the root of this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libmhspgemm_host.so")


def load(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    """Load the library once (from ``path``, default :func:`default_path`)
    and return it, or None when the file does not exist."""
    global _LIB, _TRIED
    if _TRIED and path is None:
        return _LIB
    _TRIED = True
    _LIB = None
    path = path or default_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.mh_parse_mtx_body.restype = ctypes.c_longlong
    lib.mh_parse_mtx_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
    ]
    lib.mh_free.restype = None
    lib.mh_free.argtypes = [ctypes.c_void_p]
    lib.mh_bucket_entries.restype = ctypes.c_longlong
    lib.mh_bucket_entries.argtypes = [
        _IP, _IP, _IP, _IP, ctypes.c_longlong, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, _IP, _IP, _IP, _IP]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def parse_mtx_body(path: str, is_pattern: bool, is_complex: bool
                   ) -> Optional[Tuple[int, int, np.ndarray, np.ndarray,
                                       np.ndarray]]:
    """Parse the body of a coordinate .mtx with the C++ tokenizer.
    Returns (M, N, rows, cols, vals) with 0-based indices, or None."""
    lib = load()
    if lib is None:
        return None
    dims = (ctypes.c_longlong * 3)()
    prows = ctypes.POINTER(ctypes.c_longlong)()
    pcols = ctypes.POINTER(ctypes.c_longlong)()
    pvals = ctypes.POINTER(ctypes.c_double)()
    rc = lib.mh_parse_mtx_body(path.encode(), int(is_pattern),
                               int(is_complex), dims,
                               ctypes.byref(prows), ctypes.byref(pcols),
                               ctypes.byref(pvals))
    if rc != 0:
        return None
    M, N, nnz = int(dims[0]), int(dims[1]), int(dims[2])
    rows = np.ctypeslib.as_array(prows, shape=(nnz,)).copy()
    cols = np.ctypeslib.as_array(pcols, shape=(nnz,)).copy()
    vals = np.ctypeslib.as_array(pvals, shape=(nnz,)).copy()
    lib.mh_free(prows)
    lib.mh_free(pcols)
    lib.mh_free(pvals)
    return M, N, rows, cols, vals


def bucket_entries(a_ptr: np.ndarray, a_col: np.ndarray,
                   b_ptr: np.ndarray, rows: np.ndarray, rb: int, w: int,
                   eb: int, nchunks: int) -> Optional[tuple]:
    """Native bucket-plan descriptor builder for one class.  Returns
    (ent_dst, ent_src, ent_len, ent_aidx) shaped [nchunks, eb], or None
    when the library is absent."""
    lib = load()
    if lib is None:
        return None

    def as32(x):
        return np.ascontiguousarray(x, dtype=np.int32)

    a_ptr, a_col, b_ptr, rows = map(as32, (a_ptr, a_col, b_ptr, rows))
    shape = (nchunks, eb)
    ent_dst = np.full(shape, rb * w, dtype=np.int32)
    ent_src = np.zeros(shape, dtype=np.int32)
    ent_len = np.zeros(shape, dtype=np.int32)
    ent_aidx = np.zeros(shape, dtype=np.int32)
    rc = lib.mh_bucket_entries(
        a_ptr.ctypes.data_as(_IP), a_col.ctypes.data_as(_IP),
        b_ptr.ctypes.data_as(_IP), rows.ctypes.data_as(_IP),
        len(rows), rb, w, eb,
        ent_dst.ctypes.data_as(_IP), ent_src.ctypes.data_as(_IP),
        ent_len.ctypes.data_as(_IP), ent_aidx.ctypes.data_as(_IP))
    if rc != 0:
        return None
    return ent_dst, ent_src, ent_len, ent_aidx
