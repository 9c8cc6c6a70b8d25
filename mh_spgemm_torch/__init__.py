"""mh_spgemm_torch — the PyTorch and CUDA port of mh_spgemm_tpu for one
NVIDIA H100.

Sparse general matrix-matrix multiplication C = A @ B over CSR matrices
with the bucketed expand-sort-compress engine: rows binned by product
count into power-of-two width classes, one gather-multiply per class, and
a hand-written CUDA kernel (``csrc/esc_tail.cu``) that sorts, accumulates
and left-packs each row.  Computes in float64 (or float32) natively.

The package imports torch, numpy and scipy only.  Its entry points run on
the card unless the caller passes ``device="cpu"``, where every kernel
takes its plain PyTorch version.
"""

from .baseline import oracle_spgemm, timed_oracle_spgemm, verify
from .config import DEFAULT_CONFIG, SpGEMMConfig
from .csr import CSR, DeviceCSR
from .errors import (DeviceError, MatrixFormatError, ShapeMismatchError,
                     SpGEMMError, VerificationError)
from .io.mmio import extract_matrix_name, read_mtx, write_mtx
from .pipeline import spgemm_bucketed, spgemm_chunked, spgemm_host
from .timing import Timing, gflops

__version__ = "0.1.0"

__all__ = [
    "CSR", "DeviceCSR", "SpGEMMConfig", "DEFAULT_CONFIG",
    "spgemm_bucketed", "spgemm_chunked", "spgemm_host",
    "oracle_spgemm", "timed_oracle_spgemm", "verify",
    "Timing", "gflops",
    "read_mtx", "write_mtx", "extract_matrix_name",
    "SpGEMMError", "MatrixFormatError", "ShapeMismatchError",
    "VerificationError", "DeviceError",
]
