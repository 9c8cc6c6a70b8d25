"""mh_spgemm_torch — the PyTorch and CUDA port of mh_spgemm_tpu for one
NVIDIA H100.

Sparse general matrix-matrix multiplication C = A @ B over CSR matrices
with two engines and a per-matrix choice between them (``mode="auto"``):

* the bucketed expand-sort-compress engine: rows binned by product count
  into power-of-two width classes, one gather-multiply per class (on the
  gather frontend the hand-written CUDA kernel ``csrc/gather_front.cu``;
  for rows with long B spans, a run copy by the hand-written CUDA kernel
  ``csrc/ragged_fill.cu``), and a hand-written CUDA kernel
  (``csrc/esc_tail.cu``) that sorts, accumulates and left-packs each
  row;
* the block-dense engine: dense 128 x 128 block products over the
  nonzero block-pair stream, by hand-written CUDA pair-matmul kernels
  (``csrc/pair_matmul.cu``).

``mode="masked"`` runs the paper's own two-stage algorithm on the
bucketed engine's classes: an exact symbolic stage over B's 32-column
tile bitmap, then the numeric stage.  Both engines' extraction copies
long rows into the CSR arrays with ``ragged_fill`` where its cost model
says so.

At the level of device operands (``CSR.device``), ``spgemm`` with a
reusable ``SpGEMMPlan`` (``make_plan``) runs the paper's pipeline at
product granularity (``mode="masked"``) or the fused
expand-sort-compress engine (``mode="esc"``, and every other mode), in
torch ops with the reference's seven-phase accounting.

``spgemm_dist`` runs the bucketed engine (or, with ``engine="esc"``, the
fused ESC engine) over a mesh of shards
(``make_row_mesh``, ``make_grid_mesh``; shards may share a card): B
replicated, gathered, fetched row by row as each shard's A block needs it
(``ragged``, whose exchange under ``comm_backend="pallas"`` is the
hand-written CUDA kernel ``csrc/remote_fetch.cu``), or block-partitioned
over a 2-D grid.

Computes in float64 (or float32) natively.  ``python -m mh_spgemm_torch``
is the benchmark CLI.

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
from .parallel.mesh import make_grid_mesh, make_row_mesh
from .parallel.spgemm_dist import spgemm_dist
from .pipeline import (SpGEMMPlan, choose_engine, make_plan,
                       prepare_blockdense_state, prepare_masked_state,
                       spgemm, spgemm_blockdense, spgemm_bucketed,
                       spgemm_chunked, spgemm_host, spgemm_masked)
from .timing import Timing, gflops

__version__ = "0.1.0"

__all__ = [
    "CSR", "DeviceCSR", "SpGEMMConfig", "DEFAULT_CONFIG",
    "SpGEMMPlan", "make_plan", "spgemm",
    "spgemm_bucketed", "spgemm_chunked", "spgemm_host",
    "spgemm_blockdense", "prepare_blockdense_state", "choose_engine",
    "spgemm_masked", "prepare_masked_state",
    "spgemm_dist", "make_row_mesh", "make_grid_mesh",
    "oracle_spgemm", "timed_oracle_spgemm", "verify",
    "Timing", "gflops",
    "read_mtx", "write_mtx", "extract_matrix_name",
    "SpGEMMError", "MatrixFormatError", "ShapeMismatchError",
    "VerificationError", "DeviceError",
]
