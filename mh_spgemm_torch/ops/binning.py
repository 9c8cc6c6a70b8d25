"""Row binning by work estimate — the port of
``mh_spgemm_tpu/ops/binning.py``.

``bin_rows`` histograms rows into bins by an ascending list of inclusive
upper bounds (the reference's two binning kernels as one digitize and a
stable sort by bin id); ``group_size`` and ``scan_passes`` are the
reference's adaptive-grouping heuristic and the Hillis-Steele pass count
it implies.  No engine of either package calls them; they are public
API of the ops layer.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Binning(NamedTuple):
    bin_of_row: torch.Tensor   # int32[M] bin index per row
    bin_size: torch.Tensor     # int32[NBINS]
    bin_offset: torch.Tensor   # int32[NBINS+1] exclusive scan of sizes
    rows_by_bin: torch.Tensor  # int32[M] row ids grouped by bin
    max_work: torch.Tensor     # int32[]  max per-row work


def bin_rows(work: torch.Tensor, bounds: Tuple[int, ...]) -> Binning:
    """Assign each row to a bin by its work estimate: bin b holds work in
    (bounds[b-1], bounds[b]], and work above the last bound lands in the
    overflow bin ``len(bounds)``."""
    dev = work.device
    b = torch.tensor(bounds, dtype=work.dtype, device=dev)
    bin_of_row = torch.searchsorted(b, work).to(torch.int32)
    nbins = len(bounds) + 1
    bin_size = torch.zeros(nbins, dtype=torch.int32, device=dev)
    bin_size.index_add_(0, bin_of_row.long(),
                        torch.ones_like(bin_of_row))
    bin_offset = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.cumsum(bin_size, 0, dtype=torch.int32)])
    rows_by_bin = torch.sort(bin_of_row, stable=True).indices.to(
        torch.int32)
    m = work.shape[0]
    max_work = (work.max() if m else
                torch.zeros((), dtype=torch.int32, device=dev))
    return Binning(bin_of_row=bin_of_row, bin_size=bin_size,
                   bin_offset=bin_offset, rows_by_bin=rows_by_bin,
                   max_work=max_work)


def group_size(flop: int, nnz_arow: int, block: int = 512) -> int:
    """The reference's adaptive grouping: threads cooperating per A-row
    entry, ``clamp(round_pow2(flop / nnz), <= block)``, doubled while the
    block would still hold twice the row's entries."""
    if nnz_arow <= 0:
        return 1
    g = _round_pow2(max(1, flop // max(1, nnz_arow)))
    g = min(g, block)
    while g < block and (block // g) * 2 > max(1, nnz_arow):
        g *= 2
    return g


def _round_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def scan_passes(max_group: int) -> int:
    """Hillis-Steele pass count needed for segments up to ``max_group``."""
    return max(0, int(max_group - 1).bit_length())
