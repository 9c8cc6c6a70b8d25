"""Ragged run copy: host-planned (src, dst, len) runs of int32 words from
a ``[rows, 128]`` source stream into a packed output — the port of
``mh_spgemm_tpu/ops/ragged_fill.py:156`` (``ragged_fill``).

The fill frontend (``ops/bucketed.py``) streams each row's B columns and
value words into its slab with it, the masked engine its tile slab, and
the windowed extraction every C row's packed slab span into the CSR
arrays.  The run descriptors keep the JAX package's encoding exactly
(:data:`PAD_ROWS`, the window bias of the planner), so plans compare
array for array; the TPU's double-buffered window DMA, SMEM descriptor
staging and lane rotation are reasons of that machine and do not come
across.

:func:`ragged_fill` launches the CUDA kernel ``csrc/ragged_fill.cu`` for
CUDA tensors and takes :func:`ragged_fill_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..errors import DeviceError

# Output (and source) row slack of the JAX kernel's block walk; the
# output keeps its ``[out_rows + PAD_ROWS, 128]`` shape so the planners'
# stream pitches stay those of the JAX package.
PAD_ROWS = 72


def _check(win_row: torch.Tensor, runs: torch.Tensor,
           pairs2d: torch.Tensor, out_rows: int, nplanes: int) -> None:
    if win_row.dtype != torch.int32 or runs.dtype != torch.int32 \
            or pairs2d.dtype != torch.int32:
        raise ValueError("win_row, runs and pairs2d must be int32")
    if win_row.dim() < 2 or win_row.shape[-1] != 2:
        raise ValueError(f"win_row must be [..., S, 2], got "
                         f"{tuple(win_row.shape)}")
    if runs.dim() != win_row.dim() + 1 or runs.shape[-1] != 3 \
            or runs.shape[:-2] != win_row.shape[:-1]:
        raise ValueError(f"runs {tuple(runs.shape)} must be [..., S, EPG, "
                         f"3] for win_row {tuple(win_row.shape)}")
    if pairs2d.dim() != 2 or pairs2d.shape[1] != 128:
        raise ValueError("pairs2d must be [rows, 128]")
    if out_rows < 0 or nplanes < 1:
        raise ValueError("out_rows must be >= 0 and nplanes >= 1")
    if not (win_row.device == runs.device == pairs2d.device):
        raise ValueError("win_row, runs and pairs2d must share a device")


def ragged_fill_plain(win_row: torch.Tensor, runs: torch.Tensor,
                      pairs2d: torch.Tensor, *, out_rows: int,
                      nplanes: int = 1, src_stride_rows: int = 0,
                      dst_stride: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`ragged_fill` (same contract):
    every live run expanded to word indices, one indexed copy per plane.
    Words no run covers are zero here."""
    batch = tuple(win_row.shape[:-2])
    S, epg = win_row.shape[-2], runs.shape[-2]
    nb = math.prod(batch)
    dev = pairs2d.device
    ow = (out_rows + PAD_ROWS) * 128
    out = torch.zeros((nb, ow), dtype=torch.int32, device=dev)
    wr = win_row.reshape(nb * S, 2).long()
    rn = runs.reshape(nb * S, epg, 3).long()
    cnt = wr[:, 1].clamp(0, epg)
    e = torch.arange(epg, device=dev)
    live = (e[None, :] < cnt[:, None]) & (rn[:, :, 2] > 0)
    t, ei = torch.nonzero(live, as_tuple=True)
    if t.numel():
        ln = rn[t, ei, 2]
        src = rn[t, ei, 0] + wr[t, 0] * 128
        dst = rn[t, ei, 1]
        rep = torch.repeat_interleave(torch.arange(t.numel(), device=dev),
                                      ln)
        within = (torch.arange(rep.numel(), device=dev)
                  - torch.repeat_interleave(torch.cumsum(ln, 0) - ln, ln))
        b = (t // S)[rep]
        flat = pairs2d.reshape(-1)
        for p in range(nplanes):
            s = src[rep] + p * src_stride_rows * 128 + within
            d = dst[rep] + p * dst_stride + within
            ok = (s >= 0) & (s < flat.numel()) & (d >= 0) & (d < ow)
            out[b[ok], d[ok]] = flat[s[ok]]
    return out.reshape(*batch, out_rows + PAD_ROWS, 128)


def _kernel_fn():
    lib = _build.load("ragged_fill")
    fn = lib.ragged_fill
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, ll, p, ll, i, i, i, i, ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


def ragged_fill(win_row: torch.Tensor, runs: torch.Tensor,
                pairs2d: torch.Tensor, *, out_rows: int, nplanes: int = 1,
                src_stride_rows: int = 0,
                dst_stride: int = 0) -> torch.Tensor:
    """Copy runs of int32 words from ``pairs2d`` into a fresh output.

    ``win_row`` int32[..., S, 2]: per grid step, [0] = the source window's
    start row and [1] = the number of live runs.  ``runs`` int32[..., S,
    EPG, 3]: per step up to EPG (window-relative src, flat dst, len) runs,
    live runs first, len 0 = no-op.  For plane ``p`` a run reads from row
    ``win_row + p * src_stride_rows`` and writes at ``dst + p *
    dst_stride``.  Leading batch dimensions (the chunks of a class) run in
    one launch, each into its own output.  Returns int32[..., out_rows +
    PAD_ROWS, 128]; words no run covers are undefined, and callers mask
    them.

    CUDA tensors go through the kernel (``csrc/ragged_fill.cu``) on the
    current stream, and each launch adds one to ``ragged_fill.launches``;
    CPU tensors take :func:`ragged_fill_plain`.  Any other device
    raises."""
    _check(win_row, runs, pairs2d, out_rows, nplanes)
    kw = dict(out_rows=out_rows, nplanes=nplanes,
              src_stride_rows=src_stride_rows, dst_stride=dst_stride)
    if pairs2d.device.type == "cpu":
        return ragged_fill_plain(win_row, runs, pairs2d, **kw)
    if pairs2d.device.type != "cuda":
        raise DeviceError(f"ragged_fill has no kernel for "
                          f"{pairs2d.device.type} tensors")
    batch = tuple(win_row.shape[:-2])
    S, epg = win_row.shape[-2], runs.shape[-2]
    nb = math.prod(batch)
    out = torch.empty((*batch, out_rows + PAD_ROWS, 128), dtype=torch.int32,
                      device=pairs2d.device)
    if nb * S == 0:
        return out
    wr, rn, src = (x.contiguous() for x in (win_row, runs, pairs2d))
    fn = _kernel_fn()
    with torch.cuda.device(pairs2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(wr.data_ptr(), rn.data_ptr(), src.data_ptr(), src.numel(),
                out.data_ptr(), (out_rows + PAD_ROWS) * 128, nb, S, epg,
                nplanes, src_stride_rows, dst_stride, stream)
    if rc != 0:
        raise DeviceError(f"ragged_fill launch failed: CUDA error {rc} "
                          f"(batch={nb}, steps={S}, nplanes={nplanes})")
    ragged_fill.launches += 1
    return out


ragged_fill.launches = 0
