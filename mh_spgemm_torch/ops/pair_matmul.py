"""Pair-stream block matmuls and the block gather — the port of
``mh_spgemm_tpu/ops/pallas_gather.py`` (``pair_matmul_f32`` :108,
``block_gather`` :43) and of the kernel half of
``mh_spgemm_tpu/ops/ozaki.py`` (``pair_matmul_f64_ozaki`` :201).

Pair matmul: for ``a`` [nab, 128, 128] and ``b`` [nbb, 128, 128] blocks
and a pair stream ``pair_a``, ``pair_b``, ``pair_cb`` (int32 [G],
``pair_cb`` nondecreasing) with weights ``live`` (0 or 1),

    out[c] = sum over g with pair_cb[g] == c of live[g] * a[pair_a[g]] @ b[pair_b[g]]

for c < ``ncb``; a C block with no live pair is zero.  The TPU kernels
computed this in f32 at ``Precision.HIGHEST`` (a multi-pass bf16
emulation of f32 on the matrix unit) and, for f64, through bf16 slices
with a double-f32 accumulator.  On the card :func:`pair_matmul_f64`
computes in f64 on the FP64 tensor cores and needs no error certificate;
:func:`pair_matmul_f32` runs the TF32 tensor cores in split form
(3xTF32: each operand is split into two TF32 parts and three of the
four part products are summed in f32), whose error is of the order of
f32 FFMA's and which is exact on 0/1 operands.  A nondecreasing
``pair_cb`` is the caller's contract: the plain versions check it, the
CUDA wrappers do not (the check would cost a host sync per call).  The
CUDA wrappers take ``a`` and ``b`` only where they start on a 16-byte
boundary (the kernels copy them in 16-byte chunks).

Block gather: ``table[idx]`` for whole blocks of a [T, r, c] table of 4-
or 8-byte elements.  No engine calls it (as in the JAX package).

Each wrapper launches its CUDA kernel (``csrc/pair_matmul.cu``) for CUDA
tensors, adding one to its ``launches``, and takes its plain PyTorch
version (``*_plain``) only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..errors import DeviceError

BS = 128
# pairs per batched product in the plain pair matmul
_PLAIN_CHUNK = 256


def _check_pairs(pair_a, pair_b, pair_cb, live) -> None:
    for name, t in (("pair_a", pair_a), ("pair_b", pair_b),
                    ("pair_cb", pair_cb)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if live.dtype not in (torch.int32, torch.bool) or live.dim() != 1:
        raise ValueError("live must be a 1-D int32 or bool tensor")
    if not (pair_a.shape == pair_b.shape == pair_cb.shape == live.shape):
        raise ValueError("pair_a, pair_b, pair_cb and live must have the "
                         "same length")


def _check_matmul(a, b, pair_a, pair_b, pair_cb, live, ncb: int,
                  dtype) -> None:
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"a and b must be {dtype}, got {a.dtype}, "
                         f"{b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != b.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} are "
                         "not [n, r, k] and [n, k, c] blocks")
    if ncb < 0:
        raise ValueError(f"ncb={ncb} must be >= 0")
    _check_pairs(pair_a, pair_b, pair_cb, live)
    devs = {t.device for t in (a, b, pair_a, pair_b, pair_cb, live)}
    if len(devs) != 1:
        raise ValueError(f"operands lie on several devices: {devs}")


def pair_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                      pair_a: torch.Tensor, pair_b: torch.Tensor,
                      pair_cb: torch.Tensor, live: torch.Tensor,
                      ncb: int) -> torch.Tensor:
    """Plain PyTorch version of the pair matmul (either value type):
    gather the blocks of each chunk of pairs, ``torch.bmm``, and
    ``index_add_`` each product into its C block.  Dead pairs add
    nothing."""
    G = pair_a.shape[0]
    if G and bool((pair_cb[1:] < pair_cb[:-1]).any()):
        raise ValueError("pair_cb must be nondecreasing")
    out = torch.zeros((ncb, a.shape[1], b.shape[2]), dtype=a.dtype,
                      device=a.device)
    for lo in range(0, G, _PLAIN_CHUNK):
        sl = slice(lo, lo + _PLAIN_CHUNK)
        keep = live[sl] != 0
        pa = pair_a[sl][keep].long()
        pb = pair_b[sl][keep].long()
        prod = torch.bmm(a.index_select(0, pa), b.index_select(0, pb))
        out.index_add_(0, pair_cb[sl][keep].long(), prod)
    return out


def boundary_streams(rng, nab: int, nbb: int):
    """Pair streams on which a kernel's ring crosses pair and segment
    boundaries, for checking the kernels against :func:`pair_matmul_plain`:
    C blocks with segments of 1, 2, 3 and 37 pairs, dead pairs at segment
    starts and ends and inside, a C block whose pairs are all dead, C
    blocks with no pair (among them the last); then a stream of one C
    block (ncb = 1) that starts with a dead pair.  Returns a list of
    ((pair_a, pair_b, pair_cb, live) as int32 numpy arrays, ncb)."""
    segs = ((0, [1]), (1, [1, 1]), (2, [0, 1, 1]), (4, [0] + [1] * 35 + [0]),
            (5, [0, 0]), (6, [1, 0, 1]), (8, [1] * 37), (9, [1, 1, 0]))
    out = []
    for segs, ncb in ((segs, 11), (((0, [0, 1, 1, 0, 1]),), 1)):
        cb = np.concatenate([np.full(len(lv), c) for c, lv in segs])
        live = np.concatenate([lv for _, lv in segs])
        out.append(((rng.integers(0, nab, cb.size).astype(np.int32),
                     rng.integers(0, nbb, cb.size).astype(np.int32),
                     cb.astype(np.int32), live.astype(np.int32)), ncb))
    return out


def f32_errors(fn, a: torch.Tensor, b: torch.Tensor, stream, ncb: int):
    """Max abs error of ``fn`` (an f32 pair matmul) against the f64
    product of the same f32 inputs, and that of ``torch.bmm`` in full f32
    (:func:`pair_matmul_plain`) on the same inputs."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("torch.bmm must run in full f32")
    exact = pair_matmul_plain(a.double(), b.double(), *stream, ncb=ncb)
    got = fn(a, b, *stream, ncb=ncb)
    ref = pair_matmul_plain(a, b, *stream, ncb=ncb)
    return (float((got.double() - exact).abs().max()),
            float((ref.double() - exact).abs().max()))


def _kernel_fn(name: str):
    lib = _build.load("pair_matmul")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        if name == "block_gather":
            fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_longlong, p]
        elif name == "pair_matmul_info":
            fn.argtypes = [ctypes.c_int, p]
        else:
            fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _pair_matmul(a, b, pair_a, pair_b, pair_cb, live, ncb: int, dtype,
                 name: str, wrapper) -> torch.Tensor:
    _check_matmul(a, b, pair_a, pair_b, pair_cb, live, ncb, dtype)
    if a.device.type == "cpu":
        return pair_matmul_plain(a, b, pair_a, pair_b, pair_cb, live, ncb)
    if a.device.type != "cuda":
        raise DeviceError(f"{name} has no kernel for {a.device.type} "
                          "tensors")
    if a.shape[1:] != (BS, BS) or b.shape[1:] != (BS, BS):
        raise ValueError(f"the kernel takes {BS} x {BS} blocks, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not all(t.is_contiguous() for t in (a, b, pair_a, pair_b, pair_cb,
                                           live)):
        raise ValueError("operands must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must start on a 16-byte boundary: the "
                         "kernel copies them in 16-byte chunks")
    out = torch.empty((ncb, BS, BS), dtype=dtype, device=a.device)
    if ncb == 0:
        return out
    if live.dtype != torch.int32:
        live = live.to(torch.int32)
    seg_start = torch.searchsorted(
        pair_cb, torch.arange(ncb + 1, dtype=torch.int32, device=a.device),
        out_int32=True)
    fn = _kernel_fn(name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), pair_a.data_ptr(),
                pair_b.data_ptr(), live.data_ptr(), seg_start.data_ptr(),
                out.data_ptr(), ncb, stream)
    if rc != 0:
        raise DeviceError(f"{name} launch failed: CUDA error {rc} "
                          f"(pairs={pair_a.shape[0]}, ncb={ncb})")
    wrapper.launches += 1
    return out


def pair_matmul_f32(a: torch.Tensor, b: torch.Tensor, pair_a: torch.Tensor,
                    pair_b: torch.Tensor, pair_cb: torch.Tensor,
                    live: torch.Tensor, *, ncb: int) -> torch.Tensor:
    """f32 pair matmul; returns [ncb, 128, 128] f32.  CUDA tensors go
    through the split-TF32 tensor-core kernel (3xTF32: big·big +
    big·small + small·big of x = big + small, accumulated in f32; not
    plain TF32), CPU tensors through :func:`pair_matmul_plain`."""
    return _pair_matmul(a, b, pair_a, pair_b, pair_cb, live, ncb,
                        torch.float32, "pair_matmul_f32", pair_matmul_f32)


def pair_matmul_f64(a: torch.Tensor, b: torch.Tensor, pair_a: torch.Tensor,
                    pair_b: torch.Tensor, pair_cb: torch.Tensor,
                    live: torch.Tensor, *, ncb: int) -> torch.Tensor:
    """f64 pair matmul; returns [ncb, 128, 128] f64.  CUDA tensors go
    through the FP64 tensor-core (DMMA) kernel, CPU tensors through
    :func:`pair_matmul_plain`."""
    return _pair_matmul(a, b, pair_a, pair_b, pair_cb, live, ncb,
                        torch.float64, "pair_matmul_f64", pair_matmul_f64)


pair_matmul_f32.launches = 0
pair_matmul_f64.launches = 0

KERNEL_INFO = ("registers", "dynamic_smem", "local_bytes", "blocks_per_sm")


def kernel_info(dtype) -> dict:
    """What the CUDA runtime reports of the built pair kernel of ``dtype``
    (float64 or float32) on the current card: registers, dynamic shared
    memory bytes, local (stack and spill) bytes and resident blocks per
    SM."""
    buf = (ctypes.c_int * len(KERNEL_INFO))()
    rc = _kernel_fn("pair_matmul_info")(int(dtype == torch.float64),
                                        ctypes.addressof(buf))
    if rc != 0:
        raise DeviceError(f"pair_matmul_info: CUDA error {rc}")
    return dict(zip(KERNEL_INFO, list(buf)))


def block_gather_plain(table: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version of the block gather: ``table[idx]``."""
    return table.index_select(0, idx.long())


def block_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a [T, r, c] ``table`` of 4- or 8-byte elements
    and int32 ``idx`` [G].  CUDA tensors go through the copy kernel (one
    thread block per gathered block), CPU tensors through
    :func:`block_gather_plain`.  ``idx`` must lie in [0, T); the kernel
    writes a zero block for an index outside it."""
    if table.dim() != 3 or table.element_size() not in (4, 8):
        raise ValueError("table must be [T, r, c] of 4- or 8-byte elements")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be a 1-D int32 tensor")
    if idx.device != table.device:
        raise ValueError("table and idx must lie on one device")
    if table.device.type == "cpu":
        return block_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise DeviceError(f"block_gather has no kernel for "
                          f"{table.device.type} tensors")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    G = idx.shape[0]
    out = torch.empty((G,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    block_bytes = table.shape[1] * table.shape[2] * table.element_size()
    if G == 0 or block_bytes == 0:
        return out
    fn = _kernel_fn("block_gather")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), G,
                table.shape[0], block_bytes, stream)
    if rc != 0:
        raise DeviceError(f"block_gather launch failed: CUDA error {rc} "
                          f"(G={G}, block bytes={block_bytes})")
    block_gather.launches += 1
    return out


block_gather.launches = 0
