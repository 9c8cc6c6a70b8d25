"""Flat ESC tail: sort + accumulate + left-pack over aligned pow2
segments — the port of ``mh_spgemm_tpu/ops/esc_tail.py:234``
(``esc_tail_flat``).

Input: ``keys`` int32[slots] (2^31-1 marks an empty slot) and ``vals``
[slots] in the port's value type (float64, or float32), with
``slots % w2 == 0`` and ``w2`` a power of two in 2..65536.  Output, per
aligned segment of ``w2`` slots: the distinct keys ascending with their
summed values, left-packed, then 2^31-1 keys with value 0; plus each
segment's output count.  The TPU kernel carried f64 values as double-f32
(hi, lo) pairs; the card has native f64, so the port computes in its own
value type.

:func:`esc_tail_flat` launches the CUDA kernel ``csrc/esc_tail.cu`` for
CUDA tensors and takes :func:`esc_tail_flat_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..errors import DeviceError

I32_MAX = 2**31 - 1
_MAX_W2 = 1 << 16


def supported_w2(w: int) -> bool:
    """True when the flat tail takes segments of width ``w`` (a power of
    two in 2..65536)."""
    return 2 <= w <= _MAX_W2 and (w & (w - 1)) == 0


def esc_tail_flat_plain(keys: torch.Tensor, vals: torch.Tensor, *,
                        w2: int):
    """Plain PyTorch version of the flat tail (same contract as
    :func:`esc_tail_flat`): a stable sort per segment, a run index per
    slot, and ``index_add_`` of each run into its packed slot."""
    slots = keys.shape[0]
    S = slots // w2
    dev = keys.device
    sk, order = torch.sort(keys.view(S, w2), dim=1, stable=True)
    sv = torch.gather(vals.view(S, w2), 1, order)
    valid = sk < I32_MAX
    head = valid.clone()
    head[:, 1:] &= sk[:, 1:] != sk[:, :-1]
    run = torch.cumsum(head, dim=1, dtype=torch.int64) - 1
    counts = head.sum(dim=1, dtype=torch.int32)
    dst = (torch.arange(S, device=dev, dtype=torch.int64)[:, None] * w2
           + run)
    out_v = torch.zeros(slots, dtype=vals.dtype, device=dev)
    out_v.index_add_(0, dst[valid], sv[valid])
    out_k = torch.full((slots,), I32_MAX, dtype=torch.int32, device=dev)
    out_k[dst[head]] = sk[head]
    return out_k, out_v, counts


def _check(keys: torch.Tensor, vals: torch.Tensor, w2: int) -> None:
    if not supported_w2(w2):
        raise ValueError(f"w2={w2}: segments must be a power of two in "
                         f"2..{_MAX_W2}")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("keys must be a 1-D int32 tensor")
    if vals.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"values of type {vals.dtype} are not supported")
    if vals.shape != keys.shape or vals.device != keys.device:
        raise ValueError("keys and values must match in shape and device")
    if keys.shape[0] % w2:
        raise ValueError(f"{keys.shape[0]} slots are not a multiple of "
                         f"w2={w2}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and values must be contiguous")


def _kernel_fn(vdtype: torch.dtype):
    lib = _build.load("esc_tail")
    name = ("esc_tail_flat_f64" if vdtype == torch.float64
            else "esc_tail_flat_f32")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        lib.esc_tail_flat_scratch_bytes.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.esc_tail_flat_scratch_bytes.restype = ctypes.c_longlong
    return lib, fn


def esc_tail_flat(keys: torch.Tensor, vals: torch.Tensor, *, w2: int):
    """Flat tail over ``[slots]`` planes; returns (packed keys int32
    [slots], packed values [slots], per-segment counts int32
    [slots / w2]).

    CUDA tensors go through the kernel (``csrc/esc_tail.cu``) on the
    current stream, and each launch adds one to
    ``esc_tail_flat.launches``; CPU tensors take
    :func:`esc_tail_flat_plain`.  Any other device raises."""
    _check(keys, vals, w2)
    if keys.device.type == "cpu":
        return esc_tail_flat_plain(keys, vals, w2=w2)
    if keys.device.type != "cuda":
        raise DeviceError(f"esc_tail_flat has no kernel for "
                          f"{keys.device.type} tensors")
    slots = keys.shape[0]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    counts = torch.empty(slots // w2, dtype=torch.int32, device=keys.device)
    if slots == 0:
        return out_k, out_v, counts
    lib, fn = _kernel_fn(vals.dtype)
    nbytes = lib.esc_tail_flat_scratch_bytes(slots, w2, vals.element_size())
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=keys.device)
               if nbytes else None)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), vals.data_ptr(), out_k.data_ptr(),
                out_v.data_ptr(), counts.data_ptr(), slots, w2,
                scratch.data_ptr() if scratch is not None else None, stream)
    if rc != 0:
        raise DeviceError(f"esc_tail_flat launch failed: CUDA error {rc} "
                          f"(slots={slots}, w2={w2}, {vals.dtype})")
    esc_tail_flat.launches += 1
    return out_k, out_v, counts


esc_tail_flat.launches = 0
