"""The gather frontend's CUDA kernel (``csrc/gather_front.cu``): one
launch writes a gather class's keys, A·B products and per-row counts
straight from the plan's entry arrays.

It replaces no TPU kernel (the JAX package's ``_front_gather`` is plain
takes).  Its plain version is ``ops/bucketed.front_gather_plain``, and
``ops/bucketed.front_gather`` is the wrapper that picks: CPU tensors take
the plain version, CUDA tensors :func:`gather_front`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..errors import DeviceError

_ENTRY_FIELDS = ("ent_dst", "ent_src", "ent_len", "ent_aidx")


def _kernel_fn():
    lib = _build.load("gather_front")
    fn = lib.gather_front_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def gather_front(d: dict, a_val: torch.Tensor, b_col: torch.Tensor,
                 b_val: torch.Tensor, *, W: int, rb: int):
    """One gather class's frontend on the card: ``d`` holds the class's
    entry arrays (``ent_dst``, ``ent_src``, ``ent_len``, ``ent_aidx``,
    int32 ``[nchunks, eb]``, as the planner makes them: sorted by
    ``ent_dst`` within a chunk, pads at ``rb * W``).  Returns (K int32
    ``[nchunks * rb, W]``, prod ``[nchunks * rb, W]`` in the value type,
    row_len int32 ``[nchunks * rb]``): B's column and ``a_val * b_val`` on
    each slot an entry covers, 2^31-1 and +0.0 elsewhere, and each row's
    covered slots.  Launches once on the current stream and adds one to
    ``gather_front.launches``; raises for tensors off CUDA or of another
    type."""
    ent = [d[k] for k in _ENTRY_FIELDS]
    if a_val.device.type != "cuda":
        raise DeviceError(f"gather_front has no kernel for "
                          f"{a_val.device.type} tensors")
    if any(x.dtype != torch.int32 or x.shape != ent[0].shape or x.dim() != 2
           for x in ent) or b_col.dtype != torch.int32:
        raise ValueError("the entry arrays must be int32 [nchunks, eb] and "
                         "b_col int32")
    if a_val.dtype not in (torch.float64, torch.float32) \
            or b_val.dtype != a_val.dtype:
        raise ValueError(f"a_val and b_val must share float64 or float32, "
                         f"got {a_val.dtype} and {b_val.dtype}")
    if not all(x.device == a_val.device for x in (*ent, b_col, b_val)):
        raise ValueError("gather_front's tensors must share a device")
    nch, eb = ent[0].shape
    dev = a_val.device
    K = torch.empty((nch * rb, W), dtype=torch.int32, device=dev)
    prod = torch.empty((nch * rb, W), dtype=a_val.dtype, device=dev)
    row_len = torch.empty(nch * rb, dtype=torch.int32, device=dev)
    ent = [x.contiguous() for x in ent]
    a_val, b_col, b_val = (x.contiguous() for x in (a_val, b_col, b_val))
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        rc = fn(*(x.data_ptr() for x in ent), nch, eb, rb, W,
                a_val.data_ptr(), b_col.data_ptr(), b_val.data_ptr(),
                K.data_ptr(), prod.data_ptr(), row_len.data_ptr(),
                int(a_val.dtype == torch.float64),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise DeviceError(f"gather_front launch failed: CUDA error {rc} "
                          f"(nchunks={nch}, eb={eb}, rb={rb}, W={W})")
    gather_front.launches += 1
    return K, prod, row_len


gather_front.launches = 0
