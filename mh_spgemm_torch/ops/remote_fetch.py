"""Halo exchange: the all_to_all of the ragged B fetch — the port of
``mh_spgemm_tpu/ops/remote_fetch.py`` (``halo_exchange`` :67,
``exchange_planes`` :88).

Each shard of a mesh holds an int32 ``[D, vr, 128]`` tensor whose block d
is its payload for shard d; after the exchange shard s holds, in slot d,
the block shard d sent it.  The port runs every shard of a mesh in one
process, so one call moves every shard's blocks:
:func:`halo_exchange` takes the D send tensors and returns the D receive
tensors.  CUDA tensors go through one launch of the kernel
``csrc/remote_fetch.cu`` (shards on one card, or on several cards that
all have peer access to each other; otherwise it raises); CPU tensors take
:func:`halo_exchange_plain`.  The TPU kernel's DMA semaphores and double
buffer have no counterpart: each payload is read once and written once.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .. import _build
from ..errors import DeviceError

MAX_SHARDS = 64          # the kernel's pointer table (csrc/remote_fetch.cu)


def _check(sends: Sequence[torch.Tensor], n_devices: int) -> None:
    if len(sends) != n_devices:
        raise ValueError(f"{len(sends)} send tensors for {n_devices} shards")
    shape = tuple(sends[0].shape)
    if len(shape) != 3 or shape[0] != n_devices or shape[2] != 128:
        raise ValueError(f"send tensors must be [{n_devices}, vr, 128], got "
                         f"{shape}")
    for s in sends:
        if tuple(s.shape) != shape or s.dtype != torch.int32:
            raise ValueError("send tensors must all be int32 of one shape")
    types = {s.device.type for s in sends}
    if len(types) != 1:
        raise ValueError(f"send tensors on mixed device types {types}")


def halo_exchange_plain(sends: Sequence[torch.Tensor], *,
                        n_devices: int) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`halo_exchange` (same contract):
    per receiving shard s, the stack of every shard's block s."""
    _check(sends, n_devices)
    return [torch.stack([sends[d][s].to(sends[s].device)
                         for d in range(n_devices)])
            for s in range(n_devices)]


def _kernel_fns():
    lib = _build.load("remote_fetch")
    fn, peer = lib.halo_exchange, lib.halo_enable_peer
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        peer.argtypes = [ctypes.c_int]
        peer.restype = ctypes.c_int
    return fn, peer


def _peer_devices(devs: List[torch.device]) -> List[int]:
    """The other cards the launching card (``devs[0]``) reads and writes;
    raises unless every pair of the mesh's cards has peer access."""
    idx = sorted({d.index for d in devs})
    for a in idx:
        for b in idx:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise DeviceError(
                    f"halo_exchange: cuda:{a} has no peer access to "
                    f"cuda:{b}; the kernel reaches other cards' shards "
                    "through peer pointers")
    return [i for i in idx if i != devs[0].index]


def halo_exchange(sends: Sequence[torch.Tensor], *,
                  n_devices: int) -> List[torch.Tensor]:
    """All-to-all of ``sends`` (D int32 ``[D, vr, 128]`` tensors, block d
    of tensor s = shard s's payload for shard d); returns D tensors of the
    same shape, slot s of tensor d = the block shard s sent to shard d.
    Equals ``lax.all_to_all(send, axis, 0, 0)`` on every shard.

    CUDA tensors (contiguous, 16-byte aligned, D <= 64) go through one
    launch of the kernel on the first shard's card and current stream,
    which adds one to ``halo_exchange.launches``; CPU tensors take
    :func:`halo_exchange_plain`.  Shards on several cards need peer
    access between all of them, and the call then waits for every card
    before and after the launch."""
    _check(sends, n_devices)
    if sends[0].device.type == "cpu":
        return halo_exchange_plain(sends, n_devices=n_devices)
    if sends[0].device.type != "cuda":
        raise DeviceError(f"halo_exchange has no kernel for "
                          f"{sends[0].device.type} tensors")
    if n_devices > MAX_SHARDS:
        raise ValueError(f"halo_exchange takes at most {MAX_SHARDS} shards, "
                         f"not {n_devices}")
    for s in sends:
        if not s.is_contiguous() or s.data_ptr() % 16:
            raise ValueError("halo_exchange needs contiguous, 16-byte "
                             "aligned send tensors")
    devs = [s.device for s in sends]
    if len(set(devs)) == 1:
        # one allocation for every shard's receive tensor (each a
        # contiguous view, its blocks 512-byte multiples)
        recvs = list(torch.empty((n_devices,) + tuple(sends[0].shape),
                                 dtype=torch.int32, device=devs[0]).unbind(0))
    else:
        recvs = [torch.empty_like(s) for s in sends]
    fn, enable_peer = _kernel_fns()
    peers = _peer_devices(devs)
    with torch.cuda.device(devs[0]):
        for p in peers:
            rc = enable_peer(p)
            if rc != 0:
                raise DeviceError(f"halo_exchange: enabling peer access to "
                                  f"cuda:{p} failed: CUDA error {rc}")
            torch.cuda.synchronize(p)      # the peers' sends are written
        vp = ctypes.c_void_p * n_devices
        send_p = vp(*[s.data_ptr() for s in sends])
        recv_p = vp(*[r.data_ptr() for r in recvs])
        block_words = sends[0][0].numel()
        rc = fn(send_p, recv_p, n_devices, block_words,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise DeviceError(f"halo_exchange launch failed: CUDA error "
                              f"{rc} (D={n_devices}, block of "
                              f"{block_words} words)")
        if peers:
            torch.cuda.synchronize(devs[0])   # the peers read their recvs
    halo_exchange.launches += 1
    return recvs


halo_exchange.launches = 0


def exchange_planes(planes: Sequence[Sequence[torch.Tensor]], *,
                    n_devices: int) -> List[List[torch.Tensor]]:
    """Exchange several int32 ``[D, cap]`` word planes of every shard in
    one :func:`halo_exchange`: ``planes[s]`` are shard s's planes (the
    same count and shape on every shard), packed side by side into the
    ``[D, P * vr1, 128]`` transport layout of the JAX package (each plane
    padded to ``vr1 = ceil(cap / 128)`` rows).  Returns, per shard, the
    received planes, each ``[D, cap]`` (row d: what shard d sent)."""
    D = n_devices
    P = len(planes[0])
    cap = planes[0][0].shape[1]
    vr1 = -(-cap // 128)
    sends = []
    for ps in planes:
        buf = torch.zeros((D, P, vr1 * 128), dtype=torch.int32,
                          device=ps[0].device)
        for i, p in enumerate(ps):
            buf[:, i, :cap] = p
        sends.append(buf.view(D, P * vr1, 128))
    recvs = halo_exchange(sends, n_devices=D)
    return [[r.view(D, P, vr1 * 128)[:, i, :cap] for i in range(P)]
            for r in recvs]
