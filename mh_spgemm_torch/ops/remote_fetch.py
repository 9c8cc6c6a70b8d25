"""Halo exchange: the all_to_all of the ragged B fetch — the port of
``mh_spgemm_tpu/ops/remote_fetch.py`` (``halo_exchange`` :67,
``exchange_planes`` :88).

Each shard of a mesh holds an int32 ``[D, vr, 128]`` tensor whose block d
is its payload for shard d; after the exchange shard s holds, in slot d,
the block shard d sent it.  A single-process mesh runs every shard in
one process, so one call moves every shard's blocks:
:func:`halo_exchange` takes the D send tensors and returns the D receive
tensors.  CUDA tensors go through one launch of the kernel
``csrc/remote_fetch.cu`` (shards on one card, or on several cards that
all have peer access to each other; otherwise it raises); CPU tensors take
:func:`halo_exchange_plain`.  A process of a multi-process mesh
(``parallel/comm.py``) passes the other processes' send tensors as CUDA
IPC views and receives only its own shards (``dst_first``,
``dst_count``).  The TPU kernel's DMA semaphores and double
buffer have no counterpart: each payload is read once and written once.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

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


def _subset(n_devices: int, dst_first: int,
            dst_count: Optional[int]) -> Tuple[int, int]:
    """The receiving shards' range, ``(0, D)`` by default."""
    count = n_devices - dst_first if dst_count is None else dst_count
    if dst_first < 0 or count < 1 or dst_first + count > n_devices:
        raise ValueError(f"receiving shards [{dst_first}, "
                         f"{dst_first + count}) are not a range of the "
                         f"{n_devices} shards")
    return dst_first, count


def halo_exchange_plain(sends: Sequence[torch.Tensor], *, n_devices: int,
                        dst_first: int = 0,
                        dst_count: Optional[int] = None
                        ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`halo_exchange` (same contract):
    per receiving shard s, the stack of every shard's block s."""
    _check(sends, n_devices)
    first, count = _subset(n_devices, dst_first, dst_count)
    return [torch.stack([sends[d][s].to(sends[s].device)
                         for d in range(n_devices)])
            for s in range(first, first + count)]


def _kernel_fns():
    lib = _build.load("remote_fetch")
    fn, peer = lib.halo_exchange, lib.halo_enable_peer
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
        peer.argtypes = [ctypes.c_int]
        peer.restype = ctypes.c_int
    return fn, peer


def _peer_devices(devs: List[torch.device]) -> List[int]:
    """The other cards the launching card (``devs[0]``) reads and writes;
    raises unless every pair of the mesh's cards has peer access.  Memory
    of another process on the same card (a CUDA IPC pointer) has that
    card's index and needs no peer access."""
    idx = sorted({d.index for d in devs})
    for a in idx:
        for b in idx:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise DeviceError(
                    f"halo_exchange: cuda:{a} has no peer access to "
                    f"cuda:{b}; the kernel reaches other cards' shards "
                    "through peer pointers")
    return [i for i in idx if i != devs[0].index]


def _aligned(tensors: Sequence[torch.Tensor], what: str) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"halo_exchange needs contiguous, 16-byte "
                             f"aligned {what} tensors")


def halo_exchange(sends: Sequence[torch.Tensor], *, n_devices: int,
                  dst_first: int = 0, dst_count: Optional[int] = None,
                  out: Optional[Sequence[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """All-to-all of ``sends`` (D int32 ``[D, vr, 128]`` tensors, block d
    of tensor s = shard s's payload for shard d) into the receiving shards
    ``dst_first .. dst_first + dst_count - 1`` (default: all D); returns
    one tensor of the same shape per receiving shard, slot s of shard d's
    = the block shard s sent to shard d.  With every shard receiving it
    equals ``lax.all_to_all(send, axis, 0, 0)`` on every shard.  ``out``
    (CUDA only: one tensor per receiving shard, of the send shape) takes
    the result in place of new tensors.

    CUDA tensors (contiguous, 16-byte aligned, D <= 64) go through one
    launch of the kernel on the first receiving shard's card and current
    stream, which adds one to ``halo_exchange.launches``; CPU tensors take
    :func:`halo_exchange_plain`.  A process of a multi-process mesh passes
    the other processes' send tensors as CUDA IPC views and its own
    shards' range.  Shards on several cards need peer access between all
    of them, and the call then waits for every card before and after the
    launch."""
    _check(sends, n_devices)
    first, count = _subset(n_devices, dst_first, dst_count)
    if sends[0].device.type == "cpu":
        if out is not None:
            raise ValueError("halo_exchange takes out= for CUDA tensors "
                             "only")
        return halo_exchange_plain(sends, n_devices=n_devices,
                                   dst_first=first, dst_count=count)
    if sends[0].device.type != "cuda":
        raise DeviceError(f"halo_exchange has no kernel for "
                          f"{sends[0].device.type} tensors")
    if n_devices > MAX_SHARDS:
        raise ValueError(f"halo_exchange takes at most {MAX_SHARDS} shards, "
                         f"not {n_devices}")
    _aligned(sends, "send")
    if out is not None:
        recvs = list(out)
        if len(recvs) != count or any(
                r.shape != sends[0].shape or r.dtype != torch.int32
                or r.device.type != "cuda" for r in recvs):
            raise ValueError(f"out must be {count} int32 CUDA tensors of "
                             f"the send shape {tuple(sends[0].shape)}")
        _aligned(recvs, "receive")
    elif len({s.device for s in sends}) == 1:
        # one allocation for every receiving shard's tensor (each a
        # contiguous view, its blocks 512-byte multiples)
        recvs = list(torch.empty((count,) + tuple(sends[0].shape),
                                 dtype=torch.int32,
                                 device=sends[0].device).unbind(0))
    else:
        recvs = [torch.empty_like(sends[d])
                 for d in range(first, first + count)]
    fn, enable_peer = _kernel_fns()
    devs = [recvs[0].device] + [t.device for t in list(sends) + recvs]
    peers = _peer_devices(devs)
    with torch.cuda.device(devs[0]):
        for p in peers:
            rc = enable_peer(p)
            if rc != 0:
                raise DeviceError(f"halo_exchange: enabling peer access to "
                                  f"cuda:{p} failed: CUDA error {rc}")
            torch.cuda.synchronize(p)      # the peers' sends are written
        send_p = (ctypes.c_void_p * n_devices)(
            *[s.data_ptr() for s in sends])
        recv_p = (ctypes.c_void_p * count)(*[r.data_ptr() for r in recvs])
        block_words = sends[0][0].numel()
        rc = fn(send_p, recv_p, n_devices, block_words, first, count,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise DeviceError(f"halo_exchange launch failed: CUDA error "
                              f"{rc} (D={n_devices}, block of "
                              f"{block_words} words, receiving shards "
                              f"{first}..{first + count - 1})")
        if peers:
            torch.cuda.synchronize(devs[0])   # the peers read their recvs
    halo_exchange.launches += 1
    return recvs


halo_exchange.launches = 0


def exchange_planes(planes: Sequence[Optional[Sequence[torch.Tensor]]], *,
                    n_devices: int, exchange: Optional[Callable] = None
                    ) -> List[Optional[List[torch.Tensor]]]:
    """Exchange several int32 ``[D, cap]`` word planes of every shard in
    one :func:`halo_exchange`: ``planes[s]`` are shard s's planes (the
    same count and shape on every shard), packed side by side into the
    ``[D, P * vr1, 128]`` transport layout of the JAX package (each plane
    padded to ``vr1 = ceil(cap / 128)`` rows).  Returns, per shard, the
    received planes, each ``[D, cap]`` (row d: what shard d sent).

    ``exchange`` (default: :func:`halo_exchange` over all D shards) takes
    the D packed send tensors and returns the D receive tensors; a
    multi-process mesh passes its own (``parallel/comm.Exchange``), with
    None in place of the shards other processes own, on both sides."""
    D = n_devices
    ref = next(ps for ps in planes if ps is not None)
    P = len(ref)
    cap = ref[0].shape[1]
    vr1 = -(-cap // 128)
    sends = []
    for ps in planes:
        if ps is None:
            sends.append(None)
            continue
        buf = torch.zeros((D, P, vr1 * 128), dtype=torch.int32,
                          device=ps[0].device)
        for i, p in enumerate(ps):
            buf[:, i, :cap] = p
        sends.append(buf.view(D, P * vr1, 128))
    recvs = (exchange(sends) if exchange is not None
             else halo_exchange(sends, n_devices=D))
    return [None if r is None else
            [r.view(D, P, vr1 * 128)[:, i, :cap] for i in range(P)]
            for r in recvs]
