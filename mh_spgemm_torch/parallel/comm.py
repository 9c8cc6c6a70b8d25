"""Collectives of the distributed SpGEMM over the processes of a mesh —
the port's counterpart of what ``shard_map`` and
``multihost_utils.process_allgather`` do for the JAX package across
processes.

``spgemm_dist`` plans every shard in every process (the planners are
deterministic numpy, as in the JAX package), then each process uploads
and runs only the shards it owns (``Mesh.is_local``).  A list over the
mesh's D shards holds a process's own shards' tensors and None in place
of the others'.  The collectives take those lists and return the local
shards' results:

* **One process** (every shard local): plain torch copies, as before
  (:class:`Gather`'s concatenations, :func:`all_to_all`), or one launch
  of the ``halo_exchange`` kernel over all D shards.
* **CPU shards of several processes**: gloo's ``all_gather`` and
  ``all_to_all_single``.
* **CUDA shards of several processes**: the payload moves through CUDA
  IPC and never through the host.  Each buffer a peer reads is exported
  once (torch's ``reduce_tensor``), its handle goes to the peers with
  ``all_gather_object``, and they open it (``rebuild_cuda_tensor``); a
  process's own shards use their tensors directly.  An
  :class:`Exchange` keeps persistent send and receive buffers, made at
  its first (the cold) call and reused by every warm call, and runs: write
  the local sends; synchronise the stream; barrier; every process pulls
  into its own receive buffers (one ``halo_exchange`` launch with the
  peers' IPC pointers in its table, over the local shards' range, or
  torch copies out of views of the peers' buffers); synchronise; barrier,
  so that no process overwrites a send while a peer still reads it.  A
  :class:`Gather` reads blocks that never change after the upload (B's
  row blocks), so it needs no barrier after its set-up.

gloo carries only barriers, IPC handles, plan digests and the host
pieces of C.  IPC needs the caching allocator's ordinary segments
(``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` raises
``DeviceError``) and, for memory on another card, peer access.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..errors import DeviceError, SpGEMMError
from ..ops import remote_fetch
from .mesh import Mesh, process_count

# the exchanges' barriers (count, seconds), their stream syncs and the
# gathers of C's host pieces (seconds) in this process; a caller reads
# them around the calls it times
stats = {"barriers": 0, "barrier_s": 0.0, "sync_s": 0.0, "gather_s": 0.0}


def reset_stats() -> None:
    stats.update(barriers=0, barrier_s=0.0, sync_s=0.0, gather_s=0.0)


def spans_processes(mesh: Mesh) -> bool:
    return len(set(mesh.process_index)) > 1


def local_shards(mesh: Mesh) -> List[int]:
    return [d for d in range(mesh.size) if mesh.is_local(d)]


def _ipc(mesh: Mesh) -> bool:
    """Whether ``mesh`` crosses processes on CUDA shards (by IPC)."""
    return (spans_processes(mesh)
            and mesh.devices[local_shards(mesh)[0]].type == "cuda")


def barrier() -> None:
    t0 = time.perf_counter()
    dist.barrier()
    stats["barriers"] += 1
    stats["barrier_s"] += time.perf_counter() - t0


def all_gather_object(obj) -> list:
    """``obj`` of every process, by rank (gloo)."""
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_local(mesh: Mesh, local: Dict[int, object]) -> Dict[int, object]:
    """``{shard: host object}`` of every process's shards, merged: the
    counterpart of ``process_allgather`` for host pieces."""
    if not spans_processes(mesh):
        return local
    t0 = time.perf_counter()
    merged = {}
    for part in all_gather_object(local):
        merged.update(part)
    stats["gather_s"] += time.perf_counter() - t0
    return merged


def digest(*objs) -> str:
    """Hash of the numpy arrays and scalars in ``objs`` (dataclasses,
    dicts, lists and tuples walked; torch tensors and devices, which
    hold uploads, skipped)."""
    h = hashlib.blake2b(digest_size=16)

    def walk(x) -> None:
        if isinstance(x, (torch.Tensor, torch.device)):
            return
        if isinstance(x, np.ndarray):
            h.update(f"{x.dtype.str}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).view(np.uint8).reshape(-1))
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                h.update(f.name.encode())
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for k in sorted(x, key=repr):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(f"{type(x).__name__}{len(x)}".encode())
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())

    for o in objs:
        walk(o)
    return h.hexdigest()


def check_same(mesh: Mesh, what: str, *objs) -> None:
    """Raise ``SpGEMMError`` unless every process of ``mesh`` planned the
    same ``objs`` (compared by :func:`digest`), so that divergent
    planning cannot give a silently wrong C."""
    if not spans_processes(mesh):
        return
    every = all_gather_object(digest(*objs))
    if len(set(every)) > 1:
        raise SpGEMMError(
            f"the processes planned different {what} (digests {every}, "
            "rank by rank): every process must call spgemm_dist with the "
            "same A, B, config and environment")


def put(x: np.ndarray, mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """Block d of ``x`` (stacked over shards) on shard d's device, for the
    local shards."""
    return [torch.from_numpy(np.ascontiguousarray(x[d])).to(dev)
            if mesh.is_local(d) else None
            for d, dev in enumerate(mesh.devices)]


def replicate(x: np.ndarray, mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """``x`` on every local shard's device (one copy per distinct
    device)."""
    per = {}
    out = []
    for d, dev in enumerate(mesh.devices):
        if not mesh.is_local(d):
            out.append(None)
            continue
        if dev not in per:
            per[dev] = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        out.append(per[dev])
    return out


def all_to_all(sends: List[torch.Tensor], devs) -> List[torch.Tensor]:
    """One process's ``comm_backend="xla"`` exchange, the counterpart of
    XLA's ``all_to_all(x, axis, 0, 0)``: shard s receives, in row d, row s
    of shard d's send tensor.  Plain torch copies (one stack and
    transpose where every shard shares a device); ``ops/remote_fetch``
    holds the hand-written kernel."""
    D = len(sends)
    if len(set(devs)) == 1:
        out = torch.stack(sends).transpose(0, 1).contiguous()
        return [out[s] for s in range(D)]
    return [torch.stack([sends[d][s].to(devs[s]) for d in range(D)])
            for s in range(D)]


# ---------------------------------------------------------------------------
# CUDA IPC
# ---------------------------------------------------------------------------

def _check_ipc() -> None:
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        conf = os.environ.get(var, "").replace(" ", "").lower()
        if "expandable_segments:true" in conf:
            raise DeviceError(
                f"{var} asks for expandable_segments: the exchange between "
                "processes shares buffers by CUDA IPC, which needs the "
                "caching allocator's ordinary segments")


def _export(t: torch.Tensor):
    from torch.multiprocessing.reductions import reduce_tensor
    try:
        return reduce_tensor(t)[1]
    except RuntimeError as e:
        raise DeviceError(f"cannot export a CUDA IPC handle for a "
                          f"{tuple(t.shape)} {t.dtype} buffer: {e}") from e


def _open(args) -> torch.Tensor:
    from torch.multiprocessing.reductions import rebuild_cuda_tensor
    try:
        return rebuild_cuda_tensor(*args)
    except RuntimeError as e:
        raise DeviceError(f"cannot open a peer's CUDA IPC handle: {e}") from e


def _share(mesh: Mesh, local: Dict[int, Tuple[torch.Tensor, ...]]
           ) -> List[Tuple[torch.Tensor, ...]]:
    """Every shard's tensors: the local ones as they are, the other
    processes' opened from their IPC handles.  Raises ``DeviceError``
    where a peer's memory lies on a card this one has no peer access
    to."""
    _check_ipc()
    for dev in {t.device for ts in local.values() for t in ts}:
        torch.cuda.current_stream(dev).synchronize()   # written, then shared
    handles = {d: tuple(_export(t) for t in ts) for d, ts in local.items()}
    every = {}
    for part in all_gather_object(handles):
        every.update(part)
    views = [local[d] if d in local else tuple(_open(h) for h in every[d])
             for d in range(mesh.size)]
    remote_fetch._peer_devices([v.device for vs in views for v in vs])
    return views


def _sync(devs) -> None:
    t0 = time.perf_counter()
    for dev in devs:
        torch.cuda.current_stream(dev).synchronize()
    stats["sync_s"] += time.perf_counter() - t0


class Exchange:
    """All-to-all of per-destination blocks: shard s's send is a tuple of
    parts, each ``[D, ...]`` with row d for shard d; a local shard d
    receives, per part, ``[D, ...]`` with row s from shard s.  ``kernel``
    runs the pull through the ``halo_exchange`` kernel (one int32
    ``[D, vr, 128]`` part) instead of torch copies.  Returns the local
    shards' receive tuples (None for the others); on a multi-process CUDA
    mesh they are this exchange's persistent buffers, rewritten by its
    next call."""

    def __init__(self, mesh: Mesh, kernel: bool = False):
        self.mesh = mesh
        self.kernel = kernel
        self.send = self.recv = self.views = None

    def __call__(self, sends: Sequence[Optional[Tuple[torch.Tensor, ...]]]
                 ) -> List[Optional[Tuple[torch.Tensor, ...]]]:
        mesh = self.mesh
        D = mesh.size
        if not spans_processes(mesh):
            if self.kernel:
                return [(r,) for r in remote_fetch.halo_exchange(
                    [s[0] for s in sends], n_devices=D)]
            devs = list(mesh.devices)
            parts = [all_to_all([s[k] for s in sends], devs)
                     for k in range(len(sends[0]))]
            return [tuple(p[d] for p in parts) for d in range(D)]
        loc = local_shards(mesh)
        if not _ipc(mesh):
            return self._gloo(sends, loc)
        if self.send is None:
            self.send = {d: tuple(torch.empty_like(t) for t in sends[d])
                         for d in loc}
            self.recv = {d: tuple(torch.empty_like(t) for t in sends[d])
                         for d in loc}
            self.views = _share(mesh, self.send)
        for d in loc:
            for buf, t in zip(self.send[d], sends[d]):
                buf.copy_(t)
        devs = {mesh.devices[d] for d in loc}
        _sync(devs)
        barrier()
        if self.kernel:
            if loc != list(range(loc[0], loc[0] + len(loc))):
                raise ValueError(f"the kernel pulls into a range of shards, "
                                 f"not {loc}")
            remote_fetch.halo_exchange(
                [v[0] for v in self.views], n_devices=D, dst_first=loc[0],
                dst_count=len(loc), out=[self.recv[d][0] for d in loc])
        else:
            for d in loc:
                for k, out in enumerate(self.recv[d]):
                    torch.stack([v[k][d] for v in self.views], out=out)
        _sync(devs)
        barrier()
        return [self.recv.get(d) for d in range(D)]

    def planes(self, sends: Sequence[Optional[torch.Tensor]]
               ) -> List[Optional[torch.Tensor]]:
        """The exchange of one tensor a shard (``remote_fetch``'s
        ``exchange_planes`` takes this)."""
        out = self([None if s is None else (s,) for s in sends])
        return [None if r is None else r[0] for r in out]

    def _gloo(self, sends, loc) -> List[Optional[Tuple[torch.Tensor, ...]]]:
        """CPU shards: per part, one ``all_to_all_single`` of
        ``[processes, local src, local dst, ...]``."""
        D, n = self.mesh.size, len(loc)
        world = D // n
        parts = []
        for k in range(len(sends[loc[0]])):
            x = torch.stack([sends[d][k] for d in loc])      # [n, D, ...]
            blk = tuple(x.shape[2:])
            x = x.reshape((n, world, n) + blk).transpose(0, 1).contiguous()
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            parts.append(y)                          # [world, n src, n dst]
        out = [None] * D
        for j, d in enumerate(loc):
            out[d] = tuple(y[:, :, j].reshape((D,) + tuple(y.shape[3:]))
                           for y in parts)
        return out


class Gather:
    """Every shard's static blocks (tuples of parts, never written after
    the upload), concatenated per part on each local shard's device: all
    D shards' blocks, or for shard d those of the shards in
    ``groups[d]`` (the 2-D grid's column group).  One concatenation per
    distinct (device, group).  Returns the local shards' tuples (None for
    the others)."""

    def __init__(self, mesh: Mesh,
                 blocks: Sequence[Optional[Tuple[torch.Tensor, ...]]],
                 groups: Optional[Sequence[Sequence[int]]] = None):
        self.mesh = mesh
        self.blocks = list(blocks)
        self.groups = ([tuple(g) for g in groups] if groups is not None
                       else [tuple(range(mesh.size))] * mesh.size)
        self.views = None
        if _ipc(mesh):
            self.views = _share(mesh, {d: self.blocks[d]
                                       for d in local_shards(mesh)})

    def __call__(self) -> List[Optional[Tuple[torch.Tensor, ...]]]:
        mesh = self.mesh
        loc = local_shards(mesh)
        src = self.blocks if self.views is None else self.views
        if spans_processes(mesh) and self.views is None:    # CPU: gloo
            src = [None] * mesh.size
            n = len(loc)
            for k in range(len(self.blocks[loc[0]])):
                x = torch.stack([self.blocks[d][k] for d in loc])
                got = [torch.empty_like(x) for _ in range(mesh.size // n)]
                dist.all_gather(got, x)
                for d, b in enumerate(torch.cat(got).unbind(0)):
                    src[d] = (src[d] or ()) + (b,)
        per = {}
        out = [None] * mesh.size
        for d in loc:
            dev, group = mesh.devices[d], self.groups[d]
            if (dev, group) not in per:
                per[(dev, group)] = tuple(
                    torch.cat([src[s][k].to(dev) for s in group])
                    for k in range(len(src[group[0]])))
            out[d] = per[(dev, group)]
        return out
