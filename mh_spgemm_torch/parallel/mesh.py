"""Meshes of shards for the distributed SpGEMM — the port of
``mh_spgemm_tpu/parallel/mesh.py``.

A mesh is a list of D shards, each with the torch device its tensors live
on and the process that owns it, and one or two named axes: ``rows`` (A
and C are row-partitioned over it) and, for the 2-D grid, ``cols`` (B's
column blocks).  Devices may repeat: D may exceed the number of cards,
and the shards are then placed round-robin, so eight shards run on one
H100 as eight virtual devices, the counterpart of the JAX package's
virtual CPU devices.  ``spgemm_dist`` runs a process's shards' stages one
after another (bulk-synchronous, what ``shard_map`` amounts to on a
virtual mesh), with the collectives between stages.

After :func:`init_multihost` a mesh spans the job's processes: each
process contributes its shards, laid out rank-major, and runs only those;
the collectives cross processes (``parallel/comm.py``: gloo for
rendezvous, barriers and host pieces, CUDA IPC for the device payload).
Several processes may share one card.  Meshes over several cards or
hosts have not run (ROADMAP Queue 1 item 3, multi-card and multi-host).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..errors import DeviceError

ROWS = "rows"
COLS = "cols"
# how long a collective waits for a peer before the call fails
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def process_rank() -> int:
    """This process's rank in the job (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The job's process count (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join a multi-process job: a gloo process group over
    ``tcp://coordinator_address`` ("host:port"; default
    ``MASTER_ADDR:MASTER_PORT``) of ``num_processes`` (default
    ``WORLD_SIZE``) processes, this one ``process_id`` (default
    ``RANK``).  After this, :func:`make_row_mesh` and
    :func:`make_grid_mesh` lay their shards over every process, and
    ``spgemm_dist`` runs each process's own.  A collective that waits on
    a peer longer than ``timeout`` raises instead of hanging.

    No-op when a process group already exists or the job is
    single-process (every argument None and no ``RANK`` or
    ``WORLD_SIZE`` in the environment), as the JAX package's is."""
    if dist.is_initialized():
        return
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None and "RANK" not in env
            and "WORLD_SIZE" not in env):
        return
    addr = coordinator_address or (f"{env.get('MASTER_ADDR', 'localhost')}:"
                                   f"{env['MASTER_PORT']}")
    world = num_processes if num_processes is not None else int(
        env["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(env["RANK"])
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank, timeout=timeout)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` and their sizes (``shape``, by name); ``devices``
    holds one torch device per shard, row-major over the axes (shard
    ``r * dc + c`` of a grid); ``process_index`` the rank of the process
    that owns each shard (all 0 in a single-process job).  A device names
    a card as its owner sees it."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    process_index: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.process_index is None:
            object.__setattr__(self, "process_index",
                               (0,) * len(self.devices))
        if len(self.process_index) != len(self.devices):
            raise ValueError("a mesh needs one process index per shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    def is_local(self, d: int) -> bool:
        """Whether this process owns shard ``d``."""
        return self.process_index[d] == process_rank()


def _devices(n: int, devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    """``n`` shard devices, round-robin over ``devices`` (default: the
    visible CUDA devices; raises where there is none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device is available; pass devices=['cpu'] to run "
                "the shards on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return tuple(devs[i % len(devs)] for i in range(n))


def _spanning(n: Optional[int], devices: Optional[Sequence]
              ) -> Tuple[Tuple[torch.device, ...], Tuple[int, ...]]:
    """The shards of a multi-process job, rank-major: ``n`` in all
    (default: one per local device of every process), each process's
    share round-robin over its ``devices`` (default: its card,
    ``cuda:{rank % device_count()}``).  Every process must ask for the
    same count."""
    rank, world = process_rank(), process_count()
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device is available; pass devices=['cpu'] to run "
                "the shards on the CPU")
        devices = [f"cuda:{rank % torch.cuda.device_count()}"]
    if n is not None and n % world:
        raise ValueError(f"{n} shards do not divide over {world} processes")
    n_local = n // world if n is not None else len(devices)
    mine = [str(d) for d in _devices(n_local, devices)]
    every = [None] * world
    dist.all_gather_object(every, mine)
    counts = [len(e) for e in every]
    if len(set(counts)) != 1:
        raise ValueError(f"the processes ask for different shard counts: "
                         f"{counts} (rank by rank)")
    return (tuple(torch.device(d) for e in every for d in e),
            tuple(r for r in range(world) for _ in range(counts[r])))


def make_row_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh of ``n_devices`` shards (default: one per device), axis
    ``rows``.  In a multi-process job ``n_devices`` counts the shards of
    every process and ``devices`` are this process's own."""
    if process_count() > 1:
        devs, owner = _spanning(n_devices, devices)
        return Mesh(axis_names=(ROWS,), shape={ROWS: len(devs)},
                    devices=devs, process_index=owner)
    n = n_devices if n_devices is not None else (
        len(devices) if devices is not None
        else max(1, torch.cuda.device_count()))
    devs = _devices(n, devices)
    return Mesh(axis_names=(ROWS,), shape={ROWS: n}, devices=devs)


def make_grid_mesh(dr: int, dc: int,
                   devices: Optional[Sequence] = None) -> Mesh:
    """2-D (rows x cols) mesh of ``dr * dc`` shards for the
    block-partitioned strategy: C's rows shard over ``rows``, B's columns
    over ``cols``.  In a multi-process job the ``dr * dc`` shards divide
    over the processes, rank-major, and ``devices`` are this process's."""
    if process_count() > 1:
        devs, owner = _spanning(dr * dc, devices)
        return Mesh(axis_names=(ROWS, COLS), shape={ROWS: dr, COLS: dc},
                    devices=devs, process_index=owner)
    devs = _devices(dr * dc, devices)
    return Mesh(axis_names=(ROWS, COLS), shape={ROWS: dr, COLS: dc},
                devices=devs)
