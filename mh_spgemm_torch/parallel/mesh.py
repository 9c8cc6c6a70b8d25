"""Meshes of shards for the distributed SpGEMM — the port of
``mh_spgemm_tpu/parallel/mesh.py``.

A mesh is a single-process list of D shards, each with the torch device
its tensors live on, and one or two named axes: ``rows`` (A and C are
row-partitioned over it) and, for the 2-D grid, ``cols`` (B's column
blocks).  Devices may repeat: D may exceed the number of cards, and the
shards are then placed round-robin, so eight shards run on one H100 as
eight virtual devices, the counterpart of the JAX package's virtual CPU
devices.  ``spgemm_dist`` runs the shards' stages one after another
(bulk-synchronous, what ``shard_map`` amounts to on a virtual mesh), with
the collectives between stages.

``init_multihost`` (a multi-process runtime over several hosts) is not
ported (ROADMAP Queue 1 item 3, multi-process, multi-host and
multi-card meshes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..errors import DeviceError

ROWS = "rows"
COLS = "cols"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` and their sizes (``shape``, by name); ``devices``
    holds one torch device per shard, row-major over the axes (shard
    ``r * dc + c`` of a grid)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


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


def make_row_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh of ``n_devices`` shards (default: one per device), axis
    ``rows``."""
    n = n_devices if n_devices is not None else (
        len(devices) if devices is not None
        else max(1, torch.cuda.device_count()))
    devs = _devices(n, devices)
    return Mesh(axis_names=(ROWS,), shape={ROWS: n}, devices=devs)


def make_grid_mesh(dr: int, dc: int,
                   devices: Optional[Sequence] = None) -> Mesh:
    """2-D (rows x cols) mesh of ``dr * dc`` shards for the
    block-partitioned strategy: C's rows shard over ``rows``, B's columns
    over ``cols``."""
    devs = _devices(dr * dc, devices)
    return Mesh(axis_names=(ROWS, COLS), shape={ROWS: dr, COLS: dc},
                devices=devs)
