"""Configuration of the PyTorch port.

``SpGEMMConfig`` keeps the JAX package's field names and defaults, so a
config written for one package reads the same in the other.  The port
runs the bucketed engine (precomputed-slot, planned, fill and gather
frontends), the block-dense engine, ``mode="auto"`` choosing between
them, the class-based masked engine (``mode="masked"``), the fused ESC
engine (``mode="esc"``, and every mode of ``pipeline.spgemm`` on device
operands), and the distributed layer's ``comm_backend`` ("xla" or
"pallas", read by ``spgemm_dist``);
:func:`check_supported` resolves every setting to what the port can run
and raises on the JAX package's Pallas-interpreter and TPU-only
transport settings, which have no counterpart on the card.
:func:`fill_mode` and :func:`planned_mode` resolve ``dma_fill`` and
``planned`` for a device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class SpGEMMConfig:
    """Frozen pipeline configuration.  Field meanings follow
    ``mh_spgemm_tpu.config.SpGEMMConfig``; see :func:`check_supported`
    for what each resolves to in the port."""

    value_dtype: str = "float64"
    mode: str = "bucketed"
    aat: bool = False
    adaptive: bool = True
    check_result: bool = False
    # synchronise the card between the main stage and the extraction so
    # a Timing splits the two exactly
    profile: bool = False
    tolerance: float = 1e-9
    bin_bounds: Tuple[int, ...] = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                   1024, 2048, 4096)
    min_bucket_width: int = 2
    bucket_area_cap: int = 1 << 23
    masked_max_products: int = 16_000_000
    dma_fill: str = "auto"
    esc_tail: str = "auto"
    comm_backend: str = "xla"
    df32: str = "auto"
    wide_gather: str = "auto"
    group_gather: str = "auto"
    planned: str = "auto"
    ozaki: str = "auto"

    @property
    def vdtype(self) -> torch.dtype:
        if self.value_dtype not in _DTYPES:
            raise ValueError(
                f"value_dtype {self.value_dtype!r}: the port computes in "
                f"{sorted(_DTYPES)}")
        return _DTYPES[self.value_dtype]


DEFAULT_CONFIG = SpGEMMConfig()

_MODES = ("auto", "bucketed", "blockdense", "masked", "esc")
# Pallas-interpreter settings: in the port "on" forces the path on any
# device, and CPU tensors take the plain versions
_INTERPRET = ("dma_fill", "planned", "ozaki", "esc_tail")
# TPU-only transport devices: the card has native f64 and cheap gathers
_TPU_ONLY = ("df32", "wide_gather", "group_gather")


def check_supported(config: SpGEMMConfig) -> str:
    """Validate ``config`` and return the bucketed engine's resolved tail
    route: ``"kernel"`` (esc_tail_flat for pow2 classes, the default) or
    ``"sort"`` (the sort tail in torch ops, ``esc_tail="off"``).
    ``ozaki`` "auto" and "on" send block-dense f64 through the native-f64
    pair kernel, "off" through the gather + batched-matmul route.  Raises
    ``NotImplementedError`` for the Pallas-interpreter and TPU-only
    settings, ``ValueError`` for unknown ones."""
    config.vdtype                               # validates value_dtype
    if config.mode not in _MODES:
        raise ValueError(f"unknown mode {config.mode!r}")
    for name in _INTERPRET:
        v = getattr(config, name)
        if v == "interpret":
            raise NotImplementedError(
                f"{name}='interpret' is the Pallas interpreter of the JAX "
                "package; in the port 'on' forces the path on any device, "
                "and CPU tensors take the plain versions")
    for name in ("dma_fill", "planned", "ozaki"):
        v = getattr(config, name)
        if v not in ("auto", "on", "off"):
            raise ValueError(f"unknown {name} setting {v!r}")
    for name in _TPU_ONLY:
        v = getattr(config, name)
        if v == "on":
            raise NotImplementedError(
                f"{name}='on' is a TPU-only transport device that the "
                "port does not carry (ROADMAP ground rules: native f64 "
                "on the card)")
        if v not in ("auto", "off"):
            raise ValueError(f"unknown {name} setting {v!r}")
    if config.comm_backend not in ("xla", "pallas"):
        raise ValueError(f"unknown comm_backend {config.comm_backend!r}")
    if config.esc_tail in ("auto", "on", "pow2"):
        return "kernel"
    if config.esc_tail == "off":
        return "sort"
    raise ValueError(f"unknown esc_tail setting {config.esc_tail!r}")


def fill_mode(config: SpGEMMConfig, device) -> str:
    """``dma_fill`` resolved for a state prepared for ``device``: "auto"
    lets the planners' cost models pick the fill frontend and the
    windowed extraction on a CUDA device and is "off" elsewhere; "on"
    forces them on any device; "off" is off.  The JAX package gates
    "auto" on the TPU in the same places."""
    if config.dma_fill == "auto":
        return "auto" if torch.device(device).type == "cuda" else "off"
    return config.dma_fill


def planned_mode(config: SpGEMMConfig, device) -> str:
    """``planned`` resolved for a state prepared for ``device``: "auto"
    gives the planned frontend and the planned extraction on a CUDA device
    and is "off" elsewhere (the JAX package turns them on on the TPU
    whenever values travel as 32-bit words, as the port's always do);
    "on" forces them on any device; "off" is off."""
    if config.planned == "auto":
        return "on" if torch.device(device).type == "cuda" else "off"
    return config.planned
