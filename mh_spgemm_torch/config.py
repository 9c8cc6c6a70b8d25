"""Configuration of the PyTorch port.

``SpGEMMConfig`` keeps the JAX package's field names and defaults, so a
config written for one package reads the same in the other.  This slice
runs only the bucketed engine with precomputed slot arrays;
:func:`check_supported` resolves every setting to what the port can run
and raises on settings whose kernels or engines are not ported yet,
naming the ROADMAP item that ports them.
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

_MODE_ITEMS = {
    "auto": "ROADMAP Queue 1 item 8 (block-dense engine and auto routing)",
    "blockdense": "ROADMAP Queue 1 item 8 (block-dense engine and auto "
                  "routing)",
    "masked": "ROADMAP Queue 1 item 9 (masked and ESC engines)",
    "esc": "ROADMAP Queue 1 item 9 (masked and ESC engines)",
}
# settings whose "auto" resolves to off because their kernel is not ported
_KERNEL_ITEMS = {
    "dma_fill": "ROADMAP Queue 2 item 3 (ragged_fill, the fill frontend)",
    "planned": "ROADMAP Queue 2 items 4-5 (pgather and proute, the planned "
               "frontend)",
    "ozaki": "ROADMAP Queue 2 item 7 (pair_matmul_f64_ozaki, block-dense "
             "f64)",
}
# TPU-only transport devices: the card has native f64 and cheap gathers
_TPU_ONLY = ("df32", "wide_gather", "group_gather")


def check_supported(config: SpGEMMConfig) -> str:
    """Validate ``config`` for this slice and return the resolved tail
    route: ``"kernel"`` (esc_tail_flat for pow2 classes, the default) or
    ``"sort"`` (the sort tail in torch ops, ``esc_tail="off"``).  Raises
    ``NotImplementedError`` naming the ROADMAP item for settings the
    port does not run yet."""
    config.vdtype                               # validates value_dtype
    if config.mode != "bucketed":
        if config.mode in _MODE_ITEMS:
            raise NotImplementedError(
                f"mode={config.mode!r} is not ported yet: "
                f"{_MODE_ITEMS[config.mode]}")
        raise ValueError(f"unknown mode {config.mode!r}")
    for name, item in _KERNEL_ITEMS.items():
        v = getattr(config, name)
        if v in ("on", "interpret"):
            raise NotImplementedError(
                f"{name}={v!r}: its kernel is not ported yet: {item}")
        if v not in ("auto", "off"):
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
    if config.comm_backend != "xla":
        raise NotImplementedError(
            f"comm_backend={config.comm_backend!r}: ROADMAP Queue 1 item 10 "
            "(distributed layer, halo_exchange)")
    if config.esc_tail in ("auto", "on", "pow2"):
        return "kernel"
    if config.esc_tail == "off":
        return "sort"
    if config.esc_tail == "interpret":
        raise NotImplementedError(
            "esc_tail='interpret' is the Pallas interpreter of the JAX "
            "package; in the port CPU tensors take the plain version")
    raise ValueError(f"unknown esc_tail setting {config.esc_tail!r}")
