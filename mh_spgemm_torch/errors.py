"""Error hierarchy of the PyTorch port (same names as
``mh_spgemm_tpu.errors``) plus the ``require`` guard."""

from __future__ import annotations


class SpGEMMError(Exception):
    """Base class for all mh_spgemm_torch errors."""


class MatrixFormatError(SpGEMMError):
    """Raised when an input matrix (file or arrays) is malformed."""


class ShapeMismatchError(SpGEMMError):
    """Raised when operand shapes are incompatible (A.N != B.M)."""


class VerificationError(SpGEMMError):
    """Raised when a computed C fails comparison against the oracle."""


class DeviceError(SpGEMMError):
    """Raised when a device-side computation fails (no CUDA device, a
    kernel that does not build or launch)."""


def require(cond: bool, exc_type, msg: str) -> None:
    """Raise ``exc_type(msg)`` unless ``cond``."""
    if not cond:
        raise exc_type(msg)
