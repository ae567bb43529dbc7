"""Error taxonomy (the analog of ICICLE's eIcicleError; a copy of
icicle_snark_tpu/errors.py, which the port does not import)."""

from __future__ import annotations


class IcicleSnarkError(Exception):
    """Base class for framework errors."""


class DeviceError(IcicleSnarkError):
    """Unknown/unavailable device or backend (UNKNOWN_DEVICE)."""


class InvalidArgument(IcicleSnarkError):
    """Bad op arguments (INVALID_ARGUMENT)."""


class FileFormatError(IcicleSnarkError):
    """Malformed zkey/wtns/json artifact (INVALID_POINTER-ish I/O)."""


class AllocationError(IcicleSnarkError):
    """Device OOM (ALLOCATION_FAILED / OUT_OF_MEMORY)."""
