"""Error types of the PyTorch port (the subset of ``petastorm_tpu.errors`` the
port raises; names and attributes are the same)."""

from __future__ import annotations

from typing import Optional


class PetastormTpuError(Exception):
    """Base class for all framework errors."""


class NoDataAvailableError(PetastormTpuError):
    """Raised when a shard of the dataset contains no rowgroups."""


class DecodeFieldError(PetastormTpuError):
    """Raised when a codec fails to decode a field value.

    ``field_name`` is the Unischema field that failed to decode (None if
    unknown); ``fragment_path`` the Parquet fragment being read when it
    failed (None outside a rowgroup read)."""

    def __init__(self, message: str, field_name: Optional[str] = None,
                 fragment_path: Optional[str] = None) -> None:
        super().__init__(message)
        self.field_name = field_name
        self.fragment_path = fragment_path


class MetadataError(PetastormTpuError):
    """Raised when dataset metadata (schema / rowgroup index) is missing or
    unreadable."""


class CacheCorruptionError(PetastormTpuError):
    """A disk-cache entry failed its integrity check (footer missing, length
    or CRC mismatch). Never propagates out of the cache: ``get`` deletes the
    entry and serves the fill function."""
