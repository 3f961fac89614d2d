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


class TransientIOError(PetastormTpuError, OSError):
    """An IO failure that is expected to succeed on retry (connection reset,
    throttled store). Subclasses ``OSError``, so the default transient
    classifier of :mod:`petastorm_tpu_torch.resilience` retries it like any
    errno failure; raise it from a custom filesystem to opt an error into the
    retry path."""


class WorkerHangError(PetastormTpuError):
    """A pool worker held an item past ``item_deadline_s`` without a result
    and the watchdog reaped it. Under ``on_error='skip'`` the item is
    quarantined with ``reason='hang'`` instead; this type names that failure
    where a strict consumer turns ledger entries back into exceptions."""


class QuarantinedRowGroupError(PetastormTpuError):
    """A rowgroup exhausted its error budget under ``on_error='skip'`` and was
    left out of the stream. Raised only by
    :meth:`~petastorm_tpu_torch.resilience.QuarantineLedger.raise_if_any`
    (strict post-epoch validation), with the first record's ``piece_index``,
    ``fragment_path``, ``row_group_id`` and ``attempts``; ``cause`` is the
    final underlying exception, when there is one."""

    def __init__(self, message: str, piece_index: Optional[int] = None,
                 fragment_path: Optional[str] = None,
                 row_group_id: Optional[int] = None,
                 attempts: Optional[int] = None,
                 cause: Optional[BaseException] = None) -> None:
        super().__init__(message)
        self.piece_index = piece_index
        self.fragment_path = fragment_path
        self.row_group_id = row_group_id
        self.attempts = attempts
        self.cause = cause
