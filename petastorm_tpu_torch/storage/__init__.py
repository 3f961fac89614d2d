"""Object-store-native ingest engine. A copy of ``petastorm_tpu.storage``:
the same policy, plans, counters and footer sidecars, so a footer one
package cached is a hit in the other.

The seed read path hands a whole Parquet fragment to
``fragment.to_table()`` — one serialized stream per rowgroup, a footer
round-trip per worker, no defense against object-store tail latency. This
package replaces it with **planned byte-range I/O**:

- :mod:`~petastorm_tpu_torch.storage.range_planner` parses the footer once and
  emits exactly the column-chunk byte ranges the projected field set needs,
  coalescing near-adjacent ranges under a gap threshold into merged GETs;
- :mod:`~petastorm_tpu_torch.storage.fetcher` executes the plan with a parallel
  bounded-window fetch pool and **request hedging** against tail latency
  (duplicate the slowest quantile after an adaptive deadline, first
  response wins);
- :mod:`~petastorm_tpu_torch.storage.metadata_cache` amortizes footer reads
  across rowgroups, workers and runs (in-process LRU + atomic disk
  sidecar keyed by ``(path, mtime, size)``);
- :mod:`~petastorm_tpu_torch.storage.engine` assembles the three into a
  :class:`~petastorm_tpu_torch.storage.engine.RowGroupSource` the worker read
  path consumes in place of ``fragment.to_table()``.

Engagement is decided by :func:`resolve_storage_policy` from the
``make_reader(storage_policy=)`` kwarg: ``None`` auto-engages only for
non-local URL schemes (local/HDFS stay on the byte-identical seed path),
``False`` never engages, ``True`` / a :class:`StoragePolicy` always does.

Counters (``storage_footer_cache_hit`` / ``..._miss`` /
``storage_ranges_coalesced`` / ``storage_hedge_fired`` / ``..._won`` —
declared in ``telemetry/spans.py``) accumulate in a process-local registry
merged into ``Reader.telemetry_snapshot()``; like the breaker counters they
are reliable on in-process (thread/dummy) pools — process-pool workers keep
them worker-side. Stage timings (``range_fetch`` / ``range_hedge``) ride
the normal batch-sidecar transport and survive every pool shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union
from urllib.parse import urlparse

from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

#: URL schemes served by the seed pyarrow-FS passthrough path — the engine
#: never auto-engages for these (explicit ``storage_policy=True`` still
#: wins, which is how the local-FS tests and bench drive it). Single-letter
#: "schemes" are Windows drive letters (fs_utils._scheme_of convention).
LOCAL_SCHEMES = ('', 'file', 'hdfs')


@dataclass(frozen=True)
class StoragePolicy:
    """Tuning surface of the ingest engine (defaults fit S3/GCS-class
    stores).

    ``coalesce_gap_bytes``: merge column-chunk ranges separated by at most
    this many bytes into one GET (the wasted gap bytes are cheaper than a
    second round-trip). ``max_in_flight``: parallel range-GET window, also
    actuated live via the ``storage_fetch_window`` autotune knob
    (``PETASTORM_TPU_STORAGE_FETCH_WINDOW``). ``hedge_*``: duplicate a GET
    still in flight after ``max(hedge_min_s, quantile(completed) *
    hedge_factor)`` — first response wins, the loser's bytes are dropped.
    ``footer_read_bytes``: initial tail read when the footer size is
    unknown. ``cache_capacity`` / ``cache_dir``: in-process LRU entries and
    the optional disk-sidecar directory for the footer cache."""

    coalesce_gap_bytes: int = 64 * 1024
    max_in_flight: int = 8
    hedge_enabled: bool = True
    hedge_quantile: float = 0.9
    hedge_factor: float = 3.0
    hedge_min_s: float = 0.05
    footer_read_bytes: int = 64 * 1024
    cache_capacity: int = 256
    cache_dir: Optional[str] = None


def _scheme_of(url: str) -> str:
    scheme = urlparse(url).scheme
    # single-letter scheme = Windows drive letter, i.e. a local path
    return '' if len(scheme) <= 1 else scheme.lower()


def resolve_storage_policy(
        policy: Union[None, bool, StoragePolicy],
        dataset_url_or_urls: Any) -> Optional[StoragePolicy]:
    """Resolve the ``make_reader(storage_policy=)`` kwarg into the policy
    the workers run with, or None for the byte-identical seed path.

    ``None`` (the default) engages the engine only when the dataset URL
    scheme is non-local — pointing the same code at ``s3://`` flips the
    engine on, while every local/HDFS job stays on the seed path with zero
    resolution cost. ``False`` disables unconditionally; ``True`` resolves
    to the default :class:`StoragePolicy`; a policy instance passes
    through."""
    if policy is False:
        return None
    if isinstance(policy, StoragePolicy):
        return policy
    if policy is True:
        return StoragePolicy()
    if policy is not None:
        raise TypeError(
            'storage_policy must be None, a bool or a StoragePolicy; '
            'got {!r}'.format(policy))
    urls = (dataset_url_or_urls if isinstance(dataset_url_or_urls, list)
            else [dataset_url_or_urls])
    if not urls or not isinstance(urls[0], str):
        return None
    return StoragePolicy() if _scheme_of(urls[0]) not in LOCAL_SCHEMES \
        else None


#: process-local registry the storage counters accumulate in (module
#: docstring: merged into reader snapshots; in-process pools see it all)
_metrics = MetricsRegistry()


def storage_metrics() -> MetricsRegistry:
    """The process-local storage counter registry."""
    return _metrics


def storage_metrics_snapshot() -> Dict[str, Any]:
    """JSON-safe snapshot of the storage counters (registry format)."""
    return _metrics.snapshot()


def reset_storage_metrics() -> None:
    """Swap in a fresh registry (tests / bench isolation)."""
    global _metrics
    _metrics = MetricsRegistry()


__all__ = ['LOCAL_SCHEMES', 'StoragePolicy', 'resolve_storage_policy',
           'storage_metrics', 'storage_metrics_snapshot',
           'reset_storage_metrics']
