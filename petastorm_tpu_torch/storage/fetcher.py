"""Parallel multi-range fetch pool with tail-latency request hedging. A
copy of ``petastorm_tpu.storage.fetcher``.

Executes a :class:`~petastorm_tpu_torch.storage.range_planner.RangePlan` as
concurrent ranged reads over a bounded in-flight window (the
``storage_fetch_window`` autotune knob / ``PETASTORM_TPU_STORAGE_FETCH_WINDOW``
env var actuate it live). Every read runs on its own per-thread file handle
(pyarrow ``NativeFile`` reads release the GIL but handles are not
thread-safe), so a hedged duplicate is a genuinely independent GET.

**Hedging**: a range still in flight after an adaptive deadline —
``max(hedge_min_s, quantile(completed durations) * hedge_factor)`` — gets a
duplicate read on a separate pool; the first response wins and is committed
exactly once, the loser is cancelled when still queued or its late bytes
dropped when already running (thread reads cannot be interrupted — the
semantic cancellation is the drop). Counters ``storage_hedge_fired`` /
``storage_hedge_won`` and the ``range_hedge`` stage span account every
duplicate, so doctor can flag a store whose hedges win too often.

Clock discipline: all duration arithmetic flows through the injected
``clock`` callable (tests drive hedging deterministically with the
fault-injection latency distribution plus scripted readers); the blocking
waits themselves use future timeouts, not wall-clock reads.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures import wait as wait_futures
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import time

from petastorm_tpu_torch.errors import TransientIOError
from petastorm_tpu_torch.storage import StoragePolicy, storage_metrics
from petastorm_tpu_torch.storage.range_planner import ByteRange, RangePlan
from petastorm_tpu_torch.telemetry.cost_model import percentile
from petastorm_tpu_torch.telemetry.spans import record_stage

#: live override of the in-flight window (the autotune knob's actuator)
FETCH_WINDOW_ENV = 'PETASTORM_TPU_STORAGE_FETCH_WINDOW'

#: completed-duration samples kept for the adaptive hedge deadline
_MAX_SAMPLES = 512


@dataclass
class FetchResult:
    """One executed plan: fetched segments plus the accounting that rides
    the ``range_fetch`` trace args into the cost ledger."""

    segments: Dict[ByteRange, bytes] = field(default_factory=dict)
    bytes_fetched: int = 0
    ranges: int = 0
    hedges_fired: int = 0
    hedges_won: int = 0
    seconds: float = 0.0

    def trace_args(self) -> Dict[str, int]:
        """The JSON-safe args the ``range_fetch`` span carries (folded into
        ``CostLedger`` entries' ``fetch`` cell)."""
        return {'bytes': self.bytes_fetched, 'ranges': self.ranges,
                'hedges_fired': self.hedges_fired,
                'hedges_won': self.hedges_won}


def fetch_window(policy: StoragePolicy) -> int:
    """The effective in-flight window: the env override when set and valid
    (clamped to [1, 128]), else the policy's ``max_in_flight``."""
    raw = os.environ.get(FETCH_WINDOW_ENV)
    if raw:
        try:
            return min(max(int(raw), 1), 128)
        except ValueError:
            pass
    return max(int(policy.max_in_flight), 1)


class RangeFetcher(object):
    """Fetch pool for ONE file (module docstring). ``open_fn`` opens a new
    readable handle per calling thread — each concurrent leg gets its own
    connection, which is what makes a hedge an independent request."""

    def __init__(self, open_fn: Callable[[], Any], policy: StoragePolicy,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._open_fn = open_fn
        self._policy = policy
        self._clock = clock
        self._local = threading.local()
        self._lock = threading.Lock()
        self._samples: List[float] = []

    # ------------------------------------------------------------ plumbing

    def _handle(self) -> Any:
        handle = getattr(self._local, 'handle', None)
        if handle is None:
            handle = self._open_fn()
            self._local.handle = handle
        return handle

    def _timed_read(self, byte_range: ByteRange) -> Tuple[bytes, float]:
        started = self._clock()
        handle = self._handle()
        handle.seek(byte_range.start)
        data = handle.read(byte_range.length)
        if len(data) != byte_range.length:
            raise TransientIOError(
                'short read: wanted [{}, {}) got {} bytes'.format(
                    byte_range.start, byte_range.stop, len(data)))
        return bytes(data), self._clock() - started

    def _note_sample(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            if len(self._samples) > _MAX_SAMPLES:
                del self._samples[:len(self._samples) - _MAX_SAMPLES]

    def _deadline(self) -> Optional[float]:
        """Seconds a primary may run before its hedge fires; None when
        hedging is off. Adaptive: the ``hedge_quantile`` of completed reads
        times ``hedge_factor``, floored at ``hedge_min_s`` (the floor alone
        governs until samples accumulate)."""
        if not self._policy.hedge_enabled:
            return None
        with self._lock:
            samples = sorted(self._samples)
        adaptive = (percentile(samples, self._policy.hedge_quantile)
                    * self._policy.hedge_factor)
        return max(self._policy.hedge_min_s, adaptive)

    # --------------------------------------------------------------- fetch

    def fetch(self, plan: RangePlan) -> FetchResult:
        """Execute ``plan``: all ranges in parallel under the bounded
        window, hedging stragglers past the adaptive deadline. Read errors
        propagate (the worker's retry/breaker wrapping owns recovery); a
        hedged range fails only when BOTH legs fail."""
        result = FetchResult(ranges=len(plan.ranges))
        if not plan.ranges:
            return result
        started = self._clock()
        window = fetch_window(self._policy)
        pool = ThreadPoolExecutor(
            max_workers=window,
            thread_name_prefix='petastorm-tpu-range-fetch')
        # hedges run on their own pool: a window full of stragglers must
        # never queue the very duplicates meant to overtake them
        hedge_pool = ThreadPoolExecutor(
            max_workers=window,
            thread_name_prefix='petastorm-tpu-range-hedge')
        try:
            futures = [(byte_range, pool.submit(self._timed_read, byte_range))
                       for byte_range in plan.ranges]
            for byte_range, primary in futures:
                data = self._await_range(byte_range, primary, hedge_pool,
                                         result)
                result.segments[byte_range] = data
                result.bytes_fetched += len(data)
        finally:
            # losers may still be mid-read; never block the winner on them
            pool.shutdown(wait=False)
            hedge_pool.shutdown(wait=False)
        result.seconds = self._clock() - started
        return result

    def _await_range(self, byte_range: ByteRange,
                     primary: 'Future[Tuple[bytes, float]]',
                     hedge_pool: ThreadPoolExecutor,
                     result: FetchResult) -> bytes:
        """Wait for one range: primary up to the hedge deadline, then race
        primary vs duplicate — first successful leg commits, once."""
        deadline = self._deadline()
        try:
            data, seconds = primary.result(timeout=deadline)
            self._note_sample(seconds)
            return data
        except FutureTimeoutError:
            pass
        result.hedges_fired += 1
        storage_metrics().inc('storage_hedge_fired')
        hedge_started = self._clock()
        hedge = hedge_pool.submit(self._timed_read, byte_range)
        pending: Set['Future[Tuple[bytes, float]]'] = {primary, hedge}
        error: Optional[BaseException] = None
        winner: Optional['Future[Tuple[bytes, float]]'] = None
        data = b''
        while pending and winner is None:
            done, pending = wait_futures(pending,
                                         return_when=FIRST_COMPLETED)
            for future in done:
                try:
                    data, seconds = future.result()
                except (Exception, ) as exc:  # either leg may fail with any
                    # I/O error type; the race only surfaces it when the
                    # OTHER leg also fails (re-raised below) — a single-leg
                    # failure is exactly what hedging papers over
                    error = exc
                    continue
                winner = future
                self._note_sample(seconds)
                break
        record_stage('range_hedge', self._clock() - hedge_started)
        if winner is None:
            if error is None:
                raise TransientIOError('hedged fetch completed without a '
                                       'result or an error')
            raise error
        loser = primary if winner is hedge else hedge
        loser.cancel()  # no-op once running: late bytes are simply dropped
        if winner is hedge:
            result.hedges_won += 1
            storage_metrics().inc('storage_hedge_won')
        return data
