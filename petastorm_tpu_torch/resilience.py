"""Resilience primitives: retry with backoff, the transient-error classifier,
the quarantine ledger and circuit breakers. A copy of
``petastorm_tpu.resilience`` without its board-wide observers (the incident
plane's hook): the same policies, the same seeded jitter and the same breaker
transitions, each a ``breaker_transition`` instant on the flight recorder's
timeline while tracing is armed.

- :class:`RetryPolicy`: bounded attempts, exponential backoff with
  deterministic seeded jitter, per-attempt and total deadlines. The reader
  applies it around dataset open and rowgroup enumeration, the rowgroup worker
  around each rowgroup load.
- :func:`run_with_retry`: the retry loop; only errors the classifier calls
  transient spend attempts.
- :class:`QuarantineRecord` / :class:`QuarantineLedger`: under
  ``on_error='skip'`` every rowgroup left out of the stream is recorded (piece,
  path, error, attempts, and ``reason``: ``'error'``, or ``'hang'`` when the
  process pool's watchdog reaped the worker holding it) and shows in
  ``Reader.diagnostics``.
- :class:`CircuitBreaker` / :class:`BreakerBoard`: closed, open and half-open
  breakers with an injectable clock, in front of the process pool's
  shared-memory transport (repeated CRC failures send results over the pipe
  for a cooldown) and of filesystem opens (one breaker a path prefix, composed
  with :class:`RetryPolicy` through :func:`call_with_breaker`).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from petastorm_tpu_torch.errors import TransientIOError
from petastorm_tpu_torch.telemetry import tracing as _tracing

#: on_error modes accepted by make_reader / make_batch_reader
ON_ERROR_MODES: Tuple[str, ...] = ('raise', 'retry', 'skip')


def check_on_error(on_error: str) -> str:
    """Validate an ``on_error`` mode."""
    if on_error not in ON_ERROR_MODES:
        raise ValueError('on_error must be one of {}, got {!r}'
                         .format(ON_ERROR_MODES, on_error))
    return on_error


def resolve_retry_policy(on_error: str,
                         retry_policy: Optional['RetryPolicy']) -> Optional['RetryPolicy']:
    """The one normalization of ``(on_error, retry_policy)``: ``'raise'`` means
    no retry anywhere (a policy passed with it is ignored), the other modes get
    the given policy or the default one. Validates ``on_error``."""
    check_on_error(on_error)
    if on_error == 'raise':
        return None
    return retry_policy if retry_policy is not None else RetryPolicy()


def is_transient_error(exc: BaseException) -> bool:
    """Default transient classifier: OS-level IO failures (pyarrow raises its IO
    errors as ``OSError``) and :class:`TransientIOError`. Corruption
    (``ArrowInvalid``, ``ValueError``), schema and decode errors are permanent,
    and so are the filesystem's deterministic answers (not found, permission)."""
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, (FileNotFoundError, IsADirectoryError, NotADirectoryError,
                        PermissionError)):
        return False
    return isinstance(exc, (OSError, TimeoutError))


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic seeded jitter.

    :param max_attempts: attempts including the first (1 = no retry).
    :param backoff_base_s: sleep before the first retry.
    :param backoff_multiplier: growth factor of each later sleep.
    :param max_backoff_s: backoff ceiling.
    :param jitter_fraction: each sleep is scaled by a factor drawn uniformly
        from ``[1 - jitter_fraction, 1 + jitter_fraction]``, a pure function of
        ``(seed, key, attempt)``: two runs with one seed sleep alike.
    :param seed: jitter seed (None: 0).
    :param per_attempt_deadline_s: a failed attempt that ran longer than this
        ends the retries.
    :param total_deadline_s: wall-clock budget over all attempts and sleeps.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter_fraction: float = 0.1
    seed: Optional[int] = None
    per_attempt_deadline_s: Optional[float] = None
    total_deadline_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError('max_attempts must be >= 1, got {}'.format(self.max_attempts))
        if self.backoff_base_s < 0 or self.max_backoff_s < 0:
            raise ValueError('backoff durations must be non-negative')
        if not 0 <= self.jitter_fraction <= 1:
            raise ValueError('jitter_fraction must be in [0, 1], got {}'
                             .format(self.jitter_fraction))

    def backoff_s(self, attempt: int, key: int = 0) -> float:
        """Sleep before retry number ``attempt`` (1-based): the exponential
        schedule scaled by the seeded jitter draw of ``(seed, key, attempt)``."""
        if attempt < 1:
            raise ValueError('attempt is 1-based, got {}'.format(attempt))
        base = min(self.max_backoff_s,
                   self.backoff_base_s * self.backoff_multiplier ** (attempt - 1))
        if not self.jitter_fraction:
            return base
        # the hash of an int tuple is the same in every process (PYTHONHASHSEED
        # salts only str and bytes), so workers draw the same jitter
        draw = random.Random(hash((self.seed or 0, key, attempt))).uniform(
            1.0 - self.jitter_fraction, 1.0 + self.jitter_fraction)
        return base * draw


#: retry callback: (attempt_number, exception, sleep_seconds)
OnRetry = Callable[[int, BaseException, float], None]


def run_with_retry(fn: Callable[[], Any],
                   policy: RetryPolicy,
                   key: int = 0,
                   is_transient: Callable[[BaseException], bool] = is_transient_error,
                   sleep: Callable[[float], None] = time.sleep,
                   clock: Callable[[], float] = time.monotonic,
                   on_retry: Optional[OnRetry] = None) -> Tuple[Any, int]:
    """Call ``fn`` under ``policy``; returns ``(result, retries_used)``. Errors
    the classifier does not call transient raise at once; when the budget is
    spent the last error raises unchanged. ``key`` decorrelates the jitter of
    concurrent retries under one seed (the reader passes the piece index)."""
    start = clock()
    attempt = 0
    while True:
        attempt += 1
        attempt_start = clock()
        try:
            return fn(), attempt - 1
        except BaseException as exc:  # noqa: BLE001 - the classifier decides; the rest re-raises
            attempt_elapsed = clock() - attempt_start
            if not is_transient(exc):
                raise
            if attempt >= policy.max_attempts:
                raise
            if (policy.per_attempt_deadline_s is not None
                    and attempt_elapsed > policy.per_attempt_deadline_s):
                raise
            delay = policy.backoff_s(attempt, key=key)
            if (policy.total_deadline_s is not None
                    and clock() - start + delay > policy.total_deadline_s):
                raise
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            if delay > 0:
                sleep(delay)


@dataclass(frozen=True)
class QuarantineRecord:
    """One rowgroup left out of the stream: where it was, what failed it and
    how often it was tried. ``reason`` is ``'error'`` (an error spent the retry
    budget) or ``'hang'`` (the worker holding it overran ``item_deadline_s``
    and was reaped)."""

    piece_index: int
    fragment_path: str
    row_group_id: Optional[int]
    error_type: str
    error: str
    attempts: int
    epoch: int = 0
    reason: str = 'error'

    @classmethod
    def from_exception(cls, exc: BaseException, piece_index: int, fragment_path: str,
                       row_group_id: Optional[int], attempts: int,
                       epoch: int = 0) -> 'QuarantineRecord':
        return cls(piece_index=piece_index, fragment_path=fragment_path,
                   row_group_id=row_group_id, error_type=type(exc).__name__,
                   error=str(exc)[:500], attempts=attempts, epoch=epoch)

    def as_dict(self) -> Dict[str, Any]:
        return {'piece_index': self.piece_index, 'fragment_path': self.fragment_path,
                'row_group_id': self.row_group_id, 'error_type': self.error_type,
                'error': self.error, 'attempts': self.attempts, 'epoch': self.epoch,
                'reason': self.reason}


class QuarantineLedger:
    """Thread-safe list of :class:`QuarantineRecord`: the reader appends as
    quarantined items arrive on the results channel."""

    def __init__(self) -> None:
        self._records: List[QuarantineRecord] = []
        self._lock = threading.Lock()

    def add(self, record: QuarantineRecord) -> None:
        with self._lock:
            self._records.append(record)

    def records(self) -> List[QuarantineRecord]:
        with self._lock:
            return list(self._records)

    def as_dicts(self) -> List[Dict[str, Any]]:
        return [record.as_dict() for record in self.records()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __bool__(self) -> bool:
        return len(self) > 0

    def raise_if_any(self) -> None:
        """Raise :class:`~petastorm_tpu_torch.errors.QuarantinedRowGroupError`
        naming the first record (and the count) when the ledger is not empty."""
        from petastorm_tpu_torch.errors import QuarantinedRowGroupError
        records = self.records()
        if not records:
            return
        first = records[0]
        raise QuarantinedRowGroupError(
            '{} rowgroup(s) were quarantined this run; first: piece {} of {!r} '
            '(rowgroup {}) failed after {} attempt(s) with {}: {}'.format(
                len(records), first.piece_index, first.fragment_path,
                first.row_group_id, first.attempts, first.error_type, first.error),
            piece_index=first.piece_index, fragment_path=first.fragment_path,
            row_group_id=first.row_group_id, attempts=first.attempts)


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------

BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 'closed', 'open', 'half_open'

#: transition callback: (breaker_name, old_state, new_state)
OnBreakerTransition = Callable[[str, str, str], None]


class CircuitBreaker:
    """Closed, open and half-open breaker with an injectable clock.

    - **closed**: calls flow; ``failure_threshold`` consecutive failures open
      it (a success resets the streak).
    - **open**: :meth:`allow` is False until ``recovery_timeout_s`` of
      ``clock`` time has passed; the next :meth:`allow` then moves it to
      half-open.
    - **half-open**: calls flow as probes; the first success closes it, the
      first failure opens it again.

    ``on_transition`` is called after each transition, outside the lock.
    Thread-safe; pickles without its lock and callback (each process holds an
    independent breaker)."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 recovery_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[OnBreakerTransition] = None) -> None:
        if failure_threshold < 1:
            raise ValueError('failure_threshold must be >= 1, got {}'
                             .format(failure_threshold))
        if recovery_timeout_s < 0:
            raise ValueError('recovery_timeout_s must be >= 0')
        self.name = name
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._failures = 0
        self._successes = 0
        self._opened_count = 0
        self._pending: List[Tuple[str, str]] = []

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        del state['_lock']
        state['_on_transition'] = None
        state['_pending'] = []
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _transition(self, new_state: str) -> None:
        # the caller holds self._lock
        old_state = self._state
        if old_state == new_state:
            return
        self._state = new_state
        if new_state == BREAKER_OPEN:
            self._opened_at = self._clock()
            self._opened_count += 1
        # every transition in every process is an anomaly instant on the
        # traced timeline (worker-side ones ride the trace batch sidecar)
        if _tracing.trace_enabled():
            _tracing.trace_instant('breaker_transition',
                                   args={'breaker': self.name, 'from_state': old_state,
                                         'to_state': new_state})
        if self._on_transition is not None:
            self._pending.append((old_state, new_state))

    def _notify(self) -> None:
        # outside self._lock: a callback may read the breaker back
        while True:
            with self._lock:
                if not self._pending:
                    return
                old_state, new_state = self._pending.pop(0)
                callback = self._on_transition
            if callback is not None:
                callback(self.name, old_state, new_state)

    def allow(self) -> bool:
        """True when a call may proceed; an open breaker whose cooldown has
        passed moves to half-open and lets this call through as a probe."""
        with self._lock:
            if self._state == BREAKER_OPEN:
                if self._clock() - self._opened_at >= self.recovery_timeout_s:
                    self._transition(BREAKER_HALF_OPEN)
                    result = True
                else:
                    result = False
            else:
                result = True
        self._notify()
        return result

    def record_success(self) -> None:
        """A guarded call succeeded: reset the streak; a half-open probe closes
        the breaker."""
        with self._lock:
            self._successes += 1
            self._consecutive_failures = 0
            if self._state == BREAKER_HALF_OPEN:
                self._transition(BREAKER_CLOSED)
        self._notify()

    def record_failure(self) -> None:
        """A guarded call failed: open after ``failure_threshold`` consecutive
        failures (at once when half-open)."""
        with self._lock:
            self._failures += 1
            self._consecutive_failures += 1
            if self._state == BREAKER_HALF_OPEN:
                self._transition(BREAKER_OPEN)
            elif (self._state == BREAKER_CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._transition(BREAKER_OPEN)
        self._notify()

    @property
    def state(self) -> str:
        """The current state; reading it applies the open -> half-open
        cooldown transition."""
        with self._lock:
            if (self._state == BREAKER_OPEN
                    and self._clock() - self._opened_at >= self.recovery_timeout_s):
                self._transition(BREAKER_HALF_OPEN)
            result = self._state
        self._notify()
        return result

    @property
    def tripped(self) -> bool:
        """True once the breaker has recorded a failure or opened."""
        with self._lock:
            return (self._failures > 0 or self._opened_count > 0
                    or self._state != BREAKER_CLOSED)

    def reset(self) -> None:
        """Back to a pristine closed state."""
        with self._lock:
            self._transition(BREAKER_CLOSED)
            self._consecutive_failures = 0
            self._failures = 0
            self._successes = 0
            self._opened_count = 0
        self._notify()

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe state for the diagnostics."""
        state = self.state
        with self._lock:
            return {'state': state, 'failures': self._failures,
                    'successes': self._successes,
                    'consecutive_failures': self._consecutive_failures,
                    'opened_count': self._opened_count,
                    'failure_threshold': self.failure_threshold,
                    'recovery_timeout_s': self.recovery_timeout_s}


class BreakerBoard:
    """Named registry of :class:`CircuitBreaker` (one a guarded dependency,
    such as ``'fs:<path-prefix>'``). Process-local: each worker process holds
    its own board, and its tripped breakers ride each published batch into
    ``Reader.diagnostics['breakers']``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def breaker(self, name: str, failure_threshold: int = 5,
                recovery_timeout_s: float = 30.0,
                clock: Callable[[], float] = time.monotonic) -> CircuitBreaker:
        """Get or create the breaker ``name`` (the settings apply on creation)."""
        with self._lock:
            brk = self._breakers.get(name)
            if brk is None:
                brk = CircuitBreaker(name, failure_threshold=failure_threshold,
                                     recovery_timeout_s=recovery_timeout_s, clock=clock)
                self._breakers[name] = brk
            return brk

    def snapshot(self, only_tripped: bool = False) -> Dict[str, Dict[str, Any]]:
        """``{name: breaker.as_dict()}``; ``only_tripped`` leaves out breakers
        that never failed."""
        with self._lock:
            breakers = dict(self._breakers)
        return {name: brk.as_dict() for name, brk in breakers.items()
                if not only_tripped or brk.tripped}


_default_board = BreakerBoard()


def default_board() -> BreakerBoard:
    """The process-wide :class:`BreakerBoard` of the filesystem breakers (the
    process pool's shm breaker belongs to the pool)."""
    return _default_board


def call_with_breaker(
        fn: Callable[[], Any], breaker: CircuitBreaker,
        is_failure: Callable[[BaseException], bool] = is_transient_error) -> Any:
    """Run ``fn`` under ``breaker``. An open breaker fails fast with
    :class:`~petastorm_tpu_torch.errors.TransientIOError` (transient, so a
    surrounding :func:`run_with_retry` spends its budget on cheap failures);
    only ``is_failure`` errors count against the breaker."""
    if not breaker.allow():
        raise TransientIOError(
            'circuit breaker {!r} is open (cooling down for {:.3g}s after {} '
            'consecutive failure(s)); failing fast instead of re-touching the '
            'broken dependency'.format(breaker.name, breaker.recovery_timeout_s,
                                       breaker.failure_threshold))
    try:
        result = fn()
    except BaseException as exc:
        if is_failure(exc):
            breaker.record_failure()
        raise
    breaker.record_success()
    return result
