"""The closed-loop controller: telemetry in, knob turns out. A copy of
``petastorm_tpu.autotune.controller`` (without the run-history warm start and
the service pump's ``maybe_step``, which wait with those planes).

Control loop (one :meth:`AutotuneController.step` per policy window):

1. **Sample** — read the cumulative goodput metric (reader rows consumed)
   and a telemetry snapshot; the per-window deltas give
   rows/s and the window's stage histograms.
2. **Interlock** — if any circuit breaker is *open*
   (:class:`~petastorm_tpu_torch.resilience.BreakerBoard`, and the process
   pool's shm breaker), revert the pending
   proposal (if one is held) and **freeze**: a pipeline routing around a broken
   dependency is not a pipeline to optimize. Unfreeze only after every breaker
   closed plus a cooldown.
3. **Evaluate** — if a proposal is being held, compare the window's rate to the
   proposal's baseline: commit when the relative gain clears the policy's
   hysteresis gate, else revert and put the knob on cooldown.
4. **Propose** — otherwise run
   :func:`~petastorm_tpu_torch.telemetry.analyze.attribute_bottleneck` on the window
   delta, map the top leaf stage to an eligible knob
   (:class:`~petastorm_tpu_torch.autotune.knobs.KnobCatalog` stage sets), and move it
   one step in the remembered direction (hill climbing: a reverted direction is
   retried the other way; a commit keeps climbing). **One knob at a time** —
   there is never more than one uncommitted change in flight, so every measured
   delta is attributable.

Every decision (propose/commit/revert/freeze/unfreeze) is appended to a bounded
in-memory log (``report()``), emitted as an ``autotune_decision`` record through
the :class:`~petastorm_tpu_torch.telemetry.export.JsonlEventLogger` when one is
configured, and stamped on the flight-recorder timeline as an
``autotune_decision`` trace instant — runs are auditable after the fact.

The clock is injectable and :meth:`step` is public, so the whole state machine
is unit-testable with scripted snapshots and no threads; ``start()`` wraps it
in a daemon sampling thread for production use.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from petastorm_tpu_torch.autotune.knobs import Knob, KnobCatalog
from petastorm_tpu_torch.autotune.policy import AutotunePolicy
from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.export import logger_from_env
from petastorm_tpu_torch.telemetry.registry import SECONDS_UNIT

#: decision actions the controller can record (the JSONL ``action`` field)
DECISION_ACTIONS = ('propose', 'commit', 'revert', 'freeze', 'unfreeze')

Snapshot = Dict[str, Any]
Decision = Dict[str, Any]


def snapshot_delta(prev: Snapshot, cur: Snapshot) -> Snapshot:
    """Per-window telemetry delta: cumulative histogram/counter snapshots in,
    the window's own increments out (gauges pass through as current values).
    The result is a valid :func:`attribute_bottleneck` input."""
    histograms: Dict[str, Any] = {}
    prev_hists = prev.get('histograms') or {}
    for name, hist in (cur.get('histograms') or {}).items():
        before = prev_hists.get(name) or {}
        count = int(hist.get('count', 0)) - int(before.get('count', 0))
        total = float(hist.get('sum', 0.0)) - float(before.get('sum', 0.0))
        if count > 0 and total > 0:
            # the unit default must match attribute_bottleneck's (a missing
            # unit means a latency stage there too)
            histograms[name] = {'unit': hist.get('unit', SECONDS_UNIT),
                                'count': count, 'sum': total,
                                'max': hist.get('max', 0.0)}
    counters: Dict[str, int] = {}
    prev_counters = prev.get('counters') or {}
    for name, value in (cur.get('counters') or {}).items():
        delta = int(value) - int(prev_counters.get(name, 0))
        if delta > 0:
            counters[name] = delta
    return {'histograms': histograms, 'counters': counters,
            'gauges': dict(cur.get('gauges') or {})}


def choose_from_bottleneck(prev: Snapshot, cur: Snapshot, rate: float,
                           eligible: List[Knob]) -> Optional[str]:
    """The default knob chooser: rank the window's leaf stages with
    :func:`~petastorm_tpu_torch.telemetry.analyze.attribute_bottleneck` and return
    the first eligible knob claiming the highest-ranked stage (falling down
    the ranking when the top stage has no live knob)."""
    from petastorm_tpu_torch.telemetry.analyze import attribute_bottleneck
    report = attribute_bottleneck(snapshot_delta(prev, cur))
    by_stage: Dict[str, str] = {}
    for knob in eligible:
        for stage in knob.stages:
            by_stage.setdefault(stage, knob.knob_id)
    for entry in report.get('ranked', []):
        knob_id = by_stage.get(entry['stage'])
        if knob_id is not None:
            return knob_id
    return None


def default_breaker_snapshot() -> Dict[str, Dict[str, Any]]:
    """The default safety-interlock source: the process-wide breaker board's
    tripped set (the filesystem breakers)."""
    from petastorm_tpu_torch.resilience import default_board
    return default_board().snapshot(only_tripped=True)


class _Pending(object):
    """The one in-flight proposal (one-knob-at-a-time invariant)."""

    __slots__ = ('knob_id', 'old_value', 'new_value', 'baseline_rate',
                 'hold_left', 'direction')

    def __init__(self, knob_id: str, old_value: float, new_value: float,
                 baseline_rate: float, hold_left: int, direction: int) -> None:
        self.knob_id = knob_id
        self.old_value = old_value
        self.new_value = new_value
        self.baseline_rate = baseline_rate
        self.hold_left = hold_left
        self.direction = direction


class AutotuneController(object):
    """Hill-climbing knob controller over a :class:`KnobCatalog` (module doc).

    :param catalog: the knobs this controller may turn.
    :param metric_fn: cumulative goodput counter (monotone; rows consumed) —
        window deltas over the injected clock give the rate.
    :param snapshot_fn: cumulative telemetry snapshot source (e.g.
        ``Reader.telemetry_snapshot``); None = empty snapshots (a chooser that
        does not need telemetry still works).
    :param policy: an :class:`AutotunePolicy` (default: defaults).
    :param breaker_snapshot_fn: the safety interlock's breaker view
        (``{name: breaker_dict}``); any entry with ``state == 'open'`` freezes
        the controller. Default: the process breaker board's tripped set.
    :param clock: injectable monotone clock (tests drive the loop
        deterministically).

    The knob is chosen by :func:`choose_from_bottleneck`; decisions also go
    to ``PETASTORM_TPU_TELEMETRY_JSONL`` when it names a file, each stamped
    ``controller='reader'``.
    """

    def __init__(self, catalog: KnobCatalog,
                 metric_fn: Callable[[], float],
                 snapshot_fn: Optional[Callable[[], Snapshot]] = None,
                 policy: Optional[AutotunePolicy] = None,
                 breaker_snapshot_fn: Optional[
                     Callable[[], Dict[str, Dict[str, Any]]]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.catalog = catalog
        self.policy = policy if policy is not None else AutotunePolicy()
        self._metric_fn = metric_fn
        self._snapshot_fn = snapshot_fn
        self._breaker_snapshot_fn = (breaker_snapshot_fn
                                     if breaker_snapshot_fn is not None
                                     else default_breaker_snapshot)
        self._clock = clock
        self._events = logger_from_env()
        self._lock = threading.Lock()
        self._last_time: Optional[float] = None
        self._last_metric = 0.0
        self._prev_snapshot: Snapshot = {}
        self._windows = 0
        self._warmup_left = self.policy.warmup_windows
        self._pending: Optional[_Pending] = None
        self._cooldowns: Dict[str, int] = {}
        self._last_direction: Dict[str, int] = {}
        self._frozen = False
        self._freeze_left = 0
        self._decisions: Deque[Decision] = collections.deque(
            maxlen=self.policy.max_decisions)
        self._committed = 0
        self._reverted = 0
        self._freezes = 0
        self._last_rate = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        # decisions made under the lock, emitted (JSONL/trace I/O) after it
        # releases — see step()
        self._pending_emits: List[Decision] = []
        # cumulative wall seconds spent inside step() (sampling, attribution,
        # knob turns, decision emission) — the controller's own cost, surfaced
        # by report() so overhead is measured, not guessed
        self._step_seconds = 0.0

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Run :meth:`step` every ``policy.window_s`` on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError('AutotuneController already started')
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='petastorm-tpu-torch-autotune')
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_event.wait(self.policy.window_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the tuner must never kill the read it tunes
                logging.getLogger(__name__).exception(
                    'autotune step failed; controller keeps sampling')

    def stop(self) -> None:
        """Stop the sampling thread and run every knob's ``restore`` hook
        (knobs that actuate through process-global state — the decode-threads
        env contract — undo their turns so the next reader in this process
        starts from the pre-tuning defaults). Idempotent; never blocks long."""
        self._stop_event.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None
        for knob in self.catalog.knobs():
            if knob.restore is not None:
                try:
                    knob.restore()
                except Exception:  # noqa: BLE001 - teardown must never raise out of stop()
                    logging.getLogger(__name__).debug(
                        'autotune: restoring knob %s failed', knob.knob_id,
                        exc_info=True)

    # ------------------------------------------------------------- the loop

    def step(self) -> Optional[Decision]:
        """One control-loop window (module doc); returns the decision made in
        this window, or None (sampling/holding windows make no decision).

        Decision records are built under the controller lock but EMITTED
        (JSONL append, trace instant — blocking I/O) after it releases: a
        slow disk behind the event log must not stall ``report()`` readers."""
        started = time.perf_counter()
        try:
            with self._lock:
                decision = self._step_locked()
                to_emit = self._pending_emits
                self._pending_emits = []
            for recorded in to_emit:
                self._emit(recorded)
            return decision
        finally:
            # plain float add: step() is serialized by its own lock for every
            # real caller (one sampling thread), and a torn read in report()
            # would still be a valid recent value
            self._step_seconds += time.perf_counter() - started

    def _step_locked(self) -> Optional[Decision]:
        now = self._clock()
        metric = float(self._metric_fn())
        snapshot: Snapshot = self._snapshot_fn() if self._snapshot_fn else {}
        if self._last_time is None:
            self._last_time = now
            self._last_metric = metric
            self._prev_snapshot = snapshot
            return None
        dt = now - self._last_time
        if dt <= 0:
            return None
        rate = max(0.0, (metric - self._last_metric) / dt)
        self._windows += 1
        self._last_time = now
        self._last_metric = metric
        prev_snapshot = self._prev_snapshot
        self._prev_snapshot = snapshot
        self._last_rate = rate
        # a knob cooling at the START of this window stays barred for it, so a
        # cooldown of N bars exactly N windows after the revert that set it
        cooling = frozenset(self._cooldowns)
        for knob_id in list(self._cooldowns):
            self._cooldowns[knob_id] -= 1
            if self._cooldowns[knob_id] <= 0:
                del self._cooldowns[knob_id]
        open_breakers = sorted(
            name for name, state in (self._breaker_snapshot_fn() or {}).items()
            if state.get('state') == 'open')
        if open_breakers:
            return self._interlock(open_breakers, rate)
        if self._frozen:
            self._freeze_left -= 1
            if self._freeze_left > 0:
                return None
            self._frozen = False
            return self._record('unfreeze', rate=rate,
                                reason='all breakers closed')
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return None
        if self._pending is not None:
            return self._evaluate_pending(rate)
        return self._propose(prev_snapshot, snapshot, rate, cooling)

    def _interlock(self, open_breakers: List[str],
                   rate: float) -> Optional[Decision]:
        """Breaker safety interlock: revert any held change, freeze until the
        board is healthy again (plus the policy's re-entry cooldown)."""
        decision: Optional[Decision] = None
        if self._pending is not None:
            decision = self._revert_pending(
                rate, reason='breaker open: {}'.format(','.join(open_breakers)))
        if not self._frozen:
            self._frozen = True
            self._freezes += 1
            decision = self._record(
                'freeze', rate=rate,
                reason='open breaker(s): {}'.format(','.join(open_breakers)))
        self._freeze_left = max(self.policy.freeze_cooldown_windows, 1)
        return decision

    def _evaluate_pending(self, rate: float) -> Optional[Decision]:
        pending = self._pending
        assert pending is not None
        if pending.hold_left > 0:
            pending.hold_left -= 1
            return None
        gate = pending.baseline_rate * (1.0 + self.policy.min_improvement)
        # rate > 0 guards the degenerate gate: a 0 rows/s baseline (consumer
        # paused mid-window) makes gate 0.0, and committing a change judged
        # against a window that measured no progress would teach the climb a
        # direction nothing validated. 0 -> positive still commits (a change
        # that unstuck a stalled pipeline is the realest improvement there is).
        if rate > 0 and rate >= gate:
            self._pending = None
            self._last_direction[pending.knob_id] = pending.direction
            self._committed += 1
            return self._record(
                'commit', knob_id=pending.knob_id,
                from_value=pending.old_value, to_value=pending.new_value,
                rate=rate, baseline=pending.baseline_rate,
                reason='rate {:.1f} cleared gate {:.1f}'.format(rate, gate))
        return self._revert_pending(
            rate, reason='rate {:.1f} below gate {:.1f}'.format(rate, gate))

    def _revert_pending(self, rate: float, reason: str) -> Decision:
        pending = self._pending
        assert pending is not None
        self._pending = None
        restored = True
        try:
            pending_knob = self.catalog.knob(pending.knob_id)
            pending_knob.apply(pending.old_value)
        except Exception:  # noqa: BLE001 - a dead target must not wedge the loop; the decision records the attempt
            restored = False
        self._cooldowns[pending.knob_id] = self.policy.cooldown_windows
        # hill climbing: a failed direction flips the next try for this knob
        self._last_direction[pending.knob_id] = -pending.direction
        self._reverted += 1
        # the audit must state the LIVE value: a failed restore leaves the
        # knob at the proposed value, and a decision claiming otherwise would
        # send an operator reading the JSONL stream after the wrong state
        return self._record(
            'revert', knob_id=pending.knob_id,
            from_value=pending.new_value,
            to_value=pending.old_value if restored else pending.new_value,
            rate=rate, baseline=pending.baseline_rate,
            reason=reason if restored else
            reason + ' (restore FAILED: knob target dead; live value unchanged)')

    def _propose(self, prev_snapshot: Snapshot, snapshot: Snapshot,
                 rate: float,
                 cooling: frozenset = frozenset()) -> Optional[Decision]:
        allowed = self.policy.knob_ids
        eligible = [
            knob for knob in self.catalog.knobs()
            if knob.cost != 'deferred'
            and knob.knob_id not in cooling
            and knob.knob_id not in self._cooldowns
            and (allowed is None or knob.knob_id in allowed)]
        if not eligible:
            return None
        knob_id = choose_from_bottleneck(prev_snapshot, snapshot, rate, eligible)
        if knob_id is None or not any(k.knob_id == knob_id for k in eligible):
            return None
        knob = self.catalog.knob(knob_id)
        old = float(knob.get())
        direction = self._last_direction.get(knob_id, 1)
        target = knob.clamp(old + direction * knob.step)
        if target == old:
            direction = -direction
            target = knob.clamp(old + direction * knob.step)
        if target == old:
            # pinned at both bounds (min == max): nothing to turn
            self._cooldowns[knob_id] = self.policy.cooldown_windows
            return None
        applied = float(knob.apply(target))
        if applied == old:
            # the mutator refused the move (stopped pool, clamped away)
            self._cooldowns[knob_id] = self.policy.cooldown_windows
            return None
        self._pending = _Pending(knob_id, old, applied, rate,
                                 self.policy.hold_windows, direction)
        return self._record(
            'propose', knob_id=knob_id, from_value=old, to_value=applied,
            rate=rate,
            reason='bottleneck stage maps to {} (direction {:+d})'
            .format(knob_id, direction))

    # ------------------------------------------------------------- reporting

    def _record(self, action: str, knob_id: Optional[str] = None,
                from_value: Optional[float] = None,
                to_value: Optional[float] = None,
                rate: float = 0.0, baseline: Optional[float] = None,
                reason: str = '') -> Decision:
        decision: Decision = {
            'window': self._windows, 'controller': 'reader',
            'action': action, 'knob': knob_id,
            'from': from_value, 'to': to_value,
            'rate_rows_per_sec': round(rate, 3), 'reason': reason}
        if baseline is not None:
            decision['baseline_rows_per_sec'] = round(baseline, 3)
        self._decisions.append(decision)
        self._pending_emits.append(decision)
        return decision

    def _emit(self, decision: Decision) -> None:
        """Emit one recorded decision to the JSONL log and the flight
        recorder. Called lock-free from step() (both sinks are independently
        thread-safe); an interlock window can emit two (revert + freeze)."""
        if self._events is not None:
            self._events.emit({}, event='autotune_decision', **decision)
        if _tracing.trace_enabled():
            _tracing.trace_instant('autotune_decision',
                                   args={k: v for k, v in decision.items()
                                         if v is not None})

    @property
    def frozen(self) -> bool:
        """True while the breaker interlock holds the controller frozen."""
        with self._lock:
            return self._frozen

    def report(self) -> Dict[str, Any]:
        """JSON-safe controller state: window/decision counts, the
        frozen-by-breaker flag, current knob values/bounds, and the bounded
        decision log (``Reader.autotune_report()`` surfaces this)."""
        with self._lock:
            pending = self._pending
            return {
                'enabled': True,
                'controller': 'reader',
                'windows': self._windows,
                'frozen_by_breaker': self._frozen,
                'committed': self._committed,
                'reverted': self._reverted,
                'freezes': self._freezes,
                'pending_knob': pending.knob_id if pending else None,
                'last_rate_rows_per_sec': round(self._last_rate, 3),
                'controller_step_seconds': round(self._step_seconds, 6),
                'knobs': self.catalog.as_dicts(),
                'decisions': list(self._decisions),
            }


def setup_reader_autotune(reader: Any,
                          policy: AutotunePolicy) -> AutotuneController:
    """Build (without starting) the reader-side controller: live knobs from
    :func:`~petastorm_tpu_torch.autotune.knobs.build_reader_knobs`, goodput from the
    reader's delivered-row counter, telemetry from
    ``Reader.telemetry_snapshot``, and a breaker interlock spanning the
    process board plus the pool's shm breaker."""
    from petastorm_tpu_torch.autotune.knobs import build_reader_knobs
    catalog = KnobCatalog(build_reader_knobs(reader))

    def breakers() -> Dict[str, Dict[str, Any]]:
        tripped = dict(default_breaker_snapshot())
        shm_breaker = getattr(getattr(reader, '_pool', None),
                              '_shm_breaker', None)
        if shm_breaker is not None:
            state = shm_breaker.as_dict()
            if state.get('state') != 'closed' or state.get('failures'):
                tripped['shm_transport'] = state
        return tripped

    return AutotuneController(
        catalog,
        metric_fn=lambda: float(reader.rows_consumed),
        snapshot_fn=reader.telemetry_snapshot,
        policy=policy,
        breaker_snapshot_fn=breakers)
