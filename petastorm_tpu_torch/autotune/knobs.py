"""The knob actuation layer: typed runtime-adjustable pipeline knobs. A copy
of ``petastorm_tpu.autotune.knobs`` over the port's actuators.

A :class:`Knob` names one runtime-adjustable throughput parameter — bounds,
step, actuation cost, the telemetry stages it moves — and wires ``get``/
``apply`` callables into the LIVE pipeline objects (ventilator in-flight
window, thread-pool worker count, decode thread pool, shm ring shape, loader
shuffle-buffer fill threshold, prefetch and decode-tail depths). The
:class:`KnobCatalog` is the typed registry the
:class:`~petastorm_tpu_torch.autotune.controller.AutotuneController`
hill-climbs over, and ``KNOB_IDS`` is the declared id catalog (the JAX
package's fourteen ids: a snapshot's knob names mean the same in both).

Builders (``build_reader_knobs`` / ``build_loader_knobs`` /
``build_service_knobs``) introspect live objects by duck-typing the ``set_*``
mutators, so an object without the mutator simply contributes no knob. A
reader whose work runs in this process (thread or dummy pool) gets the disk
cache's ``cache_bypass`` and, on an Arrow-IPC cache without a transform or a
pinned hit mode, ``cache_writable_hits``; one armed with ``storage_policy``
gets the storage engine's ``storage_fetch_window``. The cost scheduler's
``schedule_interleave`` is built for a shuffling reader armed with
``cost_schedule``, unless lineage is armed (the manifest froze the plan).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

#: declared knob ids — the catalog every ``Knob(...)``/``catalog.knob(...)``
#: literal must draw from (the JAX package's catalog)
KNOB_IDS: Tuple[str, ...] = (
    'ventilator_max_in_flight',   # reader: bounded in-flight rowgroup window
    'pool_workers',               # thread pool: elastic grow/park worker count
    'decode_threads',             # codec decode fan-out (PETASTORM_TPU_DECODE_THREADS)
    'shm_slots_per_worker',       # process pool: ring slots (next generation)
    'shm_slot_bytes',             # process pool: ring slot size (next generation)
    'cache_writable_hits',        # arrow-ipc cache: writable vs zero-copy hits
    'cache_bypass',               # disk cache: direct-fill bypass mode
    'loader_min_after_retrieve',  # loader shuffle-buffer fill threshold
    'loader_prefetch',            # loader: host-batch prefetch queue depth
    'loader_device_buffer',       # loader: device decode-tail ring depth
    'service_admission_window',   # dispatcher: per-client admission cap
    'service_client_window',      # dispatcher: live per-client in-flight depth
    'schedule_interleave',        # cost-aware heavy/light ventilation interleave
    'storage_fetch_window',       # storage engine: parallel range-GET window
                                  # (PETASTORM_TPU_STORAGE_FETCH_WINDOW)
)

#: actuation costs: ``cheap`` knobs act instantly, ``moderate`` knobs take a
#: little while to show (spawned threads, env-driven pools), ``deferred``
#: knobs only take effect on the next generation of their object (shm ring) —
#: the controller never hill-climbs a deferred knob (it could not measure it)
KNOB_COSTS: Tuple[str, ...] = ('cheap', 'moderate', 'deferred')


@dataclass
class Knob:
    """One runtime-adjustable pipeline knob.

    ``get``/``apply`` thread into the live object: ``apply`` receives the
    proposed value and returns the value actually applied (mutators clamp), so
    the controller can detect a pinned knob by ``apply(v) == get-before``.
    ``stages`` names the telemetry stages this knob moves — the bottleneck
    report's top stage selects the knob through this mapping. ``restore``
    (optional) is run by ``AutotuneController.stop()``: a knob that actuates
    through process-global state (the decode-threads env contract) declares
    there how to undo its turns when the tuned reader goes away."""

    knob_id: str
    description: str
    minimum: float
    maximum: float
    step: float
    cost: str
    stages: Tuple[str, ...]
    get: Callable[[], float]
    apply: Callable[[float], float]
    unit: str = ''
    restore: Optional[Callable[[], None]] = None

    def __post_init__(self) -> None:
        if self.knob_id not in KNOB_IDS:
            raise ValueError('unknown knob id {!r} (declared: {})'
                             .format(self.knob_id, KNOB_IDS))
        if self.cost not in KNOB_COSTS:
            raise ValueError('unknown knob cost {!r} (declared: {})'
                             .format(self.cost, KNOB_COSTS))
        if self.minimum > self.maximum:
            raise ValueError('knob {}: minimum {} > maximum {}'
                             .format(self.knob_id, self.minimum, self.maximum))
        if self.step <= 0:
            raise ValueError('knob {}: step must be > 0'.format(self.knob_id))

    def clamp(self, value: float) -> float:
        """Clamp ``value`` into the knob's declared bounds."""
        return max(self.minimum, min(self.maximum, value))

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe view (current value + static shape) for reports."""
        try:
            value: Optional[float] = float(self.get())
        except Exception:  # noqa: BLE001 - a dead target must not kill the report
            value = None
        return {'value': value, 'min': self.minimum, 'max': self.maximum,
                'step': self.step, 'cost': self.cost, 'unit': self.unit,
                'stages': list(self.stages),
                'description': self.description}


class KnobCatalog:
    """Thread-safe registry of :class:`Knob` instances, keyed by knob id.

    The controller iterates it to find the knob a bottleneck stage maps to;
    loaders may :meth:`add` further knobs after the controller is already
    running (the TorchDataLoader registers its knobs this way)."""

    def __init__(self, knobs: Optional[List[Knob]] = None) -> None:
        self._lock = threading.Lock()
        self._knobs: Dict[str, Knob] = {}
        for knob in knobs or []:
            self._knobs[knob.knob_id] = knob

    def add(self, knob: Knob) -> None:
        """Register ``knob``; re-adding an id replaces the previous entry."""
        with self._lock:
            self._knobs[knob.knob_id] = knob

    def knob(self, knob_id: str) -> Knob:
        """The registered knob for ``knob_id`` (KeyError when absent)."""
        with self._lock:
            return self._knobs[knob_id]

    def __contains__(self, knob_id: str) -> bool:
        with self._lock:
            return knob_id in self._knobs

    def __len__(self) -> int:
        with self._lock:
            return len(self._knobs)

    def ids(self) -> List[str]:
        """Registered knob ids, in registration order."""
        with self._lock:
            return list(self._knobs)

    def knobs(self) -> List[Knob]:
        """Snapshot of the registered knobs (safe to iterate lock-free)."""
        with self._lock:
            return list(self._knobs.values())

    def knobs_for_stage(self, stage: str) -> List[Knob]:
        """Knobs claiming ``stage`` in their declared stage set."""
        return [knob for knob in self.knobs() if stage in knob.stages]

    def as_dicts(self) -> Dict[str, Dict[str, Any]]:
        """JSON-safe ``{knob_id: knob.as_dict()}`` for reports/diagnostics."""
        return {knob.knob_id: knob.as_dict() for knob in self.knobs()}


# ---------------------------------------------------------------------------
# builders: live-object introspection -> knobs
# ---------------------------------------------------------------------------


#: the process's pre-autotune decode-threads env, captured when this module
#: first loads (any autotuner touch necessarily postdates this import). Every
#: restore returns to THIS value: capturing per reader would leak reader A's
#: tuned width through reader B's restore when their lifetimes overlap.
_PRISTINE_DECODE_THREADS_ENV: Optional[str] = os.environ.get(
    'PETASTORM_TPU_DECODE_THREADS')

#: the same pristine capture for the storage engine's fetch window
_PRISTINE_FETCH_WINDOW_ENV: Optional[str] = os.environ.get(
    'PETASTORM_TPU_STORAGE_FETCH_WINDOW')


def _set_decode_threads(value: float) -> float:
    """Apply the decode-threads knob through its env contract
    (``PETASTORM_TPU_DECODE_THREADS`` — the process-local decode pool rebuilds
    on next use; spawned process-pool workers capture the env at spawn)."""
    threads = max(1, int(value))
    os.environ['PETASTORM_TPU_DECODE_THREADS'] = str(threads)
    return float(threads)


def build_reader_knobs(reader: Any) -> List[Knob]:
    """Knobs for a live :class:`~petastorm_tpu_torch.reader.Reader`: ventilation
    depth, pool workers (thread pool), decode threads (decoding readers on
    in-process pools) and the shm ring shape (process pool — deferred). Each
    knob is added only when its target object exposes the matching ``set_*``
    mutator."""
    knobs: List[Knob] = []
    ventilator = getattr(reader, '_ventilator', None)
    if ventilator is not None and hasattr(ventilator, 'set_max_in_flight'):
        current = float(ventilator.max_in_flight)
        knobs.append(Knob(
            'ventilator_max_in_flight',
            'bounded in-flight rowgroup window fed to the pool',
            minimum=1.0, maximum=max(64.0, current * 8), step=2.0,
            cost='cheap', stages=('pool_wait', 'shuffle_wait'), unit='items',
            get=lambda: float(ventilator.max_in_flight),
            apply=lambda v: float(ventilator.set_max_in_flight(int(v)))))
    pool = getattr(reader, '_pool', None)
    if pool is not None and hasattr(pool, 'set_workers_count'):
        maximum = float(getattr(pool, '_max_workers_count',
                                4 * pool.workers_count))
        knobs.append(Knob(
            'pool_workers',
            'elastic thread-pool worker count (grow spawns, shrink parks)',
            minimum=1.0, maximum=maximum, step=1.0,
            cost='moderate', unit='workers',
            stages=('pool_wait', 'shuffle_wait', 'rowgroup_read', 'decode'),
            get=lambda: float(pool.workers_count),
            apply=lambda v: float(pool.set_workers_count(int(v)))))
    # Process-local knobs (decode threads) only exist where the work runs in
    # THIS process (thread/dummy pools): process-pool workers captured the
    # env at spawn — turning a consumer-side knob there would burn
    # propose/revert cycles on a knob that moves nothing.
    from petastorm_tpu_torch.workers.dummy_pool import DummyPool
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    in_process_work = isinstance(pool, (ThreadPool, DummyPool))
    if (not getattr(reader, 'is_batched_reader', False)
            and in_process_work):
        from petastorm_tpu_torch.codecs import decode_thread_count
        # env actuation is process-global: hand the controller a restore hook
        # returning to the module-pristine value so a stopped reader cannot
        # leak its tuned width into every later reader in this process
        touched: List[bool] = []

        def _apply_decode_threads(value: float) -> float:
            touched.append(True)
            return _set_decode_threads(value)

        def _restore_decode_threads() -> None:
            if not touched:
                return
            if _PRISTINE_DECODE_THREADS_ENV is None:
                os.environ.pop('PETASTORM_TPU_DECODE_THREADS', None)
            else:
                os.environ['PETASTORM_TPU_DECODE_THREADS'] = \
                    _PRISTINE_DECODE_THREADS_ENV

        knobs.append(Knob(
            'decode_threads',
            'codec decode fan-out width (PETASTORM_TPU_DECODE_THREADS)',
            minimum=1.0, maximum=float(max(8, 2 * (os.cpu_count() or 1))),
            step=1.0, cost='moderate', stages=('decode',), unit='threads',
            get=lambda: float(decode_thread_count()),
            apply=_apply_decode_threads,
            restore=_restore_decode_threads))
    storage_policy = getattr(reader, '_storage_policy', None)
    if storage_policy is not None and in_process_work:
        # the fetcher re-reads its env window every fetch, so a turn acts on
        # the next planned rowgroup
        from petastorm_tpu_torch.storage.fetcher import FETCH_WINDOW_ENV, fetch_window
        storage_touched: List[bool] = []

        def _apply_fetch_window(value: float) -> float:
            storage_touched.append(True)
            window = min(max(int(value), 1), 128)
            os.environ[FETCH_WINDOW_ENV] = str(window)
            return float(window)

        def _restore_fetch_window() -> None:
            if not storage_touched:
                return
            if _PRISTINE_FETCH_WINDOW_ENV is None:
                os.environ.pop(FETCH_WINDOW_ENV, None)
            else:
                os.environ[FETCH_WINDOW_ENV] = _PRISTINE_FETCH_WINDOW_ENV

        knobs.append(Knob(
            'storage_fetch_window',
            'parallel range-GET window of the storage ingest engine '
            '(PETASTORM_TPU_STORAGE_FETCH_WINDOW)',
            minimum=1.0, maximum=128.0, step=2.0, cost='moderate',
            stages=('range_fetch',), unit='requests',
            get=lambda: float(fetch_window(storage_policy)),
            apply=_apply_fetch_window,
            restore=_restore_fetch_window))
    if pool is not None and hasattr(pool, 'set_shm_slot_config'):
        knobs.append(Knob(
            'shm_slots_per_worker',
            'shm ring slots per worker — applies on the next ring generation',
            minimum=1.0, maximum=32.0, step=1.0, cost='deferred',
            stages=('shm_slot_wait', 'shm_release'), unit='slots',
            get=lambda: float(pool._shm_slots_per_worker),
            apply=lambda v: float(
                pool.set_shm_slot_config(slots_per_worker=int(v))[0])))
        knobs.append(Knob(
            'shm_slot_bytes',
            'shm ring slot size — applies on the next ring generation',
            minimum=65536.0, maximum=float(256 * 1024 * 1024),
            step=float(4 * 1024 * 1024), cost='deferred',
            stages=('shm_slot_wait',), unit='bytes',
            get=lambda: float(pool._shm_slot_bytes),
            apply=lambda v: float(
                pool.set_shm_slot_config(slot_bytes=int(v))[1])))
    cache = getattr(reader, '_cache', None) if in_process_work else None
    if cache is not None and hasattr(cache, 'set_bypass'):
        # cache_store is not among its stages: the first epoch's stores are
        # an investment, and a bypass chosen on them would never be undone
        knobs.append(Knob(
            'cache_bypass',
            'serve direct fills instead of cache hits (0=serve, 1=bypass)',
            minimum=0.0, maximum=1.0, step=1.0, cost='cheap',
            stages=('cache_hit',), unit='flag',
            get=lambda: float(bool(cache.bypass)),
            apply=lambda v: float(cache.set_bypass(v >= 0.5))))
    scheduler = getattr(reader, '_cost_scheduler', None)
    if (scheduler is not None and hasattr(scheduler, 'set_interleave')
            and getattr(scheduler, 'live_reorder', False)
            and getattr(reader, '_lineage', None) is None):
        # the cost-aware interleave is a live toggle read at the next epoch's
        # reorder (splits are frozen at construction); only a reader that
        # reorders every epoch reads it again, so only such a reader gets it.
        # Lineage pins it: the manifest header froze this run's plan
        knobs.append(Knob(
            'schedule_interleave',
            'cost-balanced heavy/light ventilation interleave '
            '(0=plain order, 1=interleaved)',
            minimum=0.0, maximum=1.0, step=1.0, cost='cheap',
            stages=('pool_wait', 'shuffle_wait'), unit='flag',
            get=lambda: float(bool(scheduler.interleave)),
            apply=lambda v: float(scheduler.set_interleave(v >= 0.5))))
    if (cache is not None and hasattr(cache, 'set_writable_hits')
            and getattr(reader, '_transform_spec', None) is None
            and not getattr(cache, 'writable_hits_pinned', False)):
        # a transform may mutate hit columns in place, and a pinned
        # writable_hits is the consumer's requirement: neither is a knob
        knobs.append(Knob(
            'cache_writable_hits',
            'decode cache hits writable (1) vs zero-copy read-only views (0)',
            minimum=0.0, maximum=1.0, step=1.0, cost='cheap',
            stages=('cache_hit',), unit='flag',
            get=lambda: float(bool(cache.writable_hits)),
            apply=lambda v: float(cache.set_writable_hits(v >= 0.5))))
    return knobs


def build_loader_knobs(loader: Any) -> List[Knob]:
    """Knobs for a live :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`:
    the prefetch queue depth and (when the reader ships raw fields) the device
    decode tail's ring depth — both gated off when ``device_put=False``, where
    batches never leave the host and neither queue hides device latency — plus
    the shuffle-buffer fill threshold (``min_after_retrieve``) when a
    shuffling buffer is configured."""
    knobs: List[Knob] = []
    if getattr(loader, '_device_put', False):
        current_prefetch = float(getattr(loader, 'prefetch', 2))
        knobs.append(Knob(
            'loader_prefetch',
            'host-batch prefetch queue depth (batches in flight ahead of the '
            'training loop)',
            minimum=1.0, maximum=max(16.0, current_prefetch * 8), step=1.0,
            cost='cheap', stages=('shuffle_wait', 'h2d'), unit='batches',
            get=lambda: float(loader.prefetch),
            apply=lambda v: float(loader.set_prefetch(int(v)))))
        if getattr(loader, '_device_stage', None) is not None:
            knobs.append(Knob(
                'loader_device_buffer',
                'device decode-tail ring depth (decode programs dispatched '
                'ahead of the train step)',
                minimum=1.0, maximum=16.0, step=1.0, cost='cheap',
                stages=('d2d_wait', 'h2d'), unit='batches',
                get=lambda: float(loader.device_buffer_depth),
                apply=lambda v: float(loader.set_device_buffer_depth(int(v)))))
    capacity = int(getattr(loader, '_shuffling_queue_capacity', 0) or 0)
    if capacity <= 0:
        return knobs

    def current() -> float:
        value = getattr(loader, '_min_after_retrieve', None)
        return float(capacity // 2 if value is None else value)

    def apply(value: float) -> float:
        # the loader's producer thread hands the value to its live buffer
        # before its next retrieve check (the buffer is not thread-safe)
        applied = max(0, min(int(value), capacity))
        loader._min_after_retrieve = applied
        return float(applied)

    knobs.append(Knob(
        'loader_min_after_retrieve',
        'shuffle-buffer decorrelation floor (fill threshold before retrieve)',
        minimum=0.0, maximum=float(capacity),
        step=float(max(1, capacity // 8)), cost='cheap',
        stages=('shuffle_wait',), unit='rows', get=current, apply=apply))
    return knobs


def build_service_knobs(scheduler: Any) -> List[Knob]:
    """Knobs for a live service
    :class:`~petastorm_tpu_torch.service.dispatcher.FairShareScheduler`: the
    admission-window cap and the live per-client in-flight depth (both via
    the scheduler's bounded setters)."""
    knobs: List[Knob] = []
    initial = float(scheduler.admission_window)
    if hasattr(scheduler, 'set_admission_window'):
        knobs.append(Knob(
            'service_admission_window',
            'per-client admission cap (queued + assigned) before busy',
            minimum=1.0, maximum=max(64.0, initial * 4),
            step=max(1.0, initial / 4), cost='cheap', stages=(),
            unit='items',
            get=lambda: float(scheduler.admission_window),
            apply=lambda v: float(scheduler.set_admission_window(int(v)))))
    if hasattr(scheduler, 'set_client_windows'):
        knobs.append(Knob(
            'service_client_window',
            'live per-client in-flight depth (clamped by the admission cap)',
            minimum=1.0, maximum=max(64.0, initial * 4),
            step=max(1.0, initial / 4), cost='cheap', stages=(),
            unit='items',
            get=lambda: float(scheduler.effective_client_window()),
            apply=lambda v: float(scheduler.set_client_windows(int(v)))))
    return knobs
