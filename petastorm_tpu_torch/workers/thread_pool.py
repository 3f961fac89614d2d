"""Thread worker pool: Arrow's Parquet reader releases the GIL, so worker
threads overlap IO and decompression with the consumer, and nothing is
serialized across the worker/consumer boundary.

The worker count is elastic (:meth:`ThreadPool.set_workers_count`, the
autotuner's ``pool_workers`` knob): growing starts threads, shrinking parks
the excess ones at their next item boundary. The consumer's wait inside
:meth:`ThreadPool.get_results` is the ``pool_wait`` stage of the pool's
registry (``ThreadPool.telemetry``); the workers' stages ride each batch's
sidecar."""

import logging
import queue
import threading
import time
import traceback

from petastorm_tpu_torch.telemetry.registry import MetricsRegistry, telemetry_enabled
from petastorm_tpu_torch.workers import EmptyResultError, VentilatedItemProcessedMessage

logger = logging.getLogger(__name__)

DEFAULT_RESULTS_QUEUE_SIZE = 50
_STOP_SENTINEL = object()


class _WorkerError(object):
    def __init__(self, exc, tb):
        self.exc = exc
        self.tb = tb


class WorkerThread(threading.Thread):
    def __init__(self, pool, worker):
        super().__init__(daemon=True,
                         name='petastorm-tpu-torch-worker-{}'.format(worker.worker_id))
        self._pool = pool
        self._worker = worker

    def run(self):
        while True:
            # a worker whose id is beyond the active count parks here instead
            # of pulling work (the shrink half of set_workers_count)
            self._pool._await_active(self._worker.worker_id)
            item = self._pool._ventilator_queue.get()
            if item is _STOP_SENTINEL:
                break
            try:
                self._worker.process(**item)
                self._pool._put_result(VentilatedItemProcessedMessage())
            except Exception as exc:  # noqa: BLE001 - re-raised in the consumer
                self._pool._put_result(_WorkerError(exc, traceback.format_exc()))
        self._worker.shutdown()


class ThreadPool(object):
    """N worker threads, each owning a worker instance; the bounded results
    queue gives backpressure. :meth:`set_workers_count` grows the pool to at
    most ``4 * workers_count``."""

    def __init__(self, workers_count, results_queue_size=DEFAULT_RESULTS_QUEUE_SIZE):
        self.workers_count = workers_count
        self._max_workers_count = 4 * workers_count
        self._results_queue = queue.Queue(results_queue_size)
        self._ventilator_queue = queue.Queue()
        self._threads = []
        self._ventilator = None
        self._stopped = threading.Event()
        # _active_workers worker ids may pull work; higher ids park on
        # _resize_cond. The worker class and args are kept so growth past the
        # spawned set can start fresh threads mid-epoch.
        self._resize_cond = threading.Condition()
        self._active_workers = workers_count
        self._worker_class = None
        self._worker_args = None
        #: consumer-side telemetry: ``pool_wait``, the time the consumer spent
        #: inside get_results per result
        self.telemetry = MetricsRegistry()

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._threads:
            raise RuntimeError('ThreadPool already started')
        self._worker_class = worker_class
        self._worker_args = worker_args
        for worker_id in range(self.workers_count):
            self._spawn_worker_thread(worker_id)
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def _spawn_worker_thread(self, worker_id):
        thread = WorkerThread(self, self._worker_class(worker_id, self._put_result,
                                                       self._worker_args))
        self._threads.append(thread)
        thread.start()

    def _await_active(self, worker_id):
        """Park the calling worker thread while its id is beyond the active
        count and the pool runs."""
        with self._resize_cond:
            while worker_id >= self._active_workers and not self._stopped.is_set():
                self._resize_cond.wait(timeout=0.5)

    def set_workers_count(self, value):
        """Thread-safe runtime resize of the worker set, clamped to ``[1,
        max_workers_count]``: growing beyond the threads already spawned
        starts fresh ones, shrinking parks the excess at their next item
        boundary (an item in progress always completes). Returns the applied
        value (the current count after ``stop()``)."""
        value = max(1, min(int(value), self._max_workers_count))
        with self._resize_cond:
            if self._stopped.is_set() or self._worker_class is None:
                return self._active_workers
            for worker_id in range(len(self._threads), value):
                self._spawn_worker_thread(worker_id)
            self._active_workers = value
            self.workers_count = value
            self._resize_cond.notify_all()
        return value

    def ventilate(self, **kwargs):
        """Enqueue one work item (the worker's ``process`` keyword arguments)."""
        self._ventilator_queue.put(kwargs)

    def _put_result(self, result):
        """Stop-aware bounded put: a worker never blocks forever against a
        stopped consumer."""
        while not self._stopped.is_set():
            try:
                self._results_queue.put(result, timeout=0.1)
                return
            except queue.Full:
                continue

    def get_results(self):
        """Next result payload; raises EmptyResultError once all ventilated work
        finished and the queue drained, or once the pool was stopped with the
        queue empty (a stopped ventilator never completes, and a consumer
        waiting here must still return); re-raises worker exceptions."""
        wait_start = time.perf_counter()
        while True:
            try:
                result = self._results_queue.get_nowait()
            except queue.Empty:
                if self._stopped.is_set():
                    raise EmptyResultError()
                if self._ventilator is not None and self._ventilator.error is not None:
                    self.stop()
                    raise self._ventilator.error
                if self._ventilator is not None and self._ventilator.completed():
                    raise EmptyResultError()
                try:
                    result = self._results_queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            if isinstance(result, VentilatedItemProcessedMessage):
                if self._ventilator is not None:
                    self._ventilator.processed_item()
                continue
            if isinstance(result, _WorkerError):
                self.stop()
                logger.error('Worker failure re-raised in consumer:\n%s', result.tb)
                raise result.exc
            if telemetry_enabled():
                self.telemetry.observe('pool_wait', time.perf_counter() - wait_start)
            return result

    def stop(self):
        self._stopped.set()
        with self._resize_cond:
            # wake parked workers so they can take their sentinel
            self._resize_cond.notify_all()
        if self._ventilator is not None:
            self._ventilator.stop()
        for _ in self._threads:
            self._ventilator_queue.put(_STOP_SENTINEL)

    def join(self):
        if not self._stopped.is_set():
            raise RuntimeError('join() must be preceded by stop()')
        for thread in self._threads:
            thread.join(timeout=30)
        self._threads = []
