"""Thread worker pool: Arrow's Parquet reader releases the GIL, so worker
threads overlap IO and decompression with the consumer, and nothing is
serialized across the worker/consumer boundary."""

import logging
import queue
import threading
import traceback

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
    queue gives backpressure."""

    def __init__(self, workers_count, results_queue_size=DEFAULT_RESULTS_QUEUE_SIZE):
        self.workers_count = workers_count
        self._results_queue = queue.Queue(results_queue_size)
        self._ventilator_queue = queue.Queue()
        self._threads = []
        self._ventilator = None
        self._stopped = threading.Event()

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._threads:
            raise RuntimeError('ThreadPool already started')
        for worker_id in range(self.workers_count):
            thread = WorkerThread(self, worker_class(worker_id, self._put_result,
                                                     worker_args))
            self._threads.append(thread)
            thread.start()
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

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
            return result

    def stop(self):
        self._stopped.set()
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
