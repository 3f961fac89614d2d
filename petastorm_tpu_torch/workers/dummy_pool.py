"""Single-threaded pool: ventilated items run lazily on the caller's thread
inside ``get_results`` (deterministic order, for tests and debugging)."""

import time
from collections import deque

from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.workers import EmptyResultError, VentilatedItemProcessedMessage


class DummyPool(object):
    """Zero-parallelism pool: each ventilated item is processed synchronously
    inside ``get_results``."""

    def __init__(self):
        self._ventilator_queue = deque()
        self._results = deque()
        self._worker = None
        self._ventilator = None
        self.workers_count = 1
        #: the pools' uniform telemetry surface; items run inline, so there is
        #: no consumer wait to measure (the worker's stages ride its sidecar)
        self.telemetry = MetricsRegistry()

    def start(self, worker_class, worker_args=None, ventilator=None):
        self._worker = worker_class(0, self._results.append, worker_args)
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def ventilate(self, **kwargs):
        self._ventilator_queue.append(kwargs)

    def get_results(self):
        while True:
            while self._results:
                result = self._results.popleft()
                if isinstance(result, VentilatedItemProcessedMessage):
                    continue
                return result
            if self._ventilator_queue:
                self._worker.process(**self._ventilator_queue.popleft())
                if self._ventilator is not None:
                    self._ventilator.processed_item()
                continue
            if self._ventilator is not None and self._ventilator.error is not None:
                raise self._ventilator.error
            if self._ventilator is None or self._ventilator.completed():
                raise EmptyResultError()
            # the ventilator thread may still be feeding
            time.sleep(0.005)

    def stop(self):
        if self._ventilator is not None:
            self._ventilator.stop()
        if self._worker is not None:
            self._worker.shutdown()

    def join(self):
        pass
