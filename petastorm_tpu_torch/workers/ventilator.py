"""Work ventilation with bounded in-flight items and per-epoch reshuffling: the
ventilator feeds rowgroup work items into a pool at a bounded rate, every
epoch, optionally in a new seeded order. The seeded order is the same
``numpy.random.RandomState`` stream ``petastorm_tpu`` draws, so both packages
visit rowgroups in the same order for the same seed."""

import threading

import numpy as np


class Ventilator(object):
    """The ventilator interface a pool drives: ``start``, ``processed_item``
    (the consumer finished one item: backpressure accounting), ``completed``
    (no item will ever be ventilated again) and ``stop``."""

    def __init__(self, ventilate_fn):
        self._ventilate_fn = ventilate_fn

    def start(self):
        raise NotImplementedError()

    def processed_item(self):
        raise NotImplementedError()

    def completed(self):
        raise NotImplementedError()

    def stop(self):
        raise NotImplementedError()


class ConcurrentVentilator(Ventilator):
    """Feeds ``items_to_ventilate`` (list of kwargs dicts) from a daemon thread,
    keeping at most ``max_ventilation_queue_size`` items in flight, for
    ``iterations`` epochs (None = forever), shuffling the item order each epoch
    when ``randomize_item_order``. Every ventilated call gets an
    ``epoch_index`` keyword carrying the absolute epoch (``pre_shuffle_count``
    + completed passes).

    Resume from a checkpoint: the RNG stream is advanced by
    ``pre_shuffle_count`` epoch shuffles (the item order of the epoch being
    resumed is that of the uninterrupted run); items whose ``item_id_fn(item)``
    is in ``skip_ids_by_iteration[k]`` are skipped in the k-th pass after
    construction (they were consumed before the checkpoint; results can
    straddle epochs, hence one set per pass). ``reset_iterations`` is what
    :meth:`reset` restores (default ``iterations``; a resumed reader passes its
    full ``num_epochs``). ``order_fn(items, random_state) -> items`` (a cost
    scheduler's :meth:`~petastorm_tpu_torch.schedule.CostAwareScheduler.order_items`)
    replaces the seeded shuffle at every reorder point, epoch starts and
    resume pre-shuffles alike, consuming the RNG stream as the shuffle does."""

    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 max_ventilation_queue_size=None, randomize_item_order=False,
                 random_seed=None, pre_shuffle_count=0, skip_ids_by_iteration=None,
                 item_id_fn=None, reset_iterations=None, order_fn=None):
        if iterations is not None and (not isinstance(iterations, int) or iterations < 1):
            raise ValueError('iterations must be a positive integer or None, got {!r}'
                             .format(iterations))
        super().__init__(ventilate_fn)
        self._items_to_ventilate = list(items_to_ventilate)
        self._iterations = iterations
        self._iterations_remaining = iterations
        self._reset_iterations = (reset_iterations if reset_iterations is not None
                                  else iterations)
        self._max_ventilation_queue_size = (max_ventilation_queue_size
                                            or len(self._items_to_ventilate) or 1)
        self._randomize_item_order = randomize_item_order
        self._random_state = np.random.RandomState(random_seed)
        self._order_fn = order_fn
        if randomize_item_order:
            for _ in range(pre_shuffle_count):
                self._reorder()
        self._skip_ids_by_iteration = {int(k): set(v)
                                       for k, v in (skip_ids_by_iteration or {}).items()}
        self._item_id_fn = item_id_fn or (lambda item: None)
        self._pass_offset = 0
        self._absolute_epoch = pre_shuffle_count
        self._in_flight = 0
        self._current_item_to_ventilate = 0
        self._stop_requested = threading.Event()
        self._completed = threading.Event()
        self._lock = threading.Lock()
        self._item_processed = threading.Condition(self._lock)
        self._thread = None
        #: exception raised by ventilate_fn, surfaced to the consumer via pools
        self.error = None
        if not self._items_to_ventilate:
            self._completed.set()

    def start(self):
        if self._thread is not None:
            raise RuntimeError('Ventilator already started')
        self._thread = threading.Thread(target=self._ventilate, daemon=True,
                                        name='petastorm-tpu-torch-ventilator')
        self._thread.start()

    def _reorder(self):
        """One epoch's reorder: ``order_fn`` when set, else the seeded shuffle
        in place."""
        if self._order_fn is not None:
            self._items_to_ventilate = list(
                self._order_fn(self._items_to_ventilate, self._random_state))
        else:
            self._random_state.shuffle(self._items_to_ventilate)

    def _ventilate(self):
        if self._randomize_item_order:
            self._reorder()
        while not self._stop_requested.is_set():
            if self._completed.is_set():
                return
            item = self._items_to_ventilate[self._current_item_to_ventilate]
            skip_ids = self._skip_ids_by_iteration.get(self._pass_offset)
            skip = bool(skip_ids) and self._item_id_fn(item) in skip_ids
            if not skip:
                with self._item_processed:
                    while (self._in_flight >= self._max_ventilation_queue_size
                           and not self._stop_requested.is_set()):
                        self._item_processed.wait(timeout=0.1)
                    if self._stop_requested.is_set():
                        return
                    self._in_flight += 1
            self._current_item_to_ventilate += 1
            try:
                if not skip:
                    self._ventilate_fn(epoch_index=self._absolute_epoch, **item)
            except Exception as exc:  # noqa: BLE001 - surfaced to the consumer
                self.error = exc
                self._completed.set()
                return
            if self._current_item_to_ventilate >= len(self._items_to_ventilate):
                self._current_item_to_ventilate = 0
                self._skip_ids_by_iteration.pop(self._pass_offset, None)
                self._pass_offset += 1
                self._absolute_epoch += 1
                if self._iterations_remaining is not None:
                    self._iterations_remaining -= 1
                    if self._iterations_remaining <= 0:
                        self._completed.set()
                        return
                if self._randomize_item_order:
                    self._reorder()

    def processed_item(self):
        """Consumer feedback: one ventilated item finished."""
        with self._item_processed:
            if self._in_flight > 0:
                self._in_flight -= 1
            self._item_processed.notify()

    @property
    def max_in_flight(self):
        """The current in-flight bound."""
        with self._lock:
            return self._max_ventilation_queue_size

    def set_max_in_flight(self, value):
        """Thread-safe runtime resize of the in-flight window (the autotuner's
        ``ventilator_max_in_flight`` knob): growing wakes the ventilation
        thread at once, shrinking admits no new item until consumption drains
        below the new bound (items in flight are never recalled). Returns the
        applied value."""
        value = int(value)
        if value < 1:
            raise ValueError('max_in_flight must be >= 1, got {}'.format(value))
        with self._item_processed:
            self._max_ventilation_queue_size = value
            self._item_processed.notify_all()
        return value

    def completed(self):
        """True once every epoch was dispatched and every item acknowledged."""
        with self._lock:
            if self.error is not None:
                return True
            return self._completed.is_set() and self._in_flight == 0

    def reset(self):
        """Restart ventilation for another ``reset_iterations`` epochs after
        the previous ones fully completed; the RNG stream and the absolute
        epoch continue."""
        if not self.completed():
            raise RuntimeError('Cannot reset a ventilator that has not completed all '
                               'items (in-flight work remains)')
        self._join_thread()
        self._completed.clear()
        self._stop_requested.clear()
        self._current_item_to_ventilate = 0
        self._iterations_remaining = self._reset_iterations
        self._thread = None
        self.start()

    def stop(self):
        self._stop_requested.set()
        with self._item_processed:
            self._item_processed.notify_all()
        self._join_thread()

    def _join_thread(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=10)
