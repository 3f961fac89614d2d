"""The port's autotuner against the JAX package's: one scripted control loop
(metric, snapshots and breaker states on an injected clock, fake knobs)
gives the same decision log in both; the knob builders give the same ids and
bounds for the same reader and loader configurations; each new actuator
(the ventilator's window, the elastic thread pool, the decode thread fan-out,
the shm ring shape, the shuffle buffer's floor, the decode tail's wait) is
held against its JAX counterpart; and a live ``autotune=`` reader, alone and
under a loader, delivers every row of every epoch once."""

import contextlib
import threading
import time
import types

import numpy as np
import pytest

import petastorm_tpu as jax_pkg
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu.autotune import controller as jax_controller
from petastorm_tpu.autotune import knobs as jax_knobs
from petastorm_tpu.autotune import policy as jax_policy
from petastorm_tpu.parallel.loader import JaxDataLoader
from petastorm_tpu.parallel.shuffling_buffer import \
    RandomShufflingBuffer as JaxRandomShufflingBuffer
from petastorm_tpu.workers.process_pool import ProcessPool as JaxProcessPool
from petastorm_tpu.workers.ventilator import ConcurrentVentilator as JaxVentilator
from petastorm_tpu_torch import TransformSpec, codecs, make_batch_reader, make_reader
from petastorm_tpu_torch.autotune import controller, knobs, policy
from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.parallel.shuffling_buffer import RandomShufflingBuffer
from petastorm_tpu_torch.workers.process_pool import ProcessPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

ROWS = 64
FILES = 8


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows in 8 files of one rowgroup: ``id`` and a float32 (8,) ``vec``."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Tuned', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    rng = np.random.RandomState(9)
    url = 'file://' + str(tmp_path_factory.mktemp('tune') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': rng.randn(8).astype(np.float32)}
                             for i in range(ROWS)], n_files=FILES, rowgroup_size_mb=1)
    return url


@pytest.fixture(autouse=True)
def no_event_log(monkeypatch):
    """Decisions go to the in-memory log only."""
    monkeypatch.delenv('PETASTORM_TPU_TELEMETRY_JSONL', raising=False)


def _hist(seconds):
    return {'unit': 1e-6, 'count': 10, 'sum': seconds, 'max': seconds}


class _Script(object):
    """A scripted pipeline: per window, the rows it delivered, the stage
    seconds it recorded, and whether a breaker was open. The rate responds to
    the knobs, so commits and reverts both happen."""

    WINDOWS = 26

    def __init__(self, knob_values):
        self.knobs = knob_values
        self.window = 0
        self.rows = 0.0
        self.cumulative = {}

    def clock(self):
        return float(self.window)

    def advance(self):
        self.window += 1
        rate = 100.0 + 15.0 * self.knobs['decode_threads'] - 4.0 * abs(
            self.knobs['ventilator_max_in_flight'] - 6)
        self.rows += rate
        decode_heavy = (self.window // 5) % 2 == 0
        for stage, seconds in (('decode', 3.0 if decode_heavy else 0.5),
                               ('pool_wait', 0.4 if decode_heavy else 2.0),
                               ('cache_miss', 9.0), ('rowgroup_read', 0.3)):
            old = self.cumulative.get(stage, {'count': 0, 'sum': 0.0})
            self.cumulative[stage] = dict(_hist(old['sum'] + seconds),
                                          count=old['count'] + 10)

    def metric(self):
        return self.rows

    def snapshot(self):
        return {'histograms': {k: dict(v) for k, v in self.cumulative.items()},
                'counters': {}, 'gauges': {}}

    def breakers(self):
        if 14 <= self.window <= 15:
            return {'fs:/data': {'state': 'open'}}
        return {}


def _fake_knobs(knob_module, values):
    def knob(knob_id, minimum, maximum, step, stages):
        def apply(value):
            values[knob_id] = max(minimum, min(maximum, int(value)))
            return float(values[knob_id])
        return knob_module.Knob(knob_id, 'scripted', minimum=minimum, maximum=maximum,
                                step=step, cost='cheap', stages=stages,
                                get=lambda: float(values[knob_id]), apply=apply)
    return knob_module.KnobCatalog([
        knob('decode_threads', 1.0, 6.0, 1.0, ('decode',)),
        knob('ventilator_max_in_flight', 1.0, 12.0, 2.0, ('pool_wait', 'shuffle_wait')),
        knob_module.Knob('shm_slots_per_worker', 'never climbed', minimum=1.0,
                         maximum=8.0, step=1.0, cost='deferred', stages=('decode',),
                         get=lambda: 4.0, apply=lambda value: value)])


def _run(knob_module, controller_module, policy_module, **policy_kwargs):
    values = {'decode_threads': 2, 'ventilator_max_in_flight': 4}
    script = _Script(values)
    ctl = controller_module.AutotuneController(
        _fake_knobs(knob_module, values), metric_fn=script.metric,
        snapshot_fn=script.snapshot,
        policy=policy_module.AutotunePolicy(**policy_kwargs),
        breaker_snapshot_fn=script.breakers, clock=script.clock)
    steps = []
    for _ in range(_Script.WINDOWS):
        steps.append(ctl.step())
        script.advance()
    report = ctl.report()
    report.pop('controller_step_seconds')
    return steps, report, values


@pytest.mark.parametrize('policy_kwargs', [
    dict(window_s=1.0, warmup_windows=1, hold_windows=1, cooldown_windows=2),
    dict(window_s=1.0, warmup_windows=0, hold_windows=0, cooldown_windows=1,
         min_improvement=0.1, freeze_cooldown_windows=3),
    dict(window_s=1.0, warmup_windows=0, knob_ids=('ventilator_max_in_flight',))])
def test_the_scripted_loop_gives_the_jax_decision_log(policy_kwargs):
    steps, report, values = _run(knobs, controller, policy, **policy_kwargs)
    jax_steps, jax_report, jax_values = _run(jax_knobs, jax_controller, jax_policy,
                                             **policy_kwargs)
    assert steps == jax_steps
    assert report == jax_report
    assert values == jax_values
    actions = [d['action'] for d in report['decisions']]
    assert 'propose' in actions and 'freeze' in actions and 'unfreeze' in actions
    assert all(d['knob'] != 'shm_slots_per_worker' for d in report['decisions'])
    for knob_id, knob in report['knobs'].items():
        assert knob['min'] <= knob['value'] <= knob['max'], knob_id


def test_choose_and_delta_match_jax():
    script = _Script({'decode_threads': 1, 'ventilator_max_in_flight': 6})
    script.advance()
    prev = script.snapshot()
    for _ in range(6):
        script.advance()
    cur = script.snapshot()
    assert controller.snapshot_delta(prev, cur) == jax_controller.snapshot_delta(prev, cur)
    values = {'decode_threads': 1, 'ventilator_max_in_flight': 6}
    eligible = _fake_knobs(knobs, values).knobs()
    jax_eligible = _fake_knobs(jax_knobs, values).knobs()
    assert (controller.choose_from_bottleneck(prev, cur, 1.0, eligible)
            == jax_controller.choose_from_bottleneck(prev, cur, 1.0, jax_eligible)
            == 'decode_threads')
    assert policy.resolve_policy(None) is None and policy.resolve_policy(False) is None
    assert policy.resolve_policy(True) == policy.AutotunePolicy()
    with pytest.raises(ValueError):
        policy.resolve_policy('fast')
    with pytest.raises(ValueError):
        policy.AutotunePolicy(window_s=0)
    assert set(knobs.KNOB_IDS) == set(jax_knobs.KNOB_IDS) and len(knobs.KNOB_IDS) == 14


def _shape(knob_list):
    return {k.knob_id: (k.minimum, k.maximum, k.step, k.cost, k.stages, k.unit)
            for k in knob_list}


@pytest.mark.parametrize('pool,batched', [('dummy', False), ('thread', False),
                                          ('thread', True)])
def test_the_knob_builders_match_jax(store, pool, batched):
    kwargs = dict(reader_pool_type=pool, workers_count=2, num_epochs=1)
    jax_factory = jax_pkg.make_batch_reader if batched else jax_pkg.make_reader
    factory = make_batch_reader if batched else make_reader
    # a batch reader over a Unischema store warns that it emits stored values
    with pytest.warns(UserWarning) if batched else contextlib.nullcontext():
        jax_reader = jax_factory(store, **kwargs)
    with pytest.warns(UserWarning) if batched else contextlib.nullcontext():
        reader = factory(store, **kwargs)
    try:
        built = _shape(knobs.build_reader_knobs(reader))
        assert built == _shape(jax_knobs.build_reader_knobs(jax_reader))
        expected = {'ventilator_max_in_flight'}
        if pool == 'thread':
            expected.add('pool_workers')
        if not batched:
            expected.add('decode_threads')
        assert set(built) == expected
        loader = TorchDataLoader(reader, batch_size=8, shuffling_queue_capacity=32,
                                 device='cpu')
        jax_loader = JaxDataLoader(jax_reader, batch_size=8, shuffling_queue_capacity=32)
        assert (_shape(knobs.build_loader_knobs(loader))
                == _shape(jax_knobs.build_loader_knobs(jax_loader)))
        host = TorchDataLoader(reader, batch_size=8, device='cpu', device_put=False)
        jax_host = JaxDataLoader(jax_reader, batch_size=8, device_put=False)
        assert (_shape(knobs.build_loader_knobs(host))
                == _shape(jax_knobs.build_loader_knobs(jax_host)) == {})
    finally:
        for r in (reader, jax_reader):
            r.stop()
            r.join()


def test_the_process_pool_knobs_and_ring_shape_match_jax():
    """Unstarted pools: the deferred shm knobs and their setter's clamps."""
    pool, jax_pool = ProcessPool(2), JaxProcessPool(2)
    ventilator = ConcurrentVentilator(lambda **kw: None, [{}] * 3,
                                      max_ventilation_queue_size=4)
    jax_ventilator = JaxVentilator(lambda **kw: None, [{}] * 3,
                                   max_ventilation_queue_size=4)
    reader = types.SimpleNamespace(_ventilator=ventilator, _pool=pool)
    jax_reader = types.SimpleNamespace(_ventilator=jax_ventilator, _pool=jax_pool)
    built = _shape(knobs.build_reader_knobs(reader))
    assert built == _shape(jax_knobs.build_reader_knobs(jax_reader))
    assert set(built) == {'ventilator_max_in_flight', 'shm_slots_per_worker',
                          'shm_slot_bytes'}
    for kwargs in ({'slots_per_worker': 8}, {'slot_bytes': 1 << 20},
                   {'slots_per_worker': 2, 'slot_bytes': 65536}, {}):
        assert pool.set_shm_slot_config(**kwargs) == jax_pool.set_shm_slot_config(**kwargs)
    for bad in ({'slots_per_worker': 0}, {'slot_bytes': 100}):
        with pytest.raises(ValueError):
            pool.set_shm_slot_config(**bad)
        with pytest.raises(ValueError):
            jax_pool.set_shm_slot_config(**bad)


def test_the_ventilator_window_matches_jax():
    fed = []
    ventilators = [ConcurrentVentilator(lambda **kw: fed.append(kw), [{'i': i} for i in range(6)],
                                        max_ventilation_queue_size=1),
                   JaxVentilator(lambda **kw: None, [{'i': i} for i in range(6)],
                                 max_ventilation_queue_size=1)]
    for v in ventilators:
        assert v.max_in_flight == 1
        assert v.set_max_in_flight(5) == 5 and v.max_in_flight == 5
        with pytest.raises(ValueError):
            v.set_max_in_flight(0)
    port = ventilators[0]
    port.set_max_in_flight(1)
    port.start()
    try:
        deadline = time.monotonic() + 10
        while len(fed) < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        assert len(fed) == 1          # the window holds the second item back
        port.set_max_in_flight(3)     # growing wakes the ventilation thread
        while len(fed) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(fed) == 3
    finally:
        port.stop()


def _slow_row(row):
    time.sleep(0.002)
    return row


def test_the_elastic_thread_pool_delivers_every_row_once(store):
    with make_reader(store, reader_pool_type='thread', workers_count=1, num_epochs=2,
                     transform_spec=TransformSpec(_slow_row)) as reader:
        pool = reader._pool
        assert isinstance(pool, ThreadPool) and pool._max_workers_count == 4
        ids = []
        for i, row in enumerate(reader):
            ids.append(int(row.id))
            if i == 10:
                assert pool.set_workers_count(3) == 3 and pool.workers_count == 3
            if i == 50:
                assert pool.set_workers_count(99) == 4
            if i == 80:
                assert pool.set_workers_count(0) == 1
        threads = len(pool._threads)
    assert sorted(ids) == sorted(list(range(ROWS)) * 2)
    assert threads == 4
    assert pool.set_workers_count(2) == 1   # stopped: no resize


class _Echo(object):
    """A worker that publishes what it is given."""

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func

    def process(self, value):
        self.publish_func(value)

    def shutdown(self):
        pass


def test_the_thread_pools_resize_matches_jax():
    from petastorm_tpu.workers.thread_pool import ThreadPool as JaxThreadPool
    pools = [ThreadPool(2), JaxThreadPool(2)]
    applied = []
    for pool in pools:
        assert pool.set_workers_count(3) == 2    # not started: no resize
        pool.start(_Echo)
        sizes = [pool.set_workers_count(v) for v in (3, 99, 0, 5)]
        for value in range(6):
            pool.ventilate(value=value)
        results = sorted(pool.get_results() for _ in range(6))
        threads = len(pool._threads)
        pool.stop()
        pool.join()
        applied.append((sizes, results, threads, pool.set_workers_count(4)))
    assert applied[0] == applied[1] == ([3, 8, 1, 5], list(range(6)), 8, 5)


def test_the_decode_fan_out_matches_jax(monkeypatch):
    for env in (None, '1', '3', '0'):
        if env is None:
            monkeypatch.delenv('PETASTORM_TPU_DECODE_THREADS', raising=False)
        else:
            monkeypatch.setenv('PETASTORM_TPU_DECODE_THREADS', env)
        assert codecs.decode_thread_count() == jax_codecs.decode_thread_count()
    first = codecs._decode_pool(2)
    assert codecs._decode_pool(2) is first
    assert codecs._decode_pool(3) is not first
    # the fanned-out image decode gives the serial decode's arrays
    import pyarrow as pa
    from petastorm_tpu_torch.unischema import UnischemaField
    field = UnischemaField('img', np.uint8, (6, 5, 3), codecs.CompressedImageCodec('png'),
                           False)
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 255, (6, 5, 3), dtype=np.uint8) for _ in range(40)]
    column = pa.array([field.codec.encode(field, image) for image in images], pa.binary())
    monkeypatch.setenv('PETASTORM_TPU_DECODE_THREADS', '4')
    fanned = field.codec.decode_arrow_column(field, column)
    monkeypatch.setenv('PETASTORM_TPU_DECODE_THREADS', '1')
    serial = field.codec.decode_arrow_column(field, column)
    for got, want, image in zip(fanned, serial, images):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, image)


def test_the_buffer_floor_and_the_decode_tail_wait():
    for buffer in (RandomShufflingBuffer(10, 4), JaxRandomShufflingBuffer(10, 4)):
        assert [buffer.set_min_after_retrieve(v) for v in (7, -3, 25, 2)] == [7, 0, 10, 2]
    from petastorm_tpu_torch.parallel.device_stage import DeviceDecodeStage
    assert DeviceDecodeStage.throttle(types.SimpleNamespace(), None) == 0.0


def test_a_live_autotuned_reader_delivers_every_row_once(store):
    tuned = policy.AutotunePolicy(window_s=0.02, warmup_windows=0, hold_windows=0,
                                  cooldown_windows=1, min_improvement=0.0)
    with make_reader(store, reader_pool_type='thread', workers_count=2, num_epochs=3,
                     shuffle_rows=True, seed=5, transform_spec=TransformSpec(_slow_row),
                     autotune=tuned) as reader:
        epochs = [[], [], []]
        for batch in reader.iter_columnar():
            epochs[batch.item_id[0]].extend(int(i) for i in batch.columns['id'])
        report = reader.autotune_report()
        diag = reader.diagnostics
    for epoch in epochs:
        assert sorted(epoch) == list(range(ROWS))
    assert report['enabled'] and report['windows'] >= 2
    assert any(d['action'] == 'propose' for d in report['decisions'])
    assert set(report['knobs']) == {'ventilator_max_in_flight', 'pool_workers',
                                    'decode_threads'}
    for knob_id, knob in report['knobs'].items():
        assert knob['min'] <= knob['value'] <= knob['max'], knob_id
    assert not report['frozen_by_breaker'] and not diag['breakers']
    assert diag['autotune']['controller'] == 'reader'


def test_a_loader_adds_its_knobs_and_a_turned_floor_keeps_every_row(store):
    tuned = policy.AutotunePolicy(window_s=0.05, warmup_windows=1, hold_windows=1)
    with make_reader(store, reader_pool_type='thread', workers_count=2, num_epochs=2,
                     autotune=tuned) as reader:
        loader = TorchDataLoader(reader, batch_size=8, shuffling_queue_capacity=32,
                                 seed=1, device='cpu', drop_last=False)
        catalog = reader._autotune.catalog
        assert {'loader_prefetch', 'loader_min_after_retrieve'} <= set(catalog.ids())
        floor = catalog.knob('loader_min_after_retrieve')
        prefetch = catalog.knob('loader_prefetch')
        ids = []
        stop = threading.Event()

        def turn():
            values = [0, 32, 8, 24, 16]
            i = 0
            while not stop.wait(0.001):
                floor.apply(values[i % len(values)])
                prefetch.apply(1 + i % 3)
                i += 1

        turner = threading.Thread(target=turn, daemon=True)
        turner.start()
        try:
            for batch in loader:
                ids.extend(batch['id'].tolist())
        finally:
            stop.set()
            turner.join(timeout=10)
    assert not turner.is_alive()
    assert sorted(ids) == sorted(list(range(ROWS)) * 2)
    assert floor.get() in (0.0, 8.0, 16.0, 24.0, 32.0)
