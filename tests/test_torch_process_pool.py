"""The port's process pool (``reader_pool_type='process'``) against the JAX
package's readers on the same seeded stores: one worker gives the JAX process
pool's row order, two workers the same rows (rows, a batch reader with a
``TransformSpec``, NGram windows, the local-disk cache); ``on_error='skip'``
quarantines a corrupt file as the JAX reader does; faults injected through the
JAX package's ``fault_injecting_filesystem`` are retried, respawned or
quarantined; loader and JAX states resume a process-pool reader; the pool falls
back to frames when ``/dev/shm`` is too small and raises, naming the object,
when a user object cannot reach its workers.

The module imports neither torch nor the JAX package at its top: a
``TransformSpec`` function defined here is pickled by reference, so the
spawned workers import this module."""

import glob
import os
import subprocess
import sys
from collections import Counter, namedtuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu_torch import NGram, TransformSpec, make_batch_reader, make_reader
from petastorm_tpu_torch.resilience import RetryPolicy
from petastorm_tpu_torch.workers.shm_ring import SHM_DIR

ROWS = 64
FILES = 8
FAST_RETRIES = dict(max_attempts=3, backoff_base_s=0.01, max_backoff_s=0.05)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows in 8 files of one rowgroup: ``id`` and a float32 (8,) ``vec``."""
    return _write_store(tmp_path_factory.mktemp('pool') / 'store')


def _write_store(path):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('PoolProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    rng = np.random.RandomState(11)
    url = 'file://' + str(path)
    write_rows(url, schema, [{'id': i, 'vec': rng.randn(8).astype(np.float32)}
                             for i in range(ROWS)], n_files=FILES, rowgroup_size_mb=1)
    return url


def _part_files(url):
    return sorted(glob.glob(os.path.join(url[len('file://'):], '**', '*.parquet'),
                            recursive=True))


def _rows(reader):
    return [(int(row.id), row.vec.tobytes()) for row in reader]


def _gone(pool):
    return pool.ring_name is not None and not os.path.exists(
        os.path.join(SHM_DIR, pool.ring_name))


def _faulty_fs(tmp_path, rules):
    from petastorm_tpu.test_util.fault_injection import (FaultSchedule,
                                                         fault_injecting_filesystem)
    return fault_injecting_filesystem(FaultSchedule(str(tmp_path / 'faults'), rules))


def test_importing_the_reader_or_the_worker_loads_no_torch():
    code = ('import sys\n'
            'import petastorm_tpu_torch.reader, petastorm_tpu_torch.ngram_worker\n'
            'import petastorm_tpu_torch.workers.process_pool\n'
            'import petastorm_tpu_torch.workers.process_worker_main\n'
            'from petastorm_tpu_torch import make_reader, make_batch_reader, NGram\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] == "torch"))\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'


def test_one_worker_gives_the_jax_process_pools_order(store):
    from petastorm_tpu import make_reader as jax_make_reader
    kwargs = dict(workers_count=1, shuffle_row_groups=True, shuffle_rows=True, seed=3)
    # no JAX ring: the JAX package's own leak test diffs its segments in /dev/shm
    with jax_make_reader(store, reader_pool_type='process', shm_transport=False,
                         **kwargs) as reader:
        want = _rows(reader)
    with make_reader(store, reader_pool_type='thread', **kwargs) as reader:
        threads = _rows(reader)
    with make_reader(store, reader_pool_type='process', **kwargs) as reader:
        got = _rows(reader)
        diag = reader.diagnostics
        pool = reader._pool
    assert got == threads == want and len(got) == ROWS
    assert got != sorted(got)
    assert diag['shm_batches'] == diag['wire_batches'] == FILES
    assert (diag['shm_fallback_batches'], diag['shm_crc_failures'], diag['shm_stale_drops'],
            diag['results_dropped'], diag['workers_respawned']) == (0, 0, 0, 0, 0)
    assert _gone(pool)


def _plain_store(path):
    path.mkdir()
    for part in range(4):
        ids = np.arange(part * 16, part * 16 + 16)
        pq.write_table(pa.table({'id': ids, 'value': ids * 0.5}),
                       str(path / 'part_{}.parquet'.format(part)))
    return 'file://' + str(path)


def add_one(frame):
    """A batch reader's TransformSpec function (module level: it pickles)."""
    frame['value'] = frame['value'] + 1.0
    return frame


def _batch_rows(reader):
    batches = list(reader)
    return Counter(zip(*[np.concatenate([getattr(b, f) for b in batches]).tolist()
                         for f in ('id', 'value')]))


def _window_rows(reader):
    return [tuple((offset, int(window[offset].id)) for offset in sorted(window))
            for window in reader]


@pytest.mark.parametrize('flavor', ['batch_transform', 'ngram', 'cache'])
def test_two_workers_give_the_jax_rows(store, tmp_path, flavor):
    import petastorm_tpu as jax_pkg
    from petastorm_tpu.ngram import NGram as JaxNGram
    port_pool = dict(reader_pool_type='process', workers_count=2, seed=1)
    jax_pool = dict(reader_pool_type='dummy', seed=1)
    if flavor == 'batch_transform':
        url = _plain_store(tmp_path / 'plain')
        with jax_pkg.make_batch_reader(url, transform_spec=jax_pkg.TransformSpec(add_one),
                                       **jax_pool) as reader:
            want = _batch_rows(reader)
        with make_batch_reader(url, transform_spec=TransformSpec(add_one),
                               **port_pool) as reader:
            got = _batch_rows(reader)
            diag = reader.diagnostics
        assert got == want and sum(got.values()) == ROWS
        assert diag['shm_batches'] == 4
        return
    if flavor == 'ngram':
        fields = {0: ['id', 'vec'], 1: ['id'], 2: ['id']}
        with jax_pkg.make_reader(store, schema_fields=JaxNGram(fields, 1, 'id'),
                                 **jax_pool) as reader:
            want = Counter(_window_rows(reader))
        with make_reader(store, schema_fields=NGram(fields, 1, 'id'),
                         **port_pool) as reader:
            got = Counter(_window_rows(reader))
            diag = reader.diagnostics
        assert got == want and sum(got.values()) == ROWS - 2 * FILES
        assert diag['shm_batches'] == FILES
        return
    with jax_pkg.make_reader(store, **jax_pool) as reader:
        want = Counter(_rows(reader))
    cache = {}
    if flavor == 'cache':
        cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'cache'),
                     cache_size_limit=1 << 30)
    passes = []
    for _ in range(2 if cache else 1):
        with make_reader(store, **port_pool, **cache) as reader:
            passes.append((Counter(_rows(reader)), reader.diagnostics))
    for got, diag in passes:
        assert got == want and sum(got.values()) == ROWS
        assert diag['shm_batches'] == FILES and diag['shm_fallback_batches'] == 0
    if cache:
        # cache_hit crossed the wire with each batch
        assert [(d['cache_misses'], d['cache_hits']) for _, d in passes] == [(FILES, 0),
                                                                             (0, FILES)]


def _zero(path):
    size = os.path.getsize(path)
    with open(path, 'r+b') as f:
        f.write(bytes(size))


@pytest.mark.parametrize('damage', ['truncated', 'zeroed'])
def test_skip_quarantines_a_corrupt_file_as_jax_does(tmp_path, damage):
    """A truncated footer is quarantined when the rowgroups are enumerated; a
    zeroed file of the same size (the index still matches) in the worker, and
    its record crosses the process pool's wire."""
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu.test_util.fault_injection import corrupt_file
    url = _write_store(tmp_path / 'store')
    target = _part_files(url)[2]
    if damage == 'truncated':
        corrupt_file(target, 'truncate')
    else:
        _zero(target)
    records = []
    for factory, pool in ((jax_make_reader, 'thread'), (make_reader, 'process')):
        with factory(url, reader_pool_type=pool, workers_count=2, on_error='skip',
                     shuffle_row_groups=False) as reader:
            ids = sorted(int(row.id) for row in reader)
            diag = reader.diagnostics
        assert ids == [i for i in range(ROWS) if not 16 <= i < 24]
        assert diag['rowgroups_quarantined'] == 1
        records.append([dict(r, error=bool(r['error'])) for r in diag['quarantine']])
    assert records[0] == records[1]
    (record,) = records[1]
    assert (record['fragment_path'], record['reason'], record['piece_index']) == (
        target, 'error', 2)
    assert record['row_group_id'] == (None if damage == 'truncated' else 0)


def test_a_transient_open_fault_is_retried(store, tmp_path):
    from petastorm_tpu.test_util.fault_injection import FaultRule
    target = os.path.basename(_part_files(store)[3])
    with make_reader(store, reader_pool_type='process', workers_count=2, on_error='retry',
                     retry_policy=RetryPolicy(**FAST_RETRIES),
                     filesystem=_faulty_fs(tmp_path, [FaultRule(target, times=1)])) as reader:
        ids = sorted(int(row.id) for row in reader)
        diag = reader.diagnostics
    assert ids == list(range(ROWS))
    assert diag['io_retries'] == 1 and diag['rowgroups_quarantined'] == 0
    assert diag['breakers']['fs:' + os.path.dirname(_part_files(store)[3])]['failures'] == 1


def test_a_killed_worker_is_respawned_and_each_row_arrives_once(store, tmp_path):
    from petastorm_tpu.test_util.fault_injection import FaultRule
    target = os.path.basename(_part_files(store)[3])
    with make_reader(store, reader_pool_type='process', workers_count=2,
                     shuffle_row_groups=False,
                     filesystem=_faulty_fs(tmp_path, [FaultRule(target, kind='kill',
                                                                times=1)])) as reader:
        ids = [int(row.id) for row in reader]
        diag = reader.diagnostics
        pool = reader._pool
    assert sorted(ids) == list(range(ROWS))
    assert diag['workers_respawned'] == 1 and diag['workers_alive'] == 2
    assert _gone(pool)


def test_a_death_past_the_respawn_budget_fails_the_read(store, tmp_path):
    from petastorm_tpu.test_util.fault_injection import FaultRule
    from petastorm_tpu_torch.workers import WorkerTerminationError
    from petastorm_tpu_torch.workers.process_pool import ProcessPool
    target = os.path.basename(_part_files(store)[3])
    pool = ProcessPool(2, max_worker_respawns=0)
    with pytest.raises(WorkerTerminationError, match='respawn budget'):
        with make_reader(store, reader_pool=pool, shuffle_row_groups=False,
                         filesystem=_faulty_fs(tmp_path, [FaultRule(target, kind='kill',
                                                                    times=1)])) as reader:
            list(reader)
    assert _gone(pool)


def test_a_stopped_worker_is_reaped_by_its_stale_heartbeat(store, tmp_path):
    """A SIGSTOPped worker stamps no heartbeat into its ring word: the
    staleness reap kills it, and its replacement redoes its item."""
    from petastorm_tpu.test_util.fault_injection import FaultRule
    from petastorm_tpu_torch.workers.process_pool import ProcessPool
    target = os.path.basename(_part_files(store)[3])
    pool = ProcessPool(2, heartbeat_interval_s=0.1, hang_timeout_s=1.0)
    with make_reader(store, reader_pool=pool, shuffle_row_groups=False,
                     filesystem=_faulty_fs(tmp_path, [FaultRule(target, kind='hang',
                                                                hang_mode='stop',
                                                                times=1)])) as reader:
        ids = sorted(int(row.id) for row in reader)
        diag = reader.diagnostics
    assert ids == list(range(ROWS))
    assert (diag['workers_hung_reaped'], diag['workers_respawned'],
            diag['rowgroups_quarantined']) == (1, 1, 0)


def test_a_hung_rowgroup_is_quarantined_under_the_item_deadline(store, tmp_path):
    """The hang sleeps in the worker (heartbeats keep coming): the item
    deadline reaps the worker and, under 'skip', quarantines the rowgroup with
    reason 'hang' instead of dispatching it again."""
    from petastorm_tpu.test_util.fault_injection import FaultRule
    target = _part_files(store)[3]
    with make_reader(store, reader_pool_type='process', workers_count=2,
                     shuffle_row_groups=False, on_error='skip', item_deadline_s=3.0,
                     filesystem=_faulty_fs(tmp_path, [FaultRule(os.path.basename(target),
                                                                kind='hang',
                                                                times=1)])) as reader:
        ids = sorted(int(row.id) for row in reader)
        diag = reader.diagnostics
    assert ids == [i for i in range(ROWS) if not 24 <= i < 32]
    assert diag['workers_hung_reaped'] == 1 and diag['rowgroups_quarantined'] == 1
    (record,) = diag['quarantine']
    assert (record['reason'], record['error_type'], record['fragment_path'],
            record['piece_index']) == ('hang', 'WorkerHangError', target, 3)


def test_a_loader_state_after_a_respawn_resumes_to_the_rest_of_the_epoch(store, tmp_path):
    """The loader's delivery-exact state, taken after a worker was killed and
    respawned, resumes a new process-pool reader to exactly the rows not yet
    delivered."""
    from petastorm_tpu.test_util.fault_injection import FaultRule
    from petastorm_tpu_torch import TorchDataLoader
    target = os.path.basename(_part_files(store)[1])
    kwargs = dict(reader_pool_type='process', workers_count=2, seed=4,
                  shuffle_row_groups=False)
    # every open is slowed, so the redone item arrives before the epoch ends
    fs = _faulty_fs(tmp_path, [FaultRule(target, kind='kill', times=1),
                               FaultRule('.parquet', kind='latency', latency_s=0.2)])
    with make_reader(store, filesystem=fs, **kwargs) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu')
        first = []
        for batch in loader:
            first.append(batch['id'].tolist())
            if 8 in first[-1]:
                break       # the killed worker's item, redone by its replacement
        state = loader.state_dict()
        respawned = reader.diagnostics['workers_respawned']
    with make_reader(store, resume_state=state, **kwargs) as reader:
        rest = [b['id'].tolist() for b in TorchDataLoader(reader, batch_size=8,
                                                          device='cpu')]
    delivered = sorted(i for batch in first + rest for i in batch)
    assert respawned == 1
    assert delivered == list(range(ROWS))
    assert len(state['consumed_by_epoch'][0]) == len(first) < FILES


def test_a_jax_state_resumes_a_port_process_reader_to_the_same_rows(store):
    from petastorm_tpu import make_reader as jax_make_reader
    kwargs = dict(workers_count=1, shuffle_row_groups=True, seed=9)
    with jax_make_reader(store, reader_pool_type='dummy', **kwargs) as reader:
        head = [next(reader) for _ in range(21)]
        state = reader.state_dict()
        want = [(int(row.id), row.vec.tobytes()) for row in reader]
    with make_reader(store, reader_pool_type='process', resume_state=state,
                     **kwargs) as reader:
        got = _rows(reader)
    assert got == want and len(head) + len(got) == ROWS


_StatVfs = namedtuple('_StatVfs', 'f_bavail f_frsize')


def test_too_little_dev_shm_falls_back_to_frames_and_counts_it(store, monkeypatch):
    monkeypatch.setattr(os, 'statvfs', lambda path: _StatVfs(16, 4096))
    with make_reader(store, reader_pool_type='process', workers_count=2,
                     shuffle_row_groups=False) as reader:
        ids = sorted(int(row.id) for row in reader)
        diag = reader.diagnostics
    assert ids == list(range(ROWS))
    assert (diag['shm_enabled'], diag['shm_capacity_fallbacks'], diag['shm_batches']) == (
        False, 1, 0)
    assert diag['wire_batches'] == FILES and diag['pipe_result_bytes'] > 0
    from petastorm_tpu_torch.workers.shm_ring import ShmCapacityError
    with pytest.raises(ShmCapacityError):
        make_reader(store, reader_pool_type='process', workers_count=2, shm_transport=True)


def test_without_dill_a_lambda_raises_at_construction_and_is_named(store, monkeypatch):
    from petastorm_tpu_torch.predicates import in_lambda
    monkeypatch.setitem(sys.modules, 'dill', None)
    with pytest.raises(TypeError, match=r'transform_spec\.func.*lambda.*pickle'):
        make_batch_reader(_plain_store_once(store), reader_pool_type='process',
                          workers_count=2, transform_spec=TransformSpec(lambda f: f))
    with pytest.raises(TypeError, match='the predicate.*lambda'):
        make_reader(store, reader_pool_type='process', workers_count=2,
                    predicate=in_lambda(['id'], lambda i: i % 2 == 0))


def _plain_store_once(store):
    path = os.path.join(os.path.dirname(store[len('file://'):]), 'plain')
    if not os.path.exists(path):
        os.makedirs(path)
        pq.write_table(pa.table({'id': np.arange(4)}), os.path.join(path, 'p.parquet'))
    return 'file://' + path


def test_a_corrupt_shm_slot_kills_its_worker_and_the_item_is_redone(store, tmp_path,
                                                                   monkeypatch):
    from petastorm_tpu_torch.workers.integrity import TEST_SHM_CORRUPT_ENV
    (tmp_path / 'corrupt').mkdir()
    monkeypatch.setenv(TEST_SHM_CORRUPT_ENV, '{}:1'.format(tmp_path / 'corrupt'))
    with make_reader(store, reader_pool_type='process', workers_count=2,
                     shuffle_row_groups=False) as reader:
        rows = _rows(reader)
        diag = reader.diagnostics
    monkeypatch.delenv(TEST_SHM_CORRUPT_ENV)
    with make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        want = _rows(reader)
    assert sorted(rows) == sorted(want)
    assert (diag['shm_crc_failures'], diag['workers_respawned']) == (1, 1)
    assert diag['breakers']['shm_transport']['failures'] == 1
    assert diag['breakers']['shm_transport']['state'] == 'closed'
