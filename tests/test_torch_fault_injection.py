"""The port's fault-injecting filesystem (``petastorm_tpu_torch.test_util.
fault_injection``) against the JAX package's: the same rule validation, the
same global trigger sequence over the marker files, the same latency
distribution and file damage, picklability, and the port's reader retrying
and quarantining through it as the JAX reader does through the JAX one."""

import os
import pickle

import numpy as np
import pytest

import petastorm_tpu.test_util.fault_injection as jax_fi
import petastorm_tpu_torch.test_util.fault_injection as port_fi
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.errors import TransientIOError

ROWS = 48


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """48 rows ``id``/``vec`` in 4 files, written by the JAX package."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('FaultProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('faults') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': np.full(8, i, np.float32)}
                             for i in range(ROWS)], n_files=4)
    return url


@pytest.mark.parametrize('kwargs, match', [
    ({'kind': 'explode'}, 'kind must be one of'),
    ({'times': 0}, 'times must be'),
    ({'after': -1}, 'after must be'),
    ({'kind': 'hang', 'hang_mode': 'nap'}, 'hang_mode must be one of'),
    ({'kind': 'corrupt', 'corrupt_mode': 'shred'}, 'corrupt_mode must be one of'),
    ({'kind': 'latency', 'tail_every_n': -1}, 'tail_every_n must be'),
    ({'kind': 'latency', 'tail_latency_s': -0.5}, 'tail_latency_s must be'),
])
def test_rule_validation_matches_jax(kwargs, match):
    for module in (port_fi, jax_fi):
        with pytest.raises(ValueError, match=match):
            module.FaultRule('part_', **kwargs)


def _trigger_trace(module, state_dir):
    """Which of 8 opens of two paths fail, under after/times rules."""
    schedule = module.FaultSchedule(state_dir, [
        module.FaultRule('part_0', kind='fail', after=1, times=2),
        module.FaultRule('part_1', kind='fail', times=1)])
    outcome = []
    for path in ['/d/part_0.parquet', '/d/part_1.parquet'] * 4:
        try:
            schedule.on_open(path)
            outcome.append('ok')
        except OSError as exc:
            outcome.append(type(exc).__name__)
    return outcome, schedule.trigger_count(0), schedule.trigger_count(1), \
        schedule.trigger_count()


def test_trigger_sequence_matches_jax(tmp_path):
    port = _trigger_trace(port_fi, str(tmp_path / 'port'))
    jax = _trigger_trace(jax_fi, str(tmp_path / 'jax'))
    assert port == jax
    assert port[0] == ['ok', 'TransientIOError', 'TransientIOError', 'ok', 'TransientIOError',
                       'ok', 'ok', 'ok']
    assert port[1:] == (4, 4, 8)


def test_marker_files_make_the_schedule_global(tmp_path):
    """Two schedule objects over one state dir (two processes' copies)
    share the count: the rule fires once in all."""
    first = port_fi.FaultSchedule(str(tmp_path), [port_fi.FaultRule('x', times=1)])
    second = pickle.loads(pickle.dumps(first))
    with pytest.raises(TransientIOError):
        second.on_open('/x')
    first.on_open('/x')
    assert first.trigger_count(0) == 2


def _latency_trace(module, state_dir, monkeypatch):
    slept = []
    monkeypatch.setattr(module.time, 'sleep', slept.append)
    schedule = module.FaultSchedule(state_dir, [
        module.FaultRule('part_', kind='latency', latency_s=0.002,
                         tail_latency_s=0.5, tail_every_n=4)])
    assert schedule.wants_read_latency('/d/part_3') and not \
        schedule.wants_read_latency('/d/other')
    for i in range(6):
        schedule.on_open('/d/part_{}'.format(i))
        schedule.on_read('/d/part_{}'.format(i))
    return slept


def test_tail_latency_distribution_matches_jax(tmp_path, monkeypatch):
    port = _latency_trace(port_fi, str(tmp_path / 'port'), monkeypatch)
    jax = _latency_trace(jax_fi, str(tmp_path / 'jax'), monkeypatch)
    assert port == jax
    # opens and reads share one counter: every 4th of the 12 events stalls
    assert [i for i, delay in enumerate(port) if delay > 0.1] == [3, 7, 11]


@pytest.mark.parametrize('mode', ['flip', 'truncate'])
def test_corrupt_file_damage_matches_jax(tmp_path, mode):
    payload = bytes(range(256)) * 3
    for name in ('port', 'jax'):
        (tmp_path / name).write_bytes(payload)
    port_fi.corrupt_file(str(tmp_path / 'port'), mode)
    jax_fi.corrupt_file(str(tmp_path / 'jax'), mode)
    assert (tmp_path / 'port').read_bytes() == (tmp_path / 'jax').read_bytes() != payload
    port_fi.corrupt_file(str(tmp_path / 'missing'), mode)   # nothing to damage: no error


def test_filesystem_pickles_and_reads_through_tail_file(tmp_path, store):
    schedule = port_fi.FaultSchedule(str(tmp_path / 'state'), [
        port_fi.FaultRule('part_', kind='latency', latency_s=0.0,
                          tail_latency_s=0.001, tail_every_n=3)])
    fs = pickle.loads(pickle.dumps(port_fi.fault_injecting_filesystem(schedule)))
    assert 'fault-injecting+local' in fs.type_name
    factory = pickle.loads(pickle.dumps(port_fi.FaultInjectingFilesystemFactory(schedule)))
    path = sorted(info.path for info in factory().get_file_info(
        __import__('pyarrow.fs', fromlist=['FileSelector']).FileSelector(
            store[len('file://'):], recursive=True))
        if info.path.endswith('.parquet'))[0]
    with fs.open_input_file(path) as handle:
        head = handle.read(4)
    assert head == b'PAR1'
    # one open and one read claimed slots of the shared counter
    assert schedule.trigger_count(0) >= 2


def _read_ids(make, url, fs, **kwargs):
    with make(url, reader_pool_type='dummy', seed=3, filesystem=fs, **kwargs) as reader:
        ids = sorted(int(x) for batch in reader.iter_columnar() for x in batch.columns['id'])
        return ids, reader.diagnostics


def test_retry_and_skip_through_the_port_fs_match_jax(tmp_path, store):
    import shutil

    import petastorm_tpu as pt
    from petastorm_tpu.resilience import RetryPolicy as JaxRetryPolicy
    from petastorm_tpu_torch.resilience import RetryPolicy

    def schedule(module, name, kind):
        return module.fault_injecting_filesystem(module.FaultSchedule(
            str(tmp_path / name), [module.FaultRule('part_00001', kind=kind, times=1)]))

    port_ids, port_diag = _read_ids(make_reader, store, schedule(port_fi, 'p1', 'fail'),
                                    on_error='retry',
                                    retry_policy=RetryPolicy(backoff_base_s=0.0))
    jax_ids, jax_diag = _read_ids(pt.make_reader, store, schedule(jax_fi, 'j1', 'fail'),
                                  on_error='retry',
                                  retry_policy=JaxRetryPolicy(backoff_base_s=0.0))
    assert port_ids == jax_ids == list(range(ROWS))
    assert port_diag['io_retries'] == jax_diag['io_retries'] >= 1
    # a corrupted file (in a copy: the damage is in place) is quarantined
    # under 'skip' with the rows of the other files delivered, as by JAX
    results = []
    for make, module, name in ((make_reader, port_fi, 'p2'), (pt.make_reader, jax_fi, 'j2')):
        copy = str(tmp_path / (name + '_store'))
        shutil.copytree(store[len('file://'):], copy)
        results.append(_read_ids(make, 'file://' + copy, schedule(module, name, 'corrupt'),
                                 on_error='skip'))
    (port_ids, port_diag), (jax_ids, jax_diag) = results
    assert port_ids == jax_ids and len(port_ids) < ROWS
    assert port_diag['rowgroups_quarantined'] == jax_diag['rowgroups_quarantined'] >= 1
