"""The port's topology plane (``petastorm_tpu_torch.parallel.topology``) held
against the JAX package's: identity and policy resolution (the
``torch.distributed`` runtime where the JAX one asks jax), the membership
journal (round trip, torn tail, CRC, compaction) byte for byte equal and
replayed across packages, the deal, undelivered and reshard math and the
cross-topology merge equal to JAX's; then the reader: the state and
diagnostics blocks, the refusals, a corrupt journal degrading loudly, a JAX
topology state resuming a port reader, the 1/2/4-host digest matrix,
kill-host and join-host, and restore across topologies, each giving exactly
the rows and global digest of an undisturbed read, equal to the JAX
harness's."""

import logging
import os
import types

import numpy as np
import pytest

import petastorm_tpu as pt
import petastorm_tpu.parallel.topology as jax_topo
import petastorm_tpu.telemetry.lineage as jax_lineage
import petastorm_tpu.test_util.chaos as jax_chaos
import petastorm_tpu_torch.parallel.topology as port_topo
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.parallel.checkpoint import restore_across_topology
from petastorm_tpu_torch.telemetry.lineage import EXIT_TOPOLOGY, LineagePolicy
from petastorm_tpu_torch.test_util.chaos import run_host_chaos
from petastorm_tpu_torch.test_util.fault_injection import corrupt_file

ROWS = 60
ROWGROUPS = 10
INDEX_ENV = 'PETASTORM_TPU_PROCESS_INDEX'
COUNT_ENV = 'PETASTORM_TPU_PROCESS_COUNT'


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """60 rows ``id``/``vec`` in 10 files of one rowgroup, written by the JAX
    package."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('TopologyProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('topology') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': np.full(4, i, np.float32)}
                             for i in range(ROWS)], rows_per_file=ROWS // ROWGROUPS)
    return url


@pytest.fixture(autouse=True)
def _no_identity_env(monkeypatch):
    monkeypatch.delenv(INDEX_ENV, raising=False)
    monkeypatch.delenv(COUNT_ENV, raising=False)


def _policy(journal, index=0, count=1, **kwargs):
    return port_topo.TopologyPolicy(journal_path=str(journal), process_index=index,
                                    process_count=count, **kwargs)


def _ids(reader, stop_after=None):
    ids, batches = [], 0
    with reader:
        for batch in reader.iter_columnar():
            ids.extend(int(i) for i in batch.columns['id'])
            batches += 1
            if batches == stop_after:
                return ids, reader.state_dict()
        return ids, reader.state_dict()


# ------------------------------------------------------------------- units

@pytest.mark.parametrize('count,rowgroups', [(1, 0), (1, 7), (2, 10), (3, 7), (5, 10),
                                             (4, 3)])
def test_deal_equals_jax_and_partitions(count, rowgroups):
    dealt = [port_topo.deal_assignment(i, count, rowgroups) for i in range(count)]
    assert dealt == [jax_topo.deal_assignment(i, count, rowgroups) for i in range(count)]
    assert sorted(g for a in dealt for g in a) == list(range(rowgroups))


@pytest.mark.parametrize('delivered,epoch,drops', [
    ({(0, 0, 0), (0, 3, 0), (1, 1, 0)}, 0, 1), ({(0, 0, 0), (0, 3, 0), (1, 1, 0)}, 1, 1),
    (set(), 0, 1), ({(0, 0, 0), (0, 1, 1)}, 0, 2)])
def test_undelivered_and_reshard_equal_jax(delivered, epoch, drops):
    ours = port_topo.undelivered_items(6, epoch, frozenset(delivered), drop_partitions=drops)
    assert ours == jax_topo.undelivered_items(6, epoch, frozenset(delivered),
                                              drop_partitions=drops)
    for survivors in (['host-0'], ['host-0', 'host-2'], ['host-1', 'host-2', 'host-3']):
        assert port_topo.reshard_assignments(ours, survivors) == \
            jax_topo.reshard_assignments(ours, survivors)
    with pytest.raises(ValueError):
        port_topo.reshard_assignments(ours or [(0, 0)], [])


def _state(module, index, count, rowgroups, pieces, epochs=0):
    assignment = list(module.deal_assignment(index, count, rowgroups))
    return {'version': 1, 'items_per_epoch': len(assignment), 'epochs_consumed': epochs,
            'consumed_by_epoch': {'0': [[piece, 0] for piece in pieces]},
            'topology': {'process_index': index, 'process_count': count, 'generation': 0,
                         'assignment': assignment, 'global_rowgroups': rowgroups}}


@pytest.mark.parametrize('old,new,rowgroups', [(4, 2, 8), (2, 1, 10), (2, 3, 7), (3, 3, 9)])
def test_merge_equals_jax(old, new, rowgroups):
    states = [_state(port_topo, i, old, rowgroups, [0]) for i in range(old)]
    merged = port_topo.merge_topology_states(states, new)
    assert merged == jax_topo.merge_topology_states(states, new)
    assert merged == restore_across_topology(states, new)
    for state in merged:
        assert port_topo.policy_from_state(state, '/j') == port_topo.TopologyPolicy(
            **vars(jax_topo.policy_from_state(state, '/j')))


def test_merge_refusals_as_jax():
    good = _state(port_topo, 0, 2, 4, [0])
    static = {k: v for k, v in good.items() if k != 'topology'}
    for states, count, match in (([], 1, 'no states'), ([good], 0, 'new_count'),
                                 ([static], 1, 'topology-armed'),
                                 ([dict(good, row_cursor={'piece': 0})], 1, 'row_cursor'),
                                 ([good, _state(port_topo, 1, 2, 4, [], epochs=3)], 1,
                                  'epochs_consumed'),
                                 ([good, _state(port_topo, 1, 2, 6, [])], 1,
                                  'rowgroup count')):
        with pytest.raises(ValueError, match=match):
            port_topo.merge_topology_states(states, count)
        with pytest.raises(ValueError, match=match):
            jax_topo.merge_topology_states(states, count)


def test_identity_precedence(monkeypatch):
    assert port_topo.resolve_process_identity() == (0, 1)
    monkeypatch.setenv(INDEX_ENV, '2')
    with pytest.raises(ValueError, match='must be set together'):
        port_topo.resolve_process_identity()
    monkeypatch.setenv(COUNT_ENV, '5')
    assert port_topo.resolve_process_identity() == jax_topo.resolve_process_identity() == (2, 5)
    assert port_topo.resolve_process_identity(0, 3) == (0, 3)
    for args, match in (((1, None), 'must be passed together'), ((0, 0), 'process_count'),
                        ((3, 2), 'process_index')):
        with pytest.raises(ValueError, match=match):
            port_topo.resolve_process_identity(*args)


@pytest.mark.parametrize('world,rank,expected', [(1, 0, (0, 1)), (4, 3, (3, 4))])
def test_identity_from_an_initialized_torch_group(monkeypatch, world, rank, expected):
    """The runtime source: an initialized ``torch.distributed`` group of more
    than one rank (a stand-in module here; the env pair still outranks it)."""
    fake = types.SimpleNamespace(is_available=lambda: True, is_initialized=lambda: True,
                                 get_world_size=lambda: world, get_rank=lambda: rank)
    monkeypatch.setitem(__import__('sys').modules, 'torch.distributed', fake)
    assert port_topo.resolve_process_identity() == expected
    monkeypatch.setenv(INDEX_ENV, '0')
    monkeypatch.setenv(COUNT_ENV, '2')
    assert port_topo.resolve_process_identity() == (0, 2)


@pytest.mark.parametrize('value', [None, False, True, '/x/j.bin', 'policy'])
def test_policy_forms_and_validation_equal_jax(value):
    def resolve(module):
        given = module.TopologyPolicy(process_index=1, process_count=2) \
            if value == 'policy' else value
        resolved = module.resolve_topology_policy(given)
        return None if resolved is None else vars(resolved)
    assert resolve(port_topo) == resolve(jax_topo)
    for kwargs, match in (({'process_index': 1}, 'set together'),
                          ({'process_index': 3, 'process_count': 2}, 'process_index'),
                          ({'lease_s': 0}, 'lease_s'), ({'generation': -1}, 'generation')):
        with pytest.raises(ValueError, match=match):
            port_topo.TopologyPolicy(**kwargs)
    with pytest.raises(TypeError, match='topology='):
        port_topo.resolve_topology_policy(123)


def _write_journal(module, path, clock=100.0):
    journal = module.MembershipJournal(path, clock=lambda: clock)
    journal.open()
    journal.note_join('host-0', 0, 2, 0, lease_s=30.0)
    journal.note_join('host-1', 1, 2, 0, lease_s=30.0)
    for index in (0, 2, 4):
        journal.note_progress('host-0', 0, index, 0)
    journal.note_lease('host-0', lease_s=30.0)
    journal.note_reshard(1, {'host-0': [1, 3], 'host-2': [5]}, reason='kill_host')
    journal.note_leave('host-1')
    journal.close()


def test_journal_bytes_and_replays_cross_packages(tmp_path):
    ours, theirs = str(tmp_path / 'port.bin'), str(tmp_path / 'jax.bin')
    _write_journal(port_topo, ours)
    _write_journal(jax_topo, theirs)
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        replay = port_topo.replay_topology_journal(path)
        assert replay.as_dict() == jax_topo.replay_topology_journal(path).as_dict()
        assert replay.delivered == frozenset({(0, 0, 0), (0, 2, 0), (0, 4, 0)})
        assert replay.generation == 1 and replay.shard_map['host-2'] == (5,)
        assert not replay.members['host-1']['alive']
        assert replay.stale_leases(now=120.0) == [] and \
            replay.stale_leases(now=131.0) == ['host-0']
    from petastorm_tpu.tools import doctor as jax_doctor
    from petastorm_tpu_torch.tools import doctor
    report = doctor.check_topology(ours)
    expected = jax_doctor.check_topology(ours)
    assert {k: v for k, v in report.items() if k != 'stale_leases'} == \
        {k: v for k, v in expected.items() if k != 'stale_leases'}
    assert report['status'] == 'ok' and report['resharded'] == 1
    assert doctor.check_topology(str(tmp_path / 'none.bin'))['status'] == 'absent'


def test_journal_close_torn_tail_and_crc(tmp_path):
    path = str(tmp_path / 'j.bin')
    journal = port_topo.MembershipJournal(path)
    assert journal.open().result == 'absent'
    journal.note_join('host-0', 0, 1, 0, lease_s=30.0)
    journal.note_progress('host-0', 0, 0, 0)
    size = os.path.getsize(path)
    state = journal.state()
    journal.close()
    assert os.path.getsize(path) == size   # no terminal record
    assert state['armed'] and state['appended'] == 3 and state['last_replay'] == 'absent'
    with open(path, 'ab') as stream:
        stream.write(b'\x00\x00\x00')   # a torn header
    records, dropped = port_topo.read_frames(path)
    assert (records, dropped) == jax_topo.read_frames(path)
    assert dropped == 1 and [r['kind'] for r in records] == ['epoch', 'join', 'progress']
    assert port_topo.replay_topology_journal(path).delivered == frozenset({(0, 0, 0)})
    flipped = str(tmp_path / 'flipped.bin')
    journal = port_topo.MembershipJournal(flipped)
    journal.open()
    for index in range(8):
        journal.note_progress('host-0', 0, index, 0)
    journal.close()
    intact = port_topo.replay_topology_journal(flipped).records
    corrupt_file(flipped)
    replay = port_topo.replay_topology_journal(flipped)
    assert replay.result == 'corrupt' and replay.frames_dropped == 1
    assert replay.records < intact
    assert replay.as_dict() == jax_topo.replay_topology_journal(flipped).as_dict()


def test_compaction_at_open_equals_jax(tmp_path):
    sizes = {}
    for name, module in (('port', port_topo), ('jax', jax_topo)):
        path = str(tmp_path / (name + '.bin'))
        journal = module.MembershipJournal(path, rotate_bytes=256)
        journal.open()
        journal.note_reshard(3, {'host-0': [0, 1, 2]}, reason='test')
        for index in range(50):
            journal.note_progress('host-0', 0, index, 0)
        journal.close()
        second = module.MembershipJournal(path, rotate_bytes=256)
        replay = second.open()
        second.close()
        assert replay.generation == 3 and len(replay.delivered) == 50
        compacted = port_topo.replay_topology_journal(path)
        assert (compacted.result, compacted.generation, compacted.records) == ('ok', 3, 2)
        with open(path, 'rb') as f:
            sizes[name] = f.read()
    assert sizes['port'] == sizes['jax']


# ------------------------------------------------------------------ reader

def test_reader_refusals(store, tmp_path):
    with pytest.raises(ValueError, match='mutually exclusive'):
        make_reader(store, reader_pool_type='dummy', cur_shard=0, shard_count=2,
                    topology=_policy(tmp_path / 'j.bin'))
    with pytest.raises(ValueError, match='mutually exclusive'):
        make_reader(store, reader_pool_type='dummy', shard_seed=3,
                    topology=_policy(tmp_path / 'j.bin'))
    with pytest.raises(ValueError, match='cost_schedule'):
        make_reader(store, reader_pool_type='dummy', cost_schedule=True,
                    topology=_policy(tmp_path / 'j.bin'))
    with pytest.raises(ValueError, match='outside'):
        make_reader(store, reader_pool_type='dummy',
                    topology=_policy(tmp_path / 'j.bin', assignment=(0, 99)))


def test_state_diagnostics_and_manifest_blocks_equal_jax(store, tmp_path):
    blocks = {}
    for name, make, module in (('port', make_reader, port_topo),
                               ('jax', pt.make_reader, jax_topo)):
        policy = module.TopologyPolicy(journal_path=str(tmp_path / (name + '.bin')),
                                       process_index=1, process_count=2)
        manifest = str(tmp_path / (name + '.jsonl'))
        reader = make(store, reader_pool_type='dummy', seed=5, topology=policy,
                      lineage=jax_lineage.LineagePolicy(manifest_path=manifest)
                      if name == 'jax' else LineagePolicy(manifest_path=manifest))
        with reader:
            ids = [int(i) for batch in reader.iter_columnar() for i in batch.columns['id']]
            diag = reader.diagnostics['topology']
            state = reader.state_dict()
        from petastorm_tpu_torch.telemetry.lineage import load_manifest
        blocks[name] = (sorted(ids), state, {k: v for k, v in diag.items()
                                             if k != 'journal'},
                        load_manifest(manifest)[-1]['header']['topology'])
    assert blocks['port'] == blocks['jax']
    assert blocks['port'][1]['shard_config']['topology'] is True
    assert blocks['port'][1]['topology']['assignment'] == [1, 3, 5, 7, 9]
    assert len(blocks['port'][0]) == ROWS // 2


def test_resume_refusals_and_a_jax_state_resumes_the_port(store, tmp_path):
    jax_policy = jax_topo.TopologyPolicy(journal_path=str(tmp_path / 'jax.bin'),
                                         process_index=0, process_count=2)
    reader = pt.make_reader(store, reader_pool_type='dummy', seed=7, topology=jax_policy)
    first, batches = [], 0
    with reader:
        for batch in reader.iter_columnar():
            first.extend(int(i) for i in batch.columns['id'])
            batches += 1
            if batches == 2:
                break
        state = reader.state_dict()
    with pytest.raises(ValueError, match='shard config'):
        make_reader(store, reader_pool_type='dummy', seed=7, resume_state=state)
    with pytest.raises(ValueError, match='static-sharded'):
        make_reader(store, reader_pool_type='dummy', seed=7,
                    resume_state=dict(state, shard_config=None))
    with pytest.raises(ValueError, match='merge_topology_states'):
        make_reader(store, reader_pool_type='dummy', seed=7, resume_state=state,
                    topology=_policy(tmp_path / 'p.bin', index=1, count=2))
    rest, _ = _ids(make_reader(store, reader_pool_type='dummy', seed=7, resume_state=state,
                               topology=_policy(tmp_path / 'p.bin', index=0, count=2)))
    jax_rest = []
    with pt.make_reader(store, reader_pool_type='dummy', seed=7, resume_state=state,
                        topology=jax_policy) as reader:
        for batch in reader.iter_columnar():
            jax_rest.extend(int(i) for i in batch.columns['id'])
    assert rest == jax_rest
    assert sorted(first + rest) == [i for i in range(ROWS) if (i // 6) % 2 == 0]


def test_corrupt_journal_degrades_loudly(store, tmp_path, caplog):
    journal = tmp_path / 'j.bin'
    _ids(make_reader(store, reader_pool_type='dummy', topology=_policy(journal)))
    corrupt_file(str(journal))
    with caplog.at_level(logging.WARNING, logger='petastorm_tpu_torch.parallel.topology'):
        reader = make_reader(store, reader_pool_type='dummy', topology=_policy(journal))
    with reader:
        diag = reader.diagnostics['topology']
        assert diag['journal']['frames_dropped'] >= 1
        assert diag['journal']['last_replay'] == 'corrupt'
        assert sum(batch.num_rows for batch in reader.iter_columnar()) == ROWS
    assert any('dropped' in record.getMessage() for record in caplog.records)


# ----------------------------------------------------------- host chaos

@pytest.mark.parametrize('hosts', [1, 2, 4])
def test_any_topology_digest_matrix_equals_jax(store, tmp_path, hosts):
    ours = run_host_chaos(store, str(tmp_path / 'port'), hosts=hosts, seed=101)
    theirs = jax_chaos.run_host_chaos(store, str(tmp_path / 'jax'), hosts=hosts, seed=101)
    assert ours['ok'], ours
    assert ours['rows_chaos'] == ROWS and ours['duplicates'] == []
    assert ours['digest_chaos'] == ours['digest_baseline'] == theirs['digest_chaos']
    assert ours['diff_exit_code'] == (0 if hosts == 1 else EXIT_TOPOLOGY)


@pytest.mark.parametrize('mode,hosts,seed', [('kill_host', 3, 1234), ('join_host', 2, 77)])
def test_kill_and_join_host_rows_exact_as_jax(store, tmp_path, mode, hosts, seed):
    kwargs = {mode: True}
    ours = run_host_chaos(store, str(tmp_path / 'port'), hosts=hosts, seed=seed, **kwargs)
    theirs = jax_chaos.run_host_chaos(store, str(tmp_path / 'jax'), hosts=hosts, seed=seed,
                                      **kwargs)
    assert ours['ok'], ours
    assert ours['rows_exact'] and ours['digest_exact'] and ours['duplicates'] == []
    assert ours['fired'] == theirs['fired'] and ours['fired'][0]['kind'] == mode
    assert ours['reshard_assignments'] == theirs['reshard_assignments']
    assert ours['digest_chaos'] == theirs['digest_chaos']
    assert ours['journal']['generation'] == 1 and ours['undelivered_resharded'] >= 1
    if mode == 'kill_host':
        assert (ours['verify_exit_code'], ours['diff_attribution']) == (0, 'topology')


def test_cross_topology_restore_rows_exact(store, tmp_path):
    """A 2-host pod saved after two batches each, merged, resumed on one host:
    every row exactly once, and the resumed host's rows equal the JAX
    package's resume of the same merged state."""
    states, first = [], []
    for index in range(2):
        ids, state = _ids(make_reader(store, reader_pool_type='dummy', seed=7,
                                      topology=_policy(tmp_path / 'j2.bin', index, 2)),
                          stop_after=2)
        first.extend(ids)
        states.append(state)
    merged = restore_across_topology(states, 1)
    assert merged == jax_topo.merge_topology_states(states, 1)
    rest, _ = _ids(make_reader(
        store, reader_pool_type='thread', workers_count=2, seed=7,
        topology=port_topo.policy_from_state(merged[0], str(tmp_path / 'j1.bin')),
        resume_state=merged[0]))
    assert len(first) + len(rest) == ROWS
    assert sorted(first + rest) == list(range(ROWS))
    jax_rest = []
    with pt.make_reader(store, reader_pool_type='dummy', seed=7,
                        topology=jax_topo.policy_from_state(merged[0],
                                                            str(tmp_path / 'jx.bin')),
                        resume_state=merged[0]) as reader:
        for batch in reader.iter_columnar():
            jax_rest.extend(int(i) for i in batch.columns['id'])
    assert sorted(rest) == sorted(jax_rest)
