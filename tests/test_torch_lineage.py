"""The port's lineage plane (``petastorm_tpu_torch.telemetry.lineage``)
against the JAX package's: bit-equal identities and digests, the recorder's
reorder buffer and divergence accounting, the port reader's
``order_digest()`` equal to the JAX reader's for one store, seed, shard and
drop partitioning on every pool, digest continuity through ``state_dict``
(a JAX state with a ``lineage`` block resumes in the port), the loader's step
stamps, and ``verify_manifest``/``diff_manifests`` giving the JAX results on
manifests either package wrote."""

import json
import os

import numpy as np
import pytest

import petastorm_tpu as pt
import petastorm_tpu.telemetry.lineage as jax_lineage
import petastorm_tpu_torch.telemetry.lineage as port_lineage
from petastorm_tpu_torch import TorchDataLoader, make_batch_reader, make_reader
from petastorm_tpu_torch.telemetry.lineage import LineagePolicy, LineageRecorder

NO_MANIFEST = LineagePolicy(manifest=False)
JAX_NO_MANIFEST = jax_lineage.LineagePolicy(manifest=False)
ROWS = 60


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """60 rows ``id``/``vec`` in 6 files, written by the JAX package."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('LineageProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('lineage') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': np.full(4, i, np.float32)}
                             for i in range(ROWS)], n_files=6)
    return url


def _digest(make, url, lineage, consume='columnar', **kwargs):
    kwargs.setdefault('seed', 7)
    kwargs.setdefault('reader_pool_type', 'dummy')
    with make(url, lineage=lineage, **kwargs) as reader:
        if consume == 'columnar':
            for _ in reader.iter_columnar(include_empty=True):
                pass
        else:
            for _ in reader:
                pass
        return reader.order_digest(), reader.diagnostics['lineage']


# -------------------------------------------------------------------- units

@pytest.mark.parametrize('identity', [
    (0, 'a.parquet', 3, None, 0), (2, '/d/part_00001.parquet', np.int64(7), (0, 5), 1),
    (np.int64(1), 'f', None, (np.int64(2), np.int64(9)), np.int64(0)), (5, 'g', 'rg-x', None, 3),
])
def test_identity_and_digest_bit_equal(identity):
    port = port_lineage.canonical_identity(*identity)
    jax = jax_lineage.canonical_identity(*identity)
    assert port == jax and json.loads(json.dumps(port)) == port
    for token in ('tok', 'a' * 16):
        assert port_lineage.genesis_digest(token) == jax_lineage.genesis_digest(token)
        assert port_lineage.fold_digest(port_lineage.genesis_digest(token), port, 11) == \
            jax_lineage.fold_digest(jax_lineage.genesis_digest(token), jax, 11)


def test_content_fingerprint_bit_equal():
    rng = np.random.RandomState(0)
    columns = {'a': rng.randn(5, 3).astype(np.float32), 'b': np.arange(5),
               'c': [np.arange(i) for i in range(5)], 's': np.array(['x', 'yy'], dtype=object)}
    assert port_lineage.content_fingerprint(columns) == \
        jax_lineage.content_fingerprint(columns)
    flipped = dict(columns, b=np.arange(5) + np.eye(5, dtype=np.int64)[2])
    assert port_lineage.content_fingerprint(flipped)['crc32'] != \
        port_lineage.content_fingerprint(columns)['crc32']


@pytest.mark.parametrize('value', [None, False, True, '/tmp/m.jsonl'])
def test_resolve_lineage_policy_matches_jax(value):
    port = port_lineage.resolve_lineage_policy(value)
    jax = jax_lineage.resolve_lineage_policy(value)
    assert (port is None) == (jax is None)
    if port is not None:
        assert port.manifest_path == jax.manifest_path and port.manifest == jax.manifest


def _expect(recorder, epoch, piece):
    recorder.expect(epoch, piece, 0, 'frag.parquet', piece, None)


def test_recorder_folds_out_of_order_and_counts_divergence():
    recorders = (LineageRecorder('tok', NO_MANIFEST),
                 jax_lineage.LineageRecorder('tok', JAX_NO_MANIFEST))
    for recorder in recorders:
        for piece in range(4):
            _expect(recorder, 0, piece)
        for piece in (2, 0, 3, 1):
            recorder.deliver((0, piece, 0), 5)
        recorder.deliver((0, 9, 0), 5)        # never ventilated
    port, jax = (r.report() for r in recorders)
    assert recorders[0].order_digest() == recorders[1].order_digest()
    assert (port['items_folded'], port['pending_items'], port['divergence']) == \
        (jax['items_folded'], jax['pending_items'], jax['divergence']) == (4, 0, 1)


def test_recorder_state_crosses_packages():
    """A JAX recorder's mid-stream state resumes a port recorder to the
    uninterrupted digest."""
    jax = jax_lineage.LineageRecorder('tok', JAX_NO_MANIFEST)
    for piece in range(5):
        _expect(jax, 0, piece)
    jax.deliver((0, 0, 0), 3)
    jax.deliver((0, 2, 0), 3)
    state = json.loads(json.dumps(jax.state_dict()))
    resumed = LineageRecorder('tok', NO_MANIFEST, resume_state=state)
    for piece in (1, 3, 4):
        _expect(resumed, 0, piece)
        resumed.deliver((0, piece, 0), 3)
    baseline = LineageRecorder('tok', NO_MANIFEST)
    for piece in range(5):
        _expect(baseline, 0, piece)
    for piece in range(5):
        baseline.deliver((0, piece, 0), 3)
    assert resumed.order_digest() == baseline.order_digest()
    assert resumed.report()['divergence'] == 0


# ------------------------------------------------------------ the readers

@pytest.mark.parametrize('kwargs', [
    {}, {'shuffle_rows': True}, {'cur_shard': 1, 'shard_count': 2},
    {'shuffle_row_drop_partitions': 2}, {'seed': 3, 'num_epochs': 2},
    {'shuffle_row_groups': False},
])
def test_order_digest_equals_the_jax_reader(store, kwargs):
    port, port_report = _digest(make_reader, store, NO_MANIFEST, **kwargs)
    jax, _ = _digest(pt.make_reader, store, JAX_NO_MANIFEST, **kwargs)
    assert port == jax and port_report['divergence'] == 0


@pytest.mark.parametrize('pool, consume', [('thread', 'columnar'), ('thread', 'rows'),
                                           ('process', 'columnar')])
def test_digest_is_the_same_on_every_pool(store, pool, consume):
    dummy, _ = _digest(make_reader, store, NO_MANIFEST, shuffle_rows=True)
    other, report = _digest(make_reader, store, NO_MANIFEST, consume=consume,
                            shuffle_rows=True, reader_pool_type=pool, workers_count=3)
    assert other == dummy and report['divergence'] == 0


def test_digest_continuity_across_save_resume_and_from_a_jax_state(store):
    baseline, _ = _digest(make_reader, store, NO_MANIFEST, consume='rows', num_epochs=2,
                          seed=11)

    def partial(make, policy):
        reader = make(store, reader_pool_type='dummy', seed=11, num_epochs=2, lineage=policy)
        for count, _ in enumerate(reader, 1):
            if count == 75:   # mid epoch 2, mid item
                break
        state = reader.state_dict()
        reader.stop()
        reader.join()
        return json.loads(json.dumps(state))

    for state in (partial(make_reader, NO_MANIFEST), partial(pt.make_reader, JAX_NO_MANIFEST)):
        assert 'lineage' in state
        resumed, report = _digest(make_reader, store, NO_MANIFEST, consume='rows',
                                  num_epochs=2, seed=11, resume_state=state)
        assert resumed == baseline and report['divergence'] == 0


def test_disarmed_reader_writes_nothing(store):
    with make_reader(store, reader_pool_type='dummy') as reader:
        for _ in reader.iter_columnar():
            pass
        assert reader.order_digest() is None
        assert 'lineage' not in reader.diagnostics and 'lineage' not in reader.state_dict()
    assert not [n for n in os.listdir(store[len('file://'):]) if 'lineage' in n]


def test_batch_reader_scrape_gauges_and_loader_step_stamps(store):
    with pytest.warns(UserWarning):
        reader = make_batch_reader(store, lineage=NO_MANIFEST, seed=3)
    with reader:
        for _ in reader.iter_columnar():
            pass
        gauges = reader._scrape_snapshot()['gauges']
    assert gauges['lineage_items_folded'] == 6 and gauges['lineage_pending_items'] == 0
    with make_reader(store, reader_pool_type='dummy', schema_fields=['id'],
                     lineage=NO_MANIFEST) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu', drop_last=False)
        batches = sum(1 for _ in loader)
        assert batches == 8 and reader.diagnostics['lineage']['step'] == batches


def test_fingerprints_sampled_equal_to_the_jax_readers(store, tmp_path):
    manifests = []
    for make, module, name in ((make_reader, port_lineage, 'port'),
                               (pt.make_reader, jax_lineage, 'jax')):
        path = str(tmp_path / (name + '.jsonl'))
        _digest(make, store, module.LineagePolicy(manifest_path=path, fingerprint_every=2))
        manifests.append(path)
    items = [port_lineage.manifest_items(port_lineage.load_manifest(m)[-1]) for m in manifests]
    assert [row[6] for row in items[0]] == [row[6] for row in items[1]]
    assert sum(row[6] is not None for row in items[0]) == 3


# ------------------------------------------------------- verify, diff, CLI

def _record(make, module, url, path, seed=29):
    digest, report = _digest(make, url, module.LineagePolicy(manifest_path=path), seed=seed)
    assert report['divergence'] == 0
    return digest


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_verify_accepts_either_packages_manifest(store, tmp_path, writer, capsys):
    path = str(tmp_path / 'run.jsonl')
    make, module = ((make_reader, port_lineage) if writer == 'port'
                    else (pt.make_reader, jax_lineage))
    digest = _record(make, module, store, path)
    port = port_lineage.verify_manifest(path, dataset_url=store)
    jax = jax_lineage.verify_manifest(path, dataset_url=store)
    assert port['ok'] and jax['ok'] and port == jax
    assert port['order_digest'] == digest
    assert port_lineage.main(['verify', store, '--manifest', path, '--json']) == 0
    assert json.loads(capsys.readouterr().out)['ok']


def test_verify_catches_a_reordered_stream(store, tmp_path):
    path = str(tmp_path / 'run.jsonl')
    _record(make_reader, port_lineage, store, path)
    lines = open(path).read().splitlines()
    records = [json.loads(line) for line in lines]
    header = [r for r in records if r.get('event') == 'lineage_header'][0]
    header['seed'] = 30
    with open(path, 'w') as f:
        for record in records:
            f.write(json.dumps(record) + '\n')
    port = port_lineage.verify_manifest(path)
    assert not port['ok'] and port == jax_lineage.verify_manifest(path)
    assert port['reason'] == 'order_divergence' and port['exit_code'] == 1


def test_diff_gives_the_jax_attribution_and_exit_code(store, tmp_path):
    paths = {}
    for name, seed, make, module in (('a', 29, pt.make_reader, jax_lineage),
                                     ('b', 29, make_reader, port_lineage),
                                     ('c', 30, pt.make_reader, jax_lineage)):
        paths[name] = str(tmp_path / (name + '.jsonl'))
        _record(make, module, store, paths[name], seed=seed)
    for pair, attribution in ((('a', 'b'), 'identical'), (('a', 'c'), 'seed'),
                              (('b', 'c'), 'seed')):
        port = port_lineage.diff_manifests(paths[pair[0]], paths[pair[1]])
        jax = jax_lineage.diff_manifests(paths[pair[0]], paths[pair[1]])
        assert port == jax and port['attribution'] == attribution
        assert port['exit_code'] == port_lineage.ATTRIBUTION_EXIT_CODES[attribution]
    assert port_lineage.main(['diff', paths['a'], paths['c']]) == port_lineage.EXIT_SEED


def test_cli_record_and_verify_in_a_child_interpreter(store, tmp_path):
    import subprocess
    import sys
    path = str(tmp_path / 'cli.jsonl')
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cli = [sys.executable, '-m', 'petastorm_tpu_torch.benchmark.cli', 'lineage']
    record = subprocess.run(cli + ['record', store, '--manifest', path, '--seed', '5',
                                   '--workers', '1'],
                            capture_output=True, text=True, env=env, timeout=120)
    assert record.returncode == 0, record.stderr[-2000:]
    assert json.loads(record.stdout.strip().splitlines()[-1])['items'] == 6
    verify = subprocess.run(cli + ['verify', store, '--manifest', path],
                            capture_output=True, text=True, env=env, timeout=120)
    assert verify.returncode == 0 and 'OK' in verify.stdout


def test_a_topology_header_is_refused(tmp_path):
    path = str(tmp_path / 'topo.jsonl')
    with open(path, 'w') as f:
        f.write(json.dumps({'event': 'lineage_header', 'seed': 1, 'items': [],
                            'topology': {'process_count': 2}}) + '\n')
    with pytest.raises(ValueError, match='topology'):
        port_lineage.verify_manifest(path)
    with pytest.raises(ValueError, match='topology'):
        port_lineage.diff_manifests(path, path)
    assert port_lineage.main(['diff', path, path]) == port_lineage.EXIT_ERROR


def test_attribution_exit_codes_match_jax():
    assert port_lineage.ATTRIBUTION_EXIT_CODES == jax_lineage.ATTRIBUTION_EXIT_CODES
    assert len(set(port_lineage.ATTRIBUTION_EXIT_CODES.values())) == \
        len(port_lineage.ATTRIBUTION_EXIT_CODES)
