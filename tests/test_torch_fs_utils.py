"""The port's filesystem resolution (``petastorm_tpu_torch.fs_utils``) held
against ``petastorm_tpu.fs_utils``: the same filesystem type and path for each
URL form, the same first-mismatch message, the ``hdfs_driver`` check, options
reaching fsspec, a factory that pickles and retries; then both packages'
``make_reader`` and ``make_batch_reader`` over fsspec's ``memory`` filesystem
on threads giving equal rows for one seed, and the port's process pool over
``local:///`` giving the ``file://`` read's rows and order digest."""

import os
import pickle
import uuid

import fsspec
import numpy as np
import pyarrow.fs as pafs
import pytest

import petastorm_tpu as pt
import petastorm_tpu.fs_utils as jax_fs
import petastorm_tpu_torch.fs_utils as port_fs
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.resilience import RetryPolicy
from petastorm_tpu_torch.telemetry.lineage import LineagePolicy

ROWS = 48


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """48 rows ``id``/``vec`` in 6 files, written by the JAX package, and the
    same files under a fresh bucket of fsspec's memory filesystem."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('RemoteProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False)])
    path = str(tmp_path_factory.mktemp('remote') / 'store')
    write_rows('file://' + path, schema,
               [{'id': i, 'vec': np.full(4, i, np.float32)} for i in range(ROWS)],
               n_files=6)
    bucket = '/bucket-{}/store'.format(uuid.uuid4().hex[:8])
    memory = fsspec.filesystem('memory')
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, 'rb') as f:
                memory.pipe(bucket + '/' + os.path.relpath(full, path), f.read())
    return {'path': path, 'file': 'file://' + path, 'memory': 'memory://' + bucket,
            'local': 'local://' + path}


@pytest.mark.parametrize('url', [
    '/tmp/x/ds', 'file:///tmp/x/ds', 'memory:///bucket/ds', 'local:///tmp/x/ds',
    'C:/data/ds', 'file:///tmp/x/ds/'])
def test_resolution_table_equals_jax(url):
    ours, our_path = port_fs.get_filesystem_and_path_or_paths(url)
    theirs, their_path = jax_fs.get_filesystem_and_path_or_paths(url)
    assert type(ours) is type(theirs) and our_path == their_path
    if isinstance(ours, pafs.PyFileSystem):
        assert type(ours.handler.fs.fs) is type(theirs.handler.fs)
        assert ours.handler.fs.protocol == theirs.handler.fs.protocol


@pytest.mark.parametrize('url', [
    's3://bucket/key/ds', 'gs://bucket/ds', 'abfs://container@acct/ds', 'hdfs://nn:8020/a/b',
    'hdfs:///a/b', 'memory://bucket/ds', 'memory:///bucket/ds', 'file:///a', '/a/b', 'a/b'])
def test_path_and_scheme_of_every_form_equal_jax(url):
    assert port_fs._extract_path(url) == jax_fs._extract_path(url)
    assert port_fs._scheme_of(url) == jax_fs._scheme_of(url)


@pytest.mark.parametrize('urls', [
    ['file:///a', 'file:///b', 's3://bucket/c', 's3://bucket/d'],
    ['hdfs://nn1/a', 'hdfs://nn2/b'],
    ['memory:///a', '/b']])
def test_mismatch_message_names_the_first_offender_as_jax(urls):
    with pytest.raises(ValueError, match='first mismatch') as ours:
        port_fs.get_filesystem_and_path_or_paths(urls)
    with pytest.raises(ValueError) as theirs:
        jax_fs.get_filesystem_and_path_or_paths(urls)
    assert str(ours.value) == str(theirs.value)


def test_hdfs_driver_check_as_jax():
    port_fs.check_hdfs_driver('libhdfs')
    with pytest.warns(UserWarning, match='libhdfs'):
        port_fs.check_hdfs_driver('libhdfs3')
    with pytest.raises(ValueError, match='hdfs_driver'):
        port_fs.check_hdfs_driver('webhdfs')
    with pytest.raises(ValueError, match='hdfs_driver'):
        make_reader('/nonexistent', hdfs_driver='webhdfs')


def test_storage_options_reach_fsspec_as_in_jax(monkeypatch, store):
    calls = []
    real = fsspec.filesystem

    def spy(scheme, **kwargs):
        calls.append((scheme, kwargs))
        return real('memory')

    monkeypatch.setattr(fsspec, 'filesystem', spy)
    options = {'key': 'k', 'secret': 's'}
    ours = port_fs.get_filesystem_and_path_or_paths(['s3://bucket/a', 's3://bucket/b'],
                                                    storage_options=options)
    theirs = jax_fs.get_filesystem_and_path_or_paths(['s3://bucket/a', 's3://bucket/b'],
                                                     storage_options=options)
    assert ours[1] == theirs[1] == ['bucket/a', 'bucket/b']
    assert calls == [('s3', options)] * 2
    # a reader resolves once on construction and once in each worker, every
    # time with the options
    del calls[:]
    with make_reader(store['memory'], reader_pool_type='thread', workers_count=2,
                     storage_options={'skip_instance_cache': False}) as reader:
        assert sorted(int(row.id) for row in reader) == list(range(ROWS))
    assert len(calls) >= 2
    assert set(map(repr, calls)) == {repr(('memory', {'skip_instance_cache': False}))}


def test_factory_pickles_unwraps_and_retries(monkeypatch, tmp_path):
    factory = pickle.loads(pickle.dumps(port_fs.make_filesystem_factory(
        'memory:///x', storage_options={'skip_instance_cache': False})))
    assert isinstance(factory(), pafs.PyFileSystem)
    assert isinstance(pickle.loads(pickle.dumps(port_fs.make_filesystem_factory(
        str(tmp_path))))(), pafs.LocalFileSystem)
    failures = [2]
    real = port_fs._resolve_single

    def flaky(url, storage_options=None, filesystem=None):
        if failures[0]:
            failures[0] -= 1
            raise ConnectionResetError('transient resolution failure')
        return real(url, storage_options, filesystem)

    monkeypatch.setattr(port_fs, '_resolve_single', flaky)
    retrying = port_fs.make_filesystem_factory(
        str(tmp_path), retry_policy=RetryPolicy(max_attempts=3, backoff_base_s=0.0))
    assert isinstance(retrying(), pafs.LocalFileSystem) and failures == [0]
    failures[0] = 1
    with pytest.raises(ConnectionResetError):
        port_fs.make_filesystem_factory(str(tmp_path))()

    class Proxy(object):
        def unwrap(self):
            return pafs.LocalFileSystem()

    assert isinstance(port_fs.as_arrow_filesystem(Proxy()), pafs.LocalFileSystem)
    assert isinstance(port_fs.GivenFilesystemFactory(Proxy())(), pafs.LocalFileSystem)


def test_concurrent_reads_of_one_memory_file_stay_apart():
    """fsspec's memory filesystem hands every open the same ``BytesIO``:
    through the port each open reads on its own, so seek-and-read pairs of
    four threads (the storage engine's per-thread range reads) each get
    their own range's bytes."""
    import threading
    data = os.urandom(1 << 18)
    path = '/race-{}/blob'.format(uuid.uuid4().hex[:8])
    fsspec.filesystem('memory').pipe(path, data)
    fs, path = port_fs.get_filesystem_and_path_or_paths('memory://' + path)
    wrong = []

    def work(k):
        handle = fs.open_input_file(path)
        for i in range(500):
            start = (k * 7919 + i * 104729) % (len(data) - 4096)
            handle.seek(start)
            if handle.read(4096) != data[start:start + 4096]:
                wrong.append((k, i))
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert wrong == []
    with fs.open_input_stream(path) as stream:
        assert stream.read() == data
    with pytest.raises(FileNotFoundError):
        fs.open_input_file(path + '-missing')


def _columns(reader):
    with reader:
        batches = list(reader.iter_columnar())
    return [(batch.columns['id'].tolist(), np.asarray(batch.columns['vec']).tolist())
            for batch in batches]


@pytest.mark.parametrize('factory', ['make_reader', 'make_batch_reader'])
def test_memory_store_reads_the_jax_rows_on_threads(store, factory):
    kwargs = dict(reader_pool_type='thread', workers_count=1, seed=11,
                  shuffle_row_groups=True, shuffle_rows=True)
    ours = _columns({'make_reader': make_reader,
                     'make_batch_reader': make_batch_reader}[factory](store['memory'],
                                                                     **kwargs))
    theirs = _columns(getattr(pt, factory)(store['memory'], **kwargs))
    assert ours == theirs
    assert sorted(i for ids, _ in ours for i in ids) == list(range(ROWS))


def test_memory_store_with_the_storage_engine_and_a_shard_seed(store):
    kwargs = dict(reader_pool_type='dummy', seed=4, cur_shard=1, shard_count=2,
                  shard_seed=9)
    ours = _columns(make_reader(store['memory'], storage_policy=True, **kwargs))
    assert ours == _columns(pt.make_reader(store['memory'], storage_policy=True, **kwargs))
    assert ours == _columns(make_reader(store['file'], **kwargs))


def test_the_netloc_form_fails_in_both_packages(store):
    """``memory://bucket/key`` keeps the netloc, while fsspec's memory
    filesystem roots its paths at ``/``: both packages refuse it alike."""
    url = store['memory'].replace('memory:///', 'memory://', 1)
    with pytest.raises(Exception) as ours:
        make_batch_reader(url)
    with pytest.raises(Exception) as theirs:
        pt.make_batch_reader(url)
    assert type(ours.value) is type(theirs.value)


def test_process_pool_over_local_scheme_gives_the_file_read(store, tmp_path):
    """Each process worker rebuilds fsspec's local filesystem from the
    factory; every row comes once and the order digest is the file:// read's."""
    results = {}
    for name, pool in (('local', 'process'), ('file', 'thread')):
        with make_reader(store[name], reader_pool_type=pool, workers_count=2, seed=5,
                         shuffle_rows=True, lineage=LineagePolicy(manifest=False)) as reader:
            ids = [int(i) for batch in reader.iter_columnar() for i in batch.columns['id']]
            results[name] = (sorted(ids), reader.order_digest())
    assert results['local'] == results['file']
    assert results['local'][0] == list(range(ROWS))
