"""``WeightedSamplingReader`` of the port against the JAX package's: given
the same readers and seed it yields the same sequence and stops when any
reader is exhausted; the loaders read it through their batched and per-row
fallback (it has no ``iter_columnar``), to the batches ``JaxDataLoader`` and
``InMemJaxLoader`` give, and refuse to checkpoint it."""

import numpy as np
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.weighted_sampling_reader import \
    WeightedSamplingReader as JaxWeightedSamplingReader
from petastorm_tpu_torch import (InMemTorchLoader, TorchDataLoader, WeightedSamplingReader,
                                 make_batch_reader, make_reader)


def _write(url, first_id, rows):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Mixed', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (3,), NdarrayCodec(), False)])
    write_rows(url, schema, [{'id': first_id + i, 'vec': np.full(3, first_id + i, np.float32)}
                             for i in range(rows)], n_files=2)


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """Two stores: ids 0-29 and 1000-1049."""
    base = tmp_path_factory.mktemp('weighted')
    urls = ['file://' + str(base / 'a'), 'file://' + str(base / 'b')]
    _write(urls[0], 0, 30)
    _write(urls[1], 1000, 50)
    return urls


def _mix(stores, port, batched=False, probabilities=(0.3, 0.7), seed=4):
    if port:
        factory, mixer = (make_batch_reader if batched else make_reader), WeightedSamplingReader
    else:
        factory = jax_make_batch_reader if batched else jax_make_reader
        mixer = JaxWeightedSamplingReader
    # the batch reader emits a Unischema store's stored values: vec is bytes
    fields = ['id'] if batched else ['id', 'vec']
    readers = [factory(url, reader_pool_type='dummy', shuffle_row_groups=False,
                       schema_fields=fields) for url in stores]
    return mixer(readers, list(probabilities), seed=seed)


@pytest.mark.parametrize('probabilities', [(0.3, 0.7), (0.9, 0.1), (1.0, 0.0)])
def test_the_same_draw_sequence_as_jax(stores, probabilities):
    with _mix(stores, True, probabilities=probabilities) as mixed:
        ours = [int(row.id) for row in mixed]
    with _mix(stores, False, probabilities=probabilities) as mixed:
        theirs = [int(row.id) for row in mixed]
    assert ours == theirs
    # it stops when either reader is exhausted
    assert sum(1 for i in ours if i < 1000) == 30 or sum(1 for i in ours if i >= 1000) == 50


def test_batched_readers_mix_as_in_jax(stores):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')   # make_batch_reader on a Unischema store
        with _mix(stores, True, batched=True) as mixed:
            ours = [np.asarray(batch.id).tolist() for batch in mixed]
        with _mix(stores, False, batched=True) as mixed:
            theirs = [np.asarray(batch.id).tolist() for batch in mixed]
    assert ours == theirs and len(ours) >= 2


def test_refuses_what_jax_refuses(stores):
    readers = [make_reader(url, reader_pool_type='dummy', schema_fields=fields)
               for url, fields in zip(stores, (['id'], ['id', 'vec']))]
    try:
        for bad in ([], [readers[0]]):
            with pytest.raises(ValueError):
                WeightedSamplingReader(bad, [1.0, 1.0])
        with pytest.raises(ValueError, match='same fields'):
            WeightedSamplingReader(readers, [0.5, 0.5])
        with pytest.raises(ValueError, match='non-negative'):
            WeightedSamplingReader(readers, [-1, 2])
    finally:
        for reader in readers:
            reader.stop()


@pytest.mark.parametrize('batched', [False, True])
def test_the_loader_reads_the_mix_through_its_fallback(stores, batched):
    import warnings
    from petastorm_tpu.parallel.loader import JaxDataLoader
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with _mix(stores, True, batched=batched) as mixed:
            loader = TorchDataLoader(mixed, batch_size=8, device='cpu', drop_last=False)
            ours = [{k: v.numpy() for k, v in b.items()} for b in loader]
            with pytest.raises(ValueError, match='iter_columnar'):
                loader.state_dict()
        with _mix(stores, False, batched=batched) as mixed:
            theirs = [{k: np.asarray(v) for k, v in b.items()}
                      for b in JaxDataLoader(mixed, batch_size=8, device_put=False,
                                             drop_last=False)]
    assert len(ours) == len(theirs) >= 4
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got['id'], want['id'].astype(np.int64))
        if not batched:
            np.testing.assert_array_equal(got['vec'], want['vec'])
    assert loader.stats.rows == sum(len(b['id']) for b in ours)


def test_the_in_memory_loader_fills_from_the_mix(stores):
    from petastorm_tpu.parallel.inmem_loader import InMemJaxLoader
    mixed = _mix(stores, True)
    ours = InMemTorchLoader(mixed, batch_size=10, device='cpu', shuffle=False,
                            drop_last=False)
    theirs = InMemJaxLoader(_mix(stores, False), batch_size=10, device_put=False,
                            shuffle=False, drop_last=False)
    assert ours.num_rows == theirs.num_rows > 0
    got = [b['id'].numpy() for b in ours]
    want = [np.asarray(b['id']) for b in theirs]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(np.int64))
