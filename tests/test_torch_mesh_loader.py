"""The loaders' mesh paths in the port on one gloo world of 4 CPU ranks,
against the JAX loaders on 4 of the JAX package's CPU devices:

- ``TorchDataLoader(mesh=...)`` on a 2 x 2 ('stage', 'data') mesh, its reader
  sharded by the 'data' coordinate: every field a DTensor of global shape
  (rank rows x data size) with Shard(0) over 'data'; the batches disjoint
  and exhaustive over the data ranks and identical on the stage ranks of one
  data coordinate; a dict spec with a key that names no field warns;
  ``device_put=False`` yields numpy; ``scan_stream`` over the mesh gives the
  mesh-less loader's chunks;
- ``InMemTorchLoader`` over a ('data',) mesh of 4 (each rank fills the whole
  store): without shuffle the global batches interleave the shard blocks as
  JAX's do; a shuffled epoch keeps every row in its shard; handed JAX's
  per-shard round keys, the shard-local permutations (J9) equal JAX's bit
  for bit; a training step composes; the data resides in blocks; the mesh
  ``__iter__`` batches equal the JAX host mesh path's for the same seed; and
  the guards;
- ``batch_sharding`` and ``initialize_distributed`` when a group is up.
All comparisons are exact: row ids."""

import os
import sys
import warnings

import numpy as np
import pytest

from test_torch_sharded_moe import init_world, run_world

ROWS = 102           # 4 shards of 25 rows and 2 trailing rows
INMEM_BATCH = 16     # 4 rows a shard a step: 6 steps an epoch
EPOCHS = 2


def write_store(url):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Rows', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (3,), NdarrayCodec(), False),
    ])
    write_rows(url, schema, [{'id': i, 'vec': np.full(3, i, np.float32)} for i in range(ROWS)],
               rows_per_file=17)


# ------------------------------------------------------------------ the ranks

def _worker(rank, world, store, workdir):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    import petastorm_tpu_torch.parallel.inmem_loader as inmem_module
    from petastorm_tpu_torch import InMemTorchLoader, TorchDataLoader, make_reader
    from petastorm_tpu_torch.parallel.mesh import (PartitionSpec as P, batch_sharding,
                                                   initialize_distributed, make_mesh,
                                                   mesh_shard_info)
    init_world(rank, world, store)
    inputs = dict(np.load(os.path.join(workdir, 'inputs.npz')))
    url = 'file://' + os.path.join(workdir, 'dataset')
    out = {'init_again': np.asarray(initialize_distributed(device='cpu'))}

    def reader(**kwargs):
        return make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False, **kwargs)

    # TorchDataLoader on ('stage', 'data')
    mesh = make_mesh(('stage', 'data'), (2, 2), device='cpu')
    out['placements'] = np.asarray(
        batch_sharding(mesh, P('data')) == (Replicate(), Shard(0))
        and batch_sharding(mesh, P('data', 'stage')) == (Shard(1), Shard(0))
        and batch_sharding(mesh, P()) == (Replicate(), Replicate()))
    cur_shard, shard_count = mesh_shard_info(mesh, 'data')
    loader = TorchDataLoader(reader(cur_shard=cur_shard, shard_count=shard_count),
                             batch_size=4, mesh=mesh, partition_spec=P('data'), device='cpu',
                             drop_last=False)
    ids, layout_ok = [], True
    for batch in loader:
        for name, value in batch.items():
            local = value.to_local()
            layout_ok &= (isinstance(value, DTensor)
                          and value.placements == (Replicate(), Shard(0))
                          and value.shape[0] == local.shape[0] * 2
                          and tuple(value.shape[1:]) == tuple(local.shape[1:]))
        ids.append(batch['id'].to_local().numpy())
    out['dp_ids'] = np.concatenate(ids)
    out['dp_layout'] = np.asarray(layout_ok)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        loader = TorchDataLoader(reader(cur_shard=cur_shard, shard_count=shard_count),
                                 batch_size=4, mesh=mesh,
                                 partition_spec={'id': P('data'), 'idx': P('data')},
                                 device='cpu')
        next(iter(loader))
    out['dict_warns'] = np.asarray(any("['idx'] match no batch field" in str(w.message)
                                       for w in caught))
    host = next(iter(TorchDataLoader(reader(), batch_size=4, mesh=mesh, device='cpu',
                                     device_put=False)))
    out['host_numpy'] = np.asarray(all(isinstance(v, np.ndarray) for v in host.values()))

    def step(batch):
        value = batch['id']
        return value.to_local() if isinstance(value, DTensor) else value

    chunks = TorchDataLoader(reader(), batch_size=4, mesh=mesh, device='cpu').scan_stream(
        step, chunk_batches=3, seed=5)
    plain = TorchDataLoader(reader(), batch_size=4, device='cpu').scan_stream(
        step, chunk_batches=3, seed=5)
    out['stream_mesh'] = torch.cat(chunks).numpy()
    out['stream_plain'] = torch.cat(plain).numpy()

    # InMemTorchLoader over ('data',) of 4
    data_mesh = make_mesh(('data',), device='cpu')

    def inmem(**kwargs):
        kwargs = dict(dict(batch_size=INMEM_BATCH, num_epochs=None, seed=3, mesh=data_mesh,
                           device='cpu'), **kwargs)
        return InMemTorchLoader(reader(), **kwargs)

    def ids_of(batch):
        return batch['id'].to_local()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        sequential = inmem(shuffle=False).scan_epochs(ids_of, num_epochs=1)[0]
    out['drop_warns'] = np.asarray(any('drops 2 trailing rows' in str(w.message)
                                       for w in caught))
    out['sequential'] = sequential.numpy()
    own = inmem()
    out['own_keys'] = torch.stack(own.scan_epochs(ids_of, num_epochs=EPOCHS)).numpy()
    jax_keys = inputs['jax_keys']   # [epoch, shard, round]
    inmem_module.epoch_round_keys = lambda seed, epoch, shard=None: (
        jax_keys[epoch, shard].tolist())
    loader = inmem()
    out['jax_keys'] = torch.stack(loader.scan_epochs(ids_of, num_epochs=EPOCHS)).numpy()
    out['resident'] = loader._data['id'].numpy()
    w = torch.tensor(0.5, requires_grad=True)
    optimizer = torch.optim.SGD([w], lr=1e-4)

    def train(batch):
        loss = ((batch['id'].to_local().float() * w - 1.0) ** 2).mean()
        optimizer.zero_grad()
        loss.backward()
        dist.all_reduce(w.grad)
        w.grad /= 4
        optimizer.step()
        return loss.detach()
    losses = inmem().scan_epochs(train, num_epochs=1, state=(w,))[0]
    out['train'] = np.asarray(bool(torch.isfinite(losses).all()) and bool(torch.isfinite(w)))
    out['iter'] = np.stack([b['id'].to_local().numpy() for b in inmem(num_epochs=1, seed=2)])

    # the guards
    loader = inmem(batch_size=10)
    try:
        loader.scan_epochs(ids_of)
        out['guard_divisible'] = np.asarray(False)
    except ValueError as exc:
        out['guard_divisible'] = np.asarray('divisible' in str(exc)
                                            and loader._columns is not None)
    try:
        inmem(partition_spec={'id': P('data')}).scan_epochs(ids_of)
        out['guard_dict'] = np.asarray(False)
    except ValueError as exc:
        out['guard_dict'] = np.asarray('single-axis' in str(exc))
    try:
        inmem(device_put=False).scan_epochs(ids_of)
        out['guard_host'] = np.asarray(False)
    except ValueError as exc:
        out['guard_host'] = np.asarray('device_put=True' in str(exc))
    loader = inmem()
    loader.scan_epochs(ids_of)
    try:
        next(iter(loader))
        out['guard_iter'] = np.asarray(False)
    except RuntimeError as exc:
        out['guard_iter'] = np.asarray('scan_epochs moved the dataset' in str(exc))
    np.savez(os.path.join(workdir, 'rank{}.npz'.format(rank)), **out)
    dist.destroy_process_group()


# ------------------------------------------------------------------ the JAX side

def _jax_keys(seed):
    """The round keys JAX's shard-local shuffle draws: fold_in(fold_in(
    PRNGKey(seed), epoch), shard), as petastorm_tpu/parallel/inmem_loader.py
    folds them."""
    import jax
    import jax.numpy as jnp
    keys = np.zeros((EPOCHS, 4, 4), np.int64)
    for epoch in range(EPOCHS):
        epoch_key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        for shard in range(4):
            keys[epoch, shard] = np.asarray(jax.random.randint(
                jax.random.fold_in(epoch_key, shard), (4,), 0, np.iinfo(np.int32).max,
                dtype=jnp.int32))
    return keys


def _jax_inmem(url, **kwargs):
    import jax
    from jax.sharding import Mesh

    from petastorm_tpu import make_reader
    from petastorm_tpu.parallel import InMemJaxLoader
    reader = make_reader(url, workers_count=1, num_epochs=1, shuffle_row_groups=False)
    kwargs = dict(dict(batch_size=INMEM_BATCH, num_epochs=None, seed=3,
                       mesh=Mesh(np.asarray(jax.devices()[:4]), ('data',))), **kwargs)
    return InMemJaxLoader(reader, **kwargs)


def _jax_scan(url, shuffle):
    loader = _jax_inmem(url, shuffle=shuffle)
    _, aux = loader.scan_epochs(lambda c, b: (c, b['id']), None,
                                num_epochs=EPOCHS if shuffle else 1)
    return np.stack([np.asarray(a) for a in aux]), loader


# ------------------------------------------------------------------ the tests

def test_batch_sharding_placements_and_errors():
    from torch.distributed.tensor import Replicate, Shard

    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    class Mesh(object):   # batch_sharding reads only the dimension names
        mesh_dim_names = ('data', 'seq', 'model')

    assert batch_sharding(Mesh()) == (Shard(0), Replicate(), Replicate())
    assert batch_sharding(Mesh(), P(None, 'seq')) == (Replicate(), Shard(1), Replicate())
    assert batch_sharding(Mesh(), ('data', None, 'model')) == (Shard(0), Replicate(), Shard(2))
    assert batch_sharding(Mesh(), P(('data', 'model'))) == (Shard(0), Replicate(), Shard(0))
    assert repr(P('data', None)) == "PartitionSpec('data', None)"
    with pytest.raises(ValueError, match='not a dimension'):
        batch_sharding(Mesh(), P('stage'))
    with pytest.raises(ValueError, match='twice'):
        batch_sharding(Mesh(), P('data', 'data'))


def test_spec_without_mesh_and_cuda_without_card_raise(tmp_path):
    from petastorm_tpu_torch import InMemTorchLoader, TorchDataLoader, make_reader
    from petastorm_tpu_torch.parallel.mesh import initialize_distributed
    url = 'file://' + str(tmp_path / 'dataset')
    write_store(url)
    for cls in (TorchDataLoader, InMemTorchLoader):
        with make_reader(url, reader_pool_type='dummy') as reader:
            with pytest.raises(ValueError, match='requires a mesh'):
                cls(reader, batch_size=4, partition_spec=('data',), device='cpu')
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='is_available'):
            initialize_distributed()


def test_mesh_loaders_on_a_gloo_world_of_four(tmp_path):
    url = 'file://' + str(tmp_path / 'dataset')
    write_store(url)
    ranks = run_world(os.path.abspath(__file__), tmp_path, {'jax_keys': _jax_keys(3)})
    # rank = 2 * stage + data on ('stage', 'data')
    for r in ranks:
        assert not r['init_again'] and r['placements']
        assert r['dp_layout'] and r['dict_warns'] and r['host_numpy']
        np.testing.assert_array_equal(r['stream_mesh'], r['stream_plain'])
    for d in range(2):
        np.testing.assert_array_equal(ranks[d]['dp_ids'], ranks[2 + d]['dp_ids'])
    together = np.concatenate([ranks[0]['dp_ids'], ranks[1]['dp_ids']])
    assert sorted(together.tolist()) == list(range(ROWS))

    # InMemTorchLoader on ('data',): rank = shard; global batch = ranks' rows in order
    def global_batches(key):
        return np.concatenate([r[key] for r in ranks], axis=-1)

    sequential, _ = _jax_scan(url, shuffle=False)
    np.testing.assert_array_equal(global_batches('sequential'), sequential[0])
    assert global_batches('sequential')[0].tolist() == [s * 25 + j for s in range(4)
                                                        for j in range(4)]
    shuffled, jax_loader = _jax_scan(url, shuffle=True)
    np.testing.assert_array_equal(global_batches('jax_keys'), shuffled)
    for shard, r in enumerate(ranks):
        assert r['drop_warns'] and r['train']
        for epoch in range(EPOCHS):
            for key in ('own_keys', 'jax_keys'):
                got = r[key][epoch].ravel().tolist()   # 6 steps x 4 of the shard's 25 rows
                assert len(set(got)) == 24
                assert all(shard * 25 <= v < (shard + 1) * 25 for v in got)
        assert r['own_keys'][0].tolist() != r['own_keys'][1].tolist()
        np.testing.assert_array_equal(r['resident'], np.asarray(jax_loader._data['id'])[shard])
        assert r['guard_divisible'] and r['guard_dict'] and r['guard_host'] and r['guard_iter']

    host = _jax_inmem(url, num_epochs=1, seed=2, device_put=False)
    want = np.stack([np.asarray(b['id']) for b in host])
    for r in ranks:
        np.testing.assert_array_equal(r['iter'], want)


if __name__ == '__main__':
    _worker(*sys.argv[1:])
