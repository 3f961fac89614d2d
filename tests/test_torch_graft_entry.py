"""The port's twin of ``__graft_entry__.py`` (petastorm_tpu_torch.graft_entry)
and its tensor-parallel pieces (petastorm_tpu_torch.parallel.tensor_parallel)
in one process, on the CPU:

- ``_mesh_axis_sizes(n)`` equals the JAX script's for n = 1..64;
- ``entry()`` 's forward, on the JAX script's ``MnistCNN`` params carried
  over by ``mnist_state_dict_from_flax``, equals the JAX script's forward on
  its zeros and on seeded images (uniform in [0, 1), as pixels), within
  atol 1e-5 (both in bf16, the models' default);
- f and g (``copy_to_group``, ``reduce_from_group``) on a one-rank gloo group
  are identities, forward and backward; ``shard_by_spec`` and
  ``next_token_targets`` at one rank;
- ``TensorParallelLM`` at one rank equals ``TransformerLM`` with causal
  flash attention on the same weights (the ring at one rank is one flash
  call; float32, loss and every gradient within 1e-6 relative, measured
  equal);
- ``dryrun_multichip(1, device='cpu')`` completes with finite values, its
  phase-5 losses fall by more than 1e-3, and a world of another size is
  refused. Across ranks: tests/test_torch_multichip_scale.py."""

import datetime
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        'graft_entry_jax', os.path.join(REPO, '__graft_entry__.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group for the test, destroyed after it."""
    dist.init_process_group('gloo', init_method='file://' + str(tmp_path / 'store'), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_axis_sizes_equal_the_jax_scripts():
    from petastorm_tpu_torch.graft_entry import _mesh_axis_sizes
    jax_sizes = _jax_script()._mesh_axis_sizes
    for n in range(1, 65):
        assert _mesh_axis_sizes(n) == jax_sizes(n), n


def test_entry_forward_equals_the_jax_scripts():
    from petastorm_tpu_torch.convert import mnist_state_dict_from_flax
    from petastorm_tpu_torch.graft_entry import entry
    jax_forward, (params, jax_images) = _jax_script().entry()
    forward, (model, images) = entry(device='cpu')
    assert images.shape == (8, 28, 28, 1) and images.dtype == torch.float32
    assert not images.any()
    model.load_state_dict(mnist_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    seeded = np.random.RandomState(0).rand(8, 28, 28, 1).astype(np.float32)
    for port_x, jax_x in ((images, jax_images), (torch.from_numpy(seeded), seeded)):
        with torch.no_grad():
            got = forward(model, port_x)
        want = np.asarray(jax_forward(params, jax_x))
        assert got.shape == want.shape == (8, 10)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_f_and_g_are_identities_on_one_rank(one_rank):
    from petastorm_tpu_torch.parallel.tensor_parallel import copy_to_group, reduce_from_group
    group = dist.group.WORLD
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).requires_grad_()
    weight = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    for fn in (copy_to_group, reduce_from_group):
        x.grad = None
        y = fn(x, group)
        assert torch.equal(y, x)
        (y * weight).sum().backward()
        assert torch.equal(x.grad, weight)


def test_shards_and_targets_at_one_rank(one_rank):
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.tensor_parallel import next_token_targets, shard_by_spec
    mesh = make_mesh(('data', 'seq', 'model'), (1, 1, 1), device='cpu')
    x = torch.arange(24).reshape(2, 3, 4)
    assert torch.equal(shard_by_spec(x, P('data', None, ('seq', 'model')), mesh), x)
    with pytest.raises(ValueError, match='more entries'):
        shard_by_spec(x, P(None, None, None, 'model'), mesh)
    tokens = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    targets, valid = next_token_targets(tokens, mesh['seq'])
    assert targets[:, :-1].tolist() == [[2, 3, 4], [6, 7, 8]]
    assert valid.tolist() == [[True, True, True, False]] * 2


@pytest.mark.parametrize('remat', [False, True])
def test_tensor_parallel_lm_equals_the_lm_at_one_rank(one_rank, remat):
    from petastorm_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from petastorm_tpu_torch.ops.flash_attention import flash_attention
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.tensor_parallel import (ColumnCutDense, RowCutDense,
                                                              TensorParallelLM)
    mesh = make_mesh(('data', 'seq', 'model'), (1, 1, 1), device='cpu')
    kwargs = dict(vocab=32, embed=128, heads=2, layers=2, max_len=16, dtype=torch.float32,
                  device='cpu')
    lm = TransformerLM(generator=torch.Generator().manual_seed(0),
                       attention_fn=lambda q, k, v: flash_attention(q, k, v, causal=True),
                       **kwargs)
    composed = TensorParallelLM(TransformerLM(generator=torch.Generator().manual_seed(0),
                                              remat=remat, **kwargs), mesh)
    # the blocks stay the LM's own, run by its forward (remat included)
    assert all(isinstance(b.mlp_up, ColumnCutDense) and isinstance(b.mlp_down, RowCutDense)
               for b in composed.lm.blocks)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 32, (2, 16)))
    want = next_token_loss(lm(tokens), tokens)
    want.backward()
    share, loss = composed.loss(tokens)
    share.backward()
    composed.reduce_gradients()
    torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=0)
    grads = dict(lm.named_parameters())
    for name, param in composed.named_parameters():
        want_grad = grads[name[len('lm.'):]].grad
        torch.testing.assert_close(param.grad, want_grad, rtol=1e-6, atol=1e-9, msg=name)
    assert sorted(composed.specs) == sorted(
        'lm.blocks.{}.{}'.format(i, leaf) for i in range(2)
        for leaf in ('mlp_up.weight', 'mlp_up.bias', 'mlp_down.weight'))


def test_dryrun_multichip_at_one_rank():
    from petastorm_tpu_torch.graft_entry import dryrun_multichip
    result = dryrun_multichip(1, device='cpu')
    assert not dist.is_initialized()     # the one-rank group it started is gone
    assert result['mesh'] == (1, 1, 1)
    for phase in ('dp_sp_tp', 'pp_dp', 'ep_dp', 'pp_tp_dp'):
        assert np.isfinite(result[phase]['loss'])
        assert all(np.isfinite(g).all() for g in result[phase]['grads'].values())
    assert result['dp_sp_tp']['tokens'].shape == (2, 8)
    assert np.isfinite(result['scan_epochs']['carry'])
    losses = result['dp_sp_ep']['losses']
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1e-3, losses


def test_dryrun_multichip_refuses_another_world_size(one_rank):
    from petastorm_tpu_torch.graft_entry import dryrun_multichip
    with pytest.raises(RuntimeError, match='world of 2 ranks'):
        dryrun_multichip(2, device='cpu')
