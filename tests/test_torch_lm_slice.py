"""The long-context LM slice on the CPU at a small size, against the JAX
package: a token store (T = 256) read by both packages' make_reader and
loaders gives equal batches, and three Adam steps of the port's
TransformerLM with flash attention (the plain versions of K2-K4 on the CPU)
follow the JAX package's flax model and optax with the Pallas kernels
(interpret mode) from the same weights; then the packed variant, with
segments, positions and the packed loss.

Losses agree within 1e-4 relative: both run in float32 and differ by
summation order, and after a step by Adam's update of gradient entries at
float32 noise level (lr * g / (|g| + eps) may move those by up to lr), which
barely moves the loss because those entries barely move it."""

import numpy as np
import pytest

from petastorm_tpu_torch.benchmark.lm_data import (ragged_documents, token_rows,
                                                   write_packed_store, write_token_store)
from test_torch_device_stage import jax_batches, port_batches

T = 256
CONFIG = dict(vocab=256, embed=256, heads=2, layers=2, max_len=T)
LR = 3e-4
LOADER = dict(batch_size=2, shuffling_queue_capacity=8, seed=3, drop_last=True)
READER = dict(seed=1, shuffle_row_groups=True)


@pytest.fixture(scope='module')
def token_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('lm') / 'tokens')
    write_token_store(url, rows=12, seq_len=T, n_files=2, rowgroup_size_mb=1)
    return url


@pytest.fixture(scope='module')
def packed_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('lm') / 'packed')
    write_packed_store(url, ragged_documents(24, 16, 128, CONFIG['vocab'], seed=2), T)
    return url


def test_token_rows_are_the_bench_pattern():
    rows = token_rows(3, 40)
    base = np.random.RandomState(0).randint(0, 255, size=16, dtype=np.int32)
    np.testing.assert_array_equal(rows[0], np.tile(base, 3)[:40])
    np.testing.assert_array_equal(rows[2], np.roll(rows[0], 2))


@pytest.mark.parametrize('store_name', ['token_store', 'packed_store'])
def test_loaders_give_equal_batches(request, store_name):
    url = request.getfixturevalue(store_name)
    ours, _ = port_batches(url, READER, **LOADER)
    theirs, _ = jax_batches(url, READER, device_put=False, **LOADER)
    assert len(ours) == len(theirs) >= 3
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for key in want:
            if key in ('doc_id', 'bin_id'):   # int64: JAX under x32 keeps the low word
                np.testing.assert_array_equal(got[key], want[key].astype(np.int64))
                continue
            assert got[key].dtype == want[key].dtype == np.int32, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _jax_losses(batches, packed, steps):
    import jax
    import jax.numpy as jnp
    import optax
    from petastorm_tpu.models.transformer import TransformerLM, next_token_loss
    from petastorm_tpu.ops.flash_attention import flash_attention
    from petastorm_tpu.ops.packing import packed_next_token_loss, segment_causal_attention

    def model_for(segments):
        if segments is None:
            attention = lambda q, k, v: flash_attention(q, k, v, True, 128, 128)  # noqa: E731
        else:
            attention = segment_causal_attention(segments, use_flash=True, block_q=128,
                                                 block_k=128)
        return TransformerLM(dtype=jnp.float32, attention_fn=attention, **CONFIG)

    tokens0 = jnp.asarray(batches[0]['tokens'])
    variables = model_for(None).init(jax.random.PRNGKey(0), tokens0)
    initial = jax.tree_util.tree_map(np.asarray, variables)
    tx = optax.adam(LR)
    opt_state = tx.init(variables)

    def loss_fn(params, batch):
        tokens = batch['tokens']
        if not packed:
            return next_token_loss(model_for(None).apply(params, tokens), tokens)
        segments = batch['tokens_segments']
        logits = model_for(segments).apply(params, tokens, batch['tokens_positions'])
        return packed_next_token_loss(logits, tokens, segments)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    params = variables
    for batch in batches[:steps]:
        params, opt_state, loss = step(params, opt_state,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
    return initial, losses


def _port_losses(batches, initial, packed, steps):
    import torch
    from petastorm_tpu_torch.convert import transformer_state_dict_from_flax
    from petastorm_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from petastorm_tpu_torch.ops.flash_attention import flash_attention
    from petastorm_tpu_torch.ops.packing import packed_next_token_loss, segment_causal_attention
    model = TransformerLM(dtype=torch.float32, device='cpu',
                          attention_fn=lambda q, k, v: flash_attention(q, k, v, causal=True),
                          **CONFIG)
    model.load_state_dict(transformer_state_dict_from_flax(initial))
    optimizer = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for batch in batches[:steps]:
        tokens = torch.from_numpy(batch['tokens'])
        optimizer.zero_grad()
        if packed:
            segments = torch.from_numpy(batch['tokens_segments'])
            logits = model(tokens, positions=torch.from_numpy(batch['tokens_positions']),
                           attention_fn=segment_causal_attention(segments, use_flash=True))
            loss = packed_next_token_loss(logits, tokens, segments)
        else:
            loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        optimizer.step()
        losses.append(float(loss.detach()))
    return losses


@pytest.mark.parametrize('store_name,packed,steps', [
    ('token_store', False, 3), ('packed_store', True, 3)])
def test_training_steps_match_jax(request, store_name, packed, steps):
    import importlib
    flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')
    url = request.getfixturevalue(store_name)
    ours, _ = port_batches(url, READER, **LOADER)
    theirs, _ = jax_batches(url, READER, device_put=False, **LOADER)
    initial, want = _jax_losses(theirs, packed, steps)
    before = flash.dense_fallbacks
    got = _port_losses(ours, initial, packed, steps)
    assert flash.dense_fallbacks == before
    assert len(got) == len(want) == steps and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[-1]   # the steps moved the weights
