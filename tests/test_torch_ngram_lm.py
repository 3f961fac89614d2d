"""Phase 12a's path (``chip_smoke.py``) on the CPU at a small size, against
the JAX package: a frame store (streams of 64-token frames, one rowgroup a
stream, a rowgroup index on ``stream_id``) read with an NGram of 4 frames and
a selector of the even streams -> ``TorchDataLoader`` gives the batches
``JaxDataLoader`` gives, and three Adam steps of the port's TransformerLM
with flash attention (its plain version on the CPU) on the windows reshaped
to ``[batch, 256]`` follow the JAX package's flax model with dense attention
and optax from the same weights (one head of 64, a head_dim the kernels
take).

Losses agree within 1e-4 relative: both run in float32 and differ by
summation order (flash against dense attention included), and after a step
by Adam's update of gradient entries at float32 noise level."""

import numpy as np
import pytest

STREAMS = 4
FRAMES = 16
FRAME_LEN = 64
WINDOW = 4
SELECTED = [0, 2]
CONFIG = dict(vocab=256, embed=64, heads=1, layers=2, max_len=WINDOW * FRAME_LEN)
LR = 3e-4
STEPS = 3


@pytest.fixture(scope='module')
def frame_store(tmp_path_factory):
    from petastorm_tpu_torch.benchmark.lm_data import write_frame_store
    url = 'file://' + str(tmp_path_factory.mktemp('frames') / 'store')
    frames = write_frame_store(url, STREAMS, FRAMES, FRAME_LEN, CONFIG['vocab'], n_files=2,
                               seed=0)
    return url, frames


def _reader_args(package):
    if package == 'port':
        from petastorm_tpu_torch.ngram import NGram
        from petastorm_tpu_torch.selectors import SingleIndexSelector
    else:
        from petastorm_tpu.ngram import NGram
        from petastorm_tpu.selectors import SingleIndexSelector
    ngram = NGram({i: ['tokens', 'frame_id'] for i in range(WINDOW)}, delta_threshold=1,
                  timestamp_field='frame_id', timestamp_overlap=False)
    return dict(schema_fields=ngram, rowgroup_selector=SingleIndexSelector('stream', SELECTED),
                reader_pool_type='dummy', shuffle_row_groups=True, seed=7)


def _port_batches(url):
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    with make_reader(url, **_reader_args('port')) as reader:
        return [{k: v.numpy() for k, v in b.items()}
                for b in TorchDataLoader(reader, batch_size=2, device='cpu')]


def _jax_batches(url):
    from petastorm_tpu import make_reader
    from petastorm_tpu.parallel.loader import JaxDataLoader
    with make_reader(url, **_reader_args('jax')) as reader:
        return [{k: np.asarray(v) for k, v in b.items()}
                for b in JaxDataLoader(reader, batch_size=2, device_put=False)]


def test_window_batches_match_jax(frame_store):
    url, frames = frame_store
    ours, theirs = _port_batches(url), _jax_batches(url)
    assert len(ours) == len(theirs) == len(SELECTED) * FRAMES // WINDOW // 2
    for got, want in zip(ours, theirs):
        assert got['tokens'].shape == (2, WINDOW, FRAME_LEN) and got['tokens'].dtype == np.int32
        np.testing.assert_array_equal(got['tokens'], want['tokens'])
        np.testing.assert_array_equal(got['frame_id'], want['frame_id'].astype(np.int64))
        # a window's tokens are its frames' tokens, in order
        np.testing.assert_array_equal(got['tokens'],
                                      frames.reshape(-1, FRAME_LEN)[got['frame_id']])
    starts = sorted(int(f) for b in ours for f in b['frame_id'][:, 0])
    assert starts == [s * FRAMES + w * WINDOW for s in SELECTED
                      for w in range(FRAMES // WINDOW)]


def _jax_losses(batches):
    import jax
    import jax.numpy as jnp
    import optax
    from petastorm_tpu.models.transformer import TransformerLM, next_token_loss
    model = TransformerLM(dtype=jnp.float32, **CONFIG)
    tokens0 = jnp.asarray(batches[0]['tokens'].reshape(2, -1))
    variables = model.init(jax.random.PRNGKey(0), tokens0)
    initial = jax.tree_util.tree_map(np.asarray, variables)
    tx = optax.adam(LR)
    opt_state = tx.init(variables)

    @jax.jit
    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: next_token_loss(model.apply(p, tokens), tokens))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    params = variables
    for batch in batches[:STEPS]:
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(batch['tokens'].reshape(2, -1)))
        losses.append(float(loss))
    return initial, losses


def _port_losses(batches, initial):
    import torch
    from petastorm_tpu_torch.convert import transformer_state_dict_from_flax
    from petastorm_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from petastorm_tpu_torch.ops.flash_attention import flash_attention
    model = TransformerLM(dtype=torch.float32, device='cpu',
                          attention_fn=lambda q, k, v: flash_attention(q, k, v, causal=True),
                          **CONFIG)
    model.load_state_dict(transformer_state_dict_from_flax(initial))
    optimizer = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for batch in batches[:STEPS]:
        tokens = torch.from_numpy(batch['tokens']).reshape(2, -1)
        optimizer.zero_grad()
        loss = next_token_loss(model(tokens), tokens)
        loss.backward()
        optimizer.step()
        losses.append(float(loss.detach()))
    return losses


def test_training_on_windows_matches_jax(frame_store):
    import importlib
    flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')
    url, _ = frame_store
    initial, want = _jax_losses(_jax_batches(url))
    before = flash.dense_fallbacks
    got = _port_losses(_port_batches(url), initial)
    assert flash.dense_fallbacks == before
    assert len(got) == len(want) == STEPS and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[-1]   # the steps moved the weights
