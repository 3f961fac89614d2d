"""The port's TransformerLM (petastorm_tpu_torch.models.transformer) against
petastorm_tpu's flax TransformerLM, with the flax weights carried over by
transformer_state_dict_from_flax: logits with and without explicit positions,
through dense and through flash attention, and one Adam step against
optax.adam from the same weights.

Tolerances: in float32, logits within 2e-5 (the same float32 arithmetic,
summed in another order); in bfloat16, within 0.06 absolute, two bf16 ulps
of the largest logit (~4.7): both models round activations to bfloat16 at a
dozen places a layer, not always to the same neighbour; gradients within 1e-6 of the largest
gradient entry. The Adam step is held against optax from the same weights and
the same gradients, within 3e-7 relative plus 3e-8 (2.5 float32 ulps of a
weight of magnitude <= 1, 0.1-0.5 for most): its first update is lr * g / (|g| + eps),
which can move by up to lr where a gradient entry is as small as the float32
noise between the two models' gradients, so comparing steps taken from the
two models' own gradients would test that noise, not the optimizer."""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.convert import transformer_state_dict_from_flax
from petastorm_tpu_torch.models.transformer import TransformerLM, next_token_loss
from petastorm_tpu_torch.ops.flash_attention import flash_attention

CONFIG = dict(vocab=32, embed=128, heads=2, layers=2, max_len=64)
T = 48


def _flax_variables(dtype_name='float32', seed=0):
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models.transformer import TransformerLM as FlaxLM
    model = FlaxLM(dtype=getattr(jnp, dtype_name), **CONFIG)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, T), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(variables, dtype, **kwargs):
    model = TransformerLM(dtype=dtype, device='cpu', **CONFIG, **kwargs)
    model.load_state_dict(transformer_state_dict_from_flax(variables))
    return model


def _tokens_positions(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CONFIG['vocab'], size=(2, T)).astype(np.int32)
    positions = np.concatenate([np.arange(20), np.arange(T - 20)])[None].repeat(2, 0)
    return tokens, positions.astype(np.int32)


def _causal_flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


def test_converter_covers_every_parameter():
    _, variables = _flax_variables()
    state = transformer_state_dict_from_flax(variables)
    model = TransformerLM(device='cpu', **CONFIG)
    assert sorted(state) == sorted(model.state_dict())
    for name, value in model.state_dict().items():
        assert state[name].shape == value.shape, name
        assert state[name].dtype == torch.float32


@pytest.mark.parametrize('dtype_name,atol', [('float32', 2e-5), ('bfloat16', 0.06)])
@pytest.mark.parametrize('with_positions', [False, True])
@pytest.mark.parametrize('attention', ['dense', 'flash'])
def test_logits_match_flax(dtype_name, atol, with_positions, attention):
    import jax.numpy as jnp
    flax_model, variables = _flax_variables(dtype_name)
    tokens, positions = _tokens_positions()
    want = np.asarray(flax_model.apply(
        variables, jnp.asarray(tokens), jnp.asarray(positions) if with_positions else None))
    model = _port_model(variables, getattr(torch, dtype_name),
                        attention_fn=_causal_flash if attention == 'flash' else None)
    got = model(torch.from_numpy(tokens),
                torch.from_numpy(positions) if with_positions else None)
    assert got.dtype == torch.float32 and got.shape == (2, T, CONFIG['vocab'])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=0)


def test_remat_gives_the_same_gradients():
    _, variables = _flax_variables()
    tokens = torch.from_numpy(_tokens_positions()[0])
    grads = []
    for remat in (False, True):
        model = _port_model(variables, torch.float32, remat=remat,
                            attention_fn=_causal_flash)
        next_token_loss(model(tokens), tokens).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for plain, recomputed in zip(*grads):
        torch.testing.assert_close(plain, recomputed)


def test_max_len_and_heads_are_checked():
    model = TransformerLM(device='cpu', **CONFIG)
    with pytest.raises(ValueError, match='max_len'):
        model(torch.zeros(1, CONFIG['max_len'] + 1, dtype=torch.int64))
    with pytest.raises(ValueError, match='divisible'):
        TransformerLM(vocab=8, embed=10, heads=3, device='cpu')
    with pytest.raises(ValueError, match='length >= 2'):
        next_token_loss(torch.zeros(1, 1, 8), torch.zeros(1, 1, dtype=torch.int64))


def test_gradients_and_one_adam_step_match_optax():
    import jax
    import jax.numpy as jnp
    import optax
    from petastorm_tpu.models.transformer import next_token_loss as flax_loss
    flax_model, variables = _flax_variables(seed=1)
    tokens = _tokens_positions(seed=1)[0]
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    loss, grads = jax.value_and_grad(
        lambda p: flax_loss(flax_model.apply(p, jnp.asarray(tokens)), jnp.asarray(tokens)))(params)
    tx = optax.adam(1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    want_params = transformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates)))
    want_grads = transformer_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))

    model = _port_model(variables, torch.float32, attention_fn=_causal_flash)
    got_loss = next_token_loss(model(torch.from_numpy(tokens)), torch.from_numpy(tokens))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-6 * scale, rtol=0, err_msg=name)
        param.grad = want_grads[name].clone()
    before = {name: value.clone() for name, value in model.state_dict().items()}
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    optimizer.step()
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), atol=3e-8,
                                   rtol=3e-7, err_msg=name)
        assert not torch.equal(value, before[name]), name
