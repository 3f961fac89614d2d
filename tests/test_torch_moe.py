"""The port's MoE layers (petastorm_tpu_torch.models.moe) against
petastorm_tpu.models.moe, with the flax weights carried over by
moe_state_dict_from_flax.

Routing probabilities come from random data, so no two of a token's
probabilities tie: torch.topk's order among ties is not fixed on CUDA, while
lax.top_k takes the lower index. Tolerances: dispatch and combine exact (0/1
masks and the gates themselves); aux loss and drop fraction within 1e-6;
float32 outputs within rtol 2e-4, atol 2e-5, as tests/test_moe.py holds the
JAX layer against its loop reference; gradients within 1e-4 of the largest
gradient entry; the Adam step as tests/test_torch_transformer.py holds it
(from the same gradients, 3e-7 relative plus 3e-8)."""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.convert import moe_state_dict_from_flax
from petastorm_tpu_torch.models.moe import (MoEMlp, MoETransformerLM, expert_partition_specs,
                                            moe_aux_total, moe_drop_fractions,
                                            switch_routing)
from petastorm_tpu_torch.models.transformer import next_token_loss

TOL = dict(rtol=2e-4, atol=2e-5)
LM = dict(vocab=32, embed=16, heads=2, layers=2, num_experts=4, max_len=32)


def _probs(tokens, experts, seed):
    logits = np.random.RandomState(seed).randn(tokens, experts).astype(np.float32)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize('k,capacity', [(1, 16), (1, 2), (2, 16), (2, 1), (2, 3)])
def test_switch_routing_matches_jax(k, capacity):
    import jax.numpy as jnp
    from petastorm_tpu.models.moe import switch_routing as jax_routing
    probs = _probs(32, 4, seed=k * 100 + capacity)
    want = jax_routing(jnp.asarray(probs), capacity, k)
    got = switch_routing(torch.from_numpy(probs), capacity, k)
    for name, g, w in zip(('dispatch', 'combine'), got[:2], want[:2]):
        assert g.shape == (32, 4, capacity) and g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name, g, w in zip(('aux', 'drop_fraction'), got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), atol=1e-6, rtol=0, err_msg=name)
    if capacity == 1:
        # slot-major: a first choice wins a slot before any second choice
        first = got[0].sum(dim=(1, 2)) > 0
        assert float(got[3]) > 0 and int(first.sum()) == 4


def _flax_mlp(k, capacity_factor, seed):
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models.moe import MoEMlp as FlaxMoEMlp
    model = FlaxMoEMlp(num_experts=4, capacity_factor=capacity_factor, num_selected=k,
                       hidden_mult=2, dtype=jnp.float32)
    x = np.random.RandomState(seed).randn(2, 8, 16).astype(np.float32)
    variables = _numpy(model.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return model, variables, x


def _port_mlp(variables, k, capacity_factor):
    model = MoEMlp(16, 4, capacity_factor=capacity_factor, num_selected=k, hidden_mult=2,
                   dtype=torch.float32, device='cpu')
    model.load_state_dict(moe_state_dict_from_flax(variables))
    return model


@pytest.mark.parametrize('k,capacity_factor', [(1, 8.0), (1, 0.5), (2, 8.0), (2, 0.5)])
def test_moe_mlp_matches_flax(k, capacity_factor):
    import jax.numpy as jnp
    flax_model, variables, x = _flax_mlp(k, capacity_factor, seed=k)
    want, mods = flax_model.apply(variables, jnp.asarray(x), mutable='losses')
    got, losses = _port_mlp(variables, k, capacity_factor)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for key in ('moe_aux', 'moe_drop_fraction'):
        np.testing.assert_allclose(losses[key].item(), float(mods['losses'][key][0]),
                                   atol=1e-6, rtol=0, err_msg=key)
    if capacity_factor < 1:
        assert losses['moe_drop_fraction'].item() > 0


def _loop_reference(state, x):
    """Per-token top-1 routing the slow, obvious way (no capacity drops), as
    tests/test_moe.py computes it, in numpy."""
    router = state['router.weight'].numpy().T
    w1, w2 = state['w1'].numpy(), state['w2'].numpy()
    tokens = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = tokens @ router
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    out = np.zeros_like(tokens)
    for s in range(tokens.shape[0]):
        e = int(np.argmax(probs[s]))
        h = tokens[s] @ w1[e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
        out[s] = (h @ w2[e]) * probs[s, e]
    return out.reshape(x.shape)


def test_moe_mlp_matches_the_loop_reference():
    _, variables, x = _flax_mlp(1, 8.0, seed=5)
    model = _port_mlp(variables, 1, 8.0)
    got, losses = model(torch.from_numpy(x))
    assert losses['moe_drop_fraction'].item() == 0.0
    np.testing.assert_allclose(got.detach().numpy(), _loop_reference(model.state_dict(), x),
                               **TOL)


def _flax_lm(moe_every, seed, attention_fn=None, tokens=None):
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models.moe import MoETransformerLM as FlaxLM
    model = FlaxLM(dtype=jnp.float32, moe_every=moe_every, attention_fn=attention_fn, **LM)
    if tokens is None:
        tokens = np.random.RandomState(seed).randint(0, LM['vocab'], (2, 16)).astype(np.int32)
    variables = {'params': _numpy(model.init(jax.random.PRNGKey(seed),
                                             jnp.asarray(tokens))['params'])}
    return model, variables, tokens


def _port_lm(variables, moe_every, **kwargs):
    model = MoETransformerLM(dtype=torch.float32, moe_every=moe_every, device='cpu', **LM,
                             **kwargs)
    model.load_state_dict(moe_state_dict_from_flax(variables, moe_every))
    return model


def _flax_loss_and_grads(flax_model, variables, tokens, loss_of=None):
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models.moe import moe_aux_total as flax_aux
    from petastorm_tpu.models.transformer import next_token_loss as flax_next

    def loss_fn(params):
        logits, mods = flax_model.apply(params, jnp.asarray(tokens), mutable='losses')
        main = loss_of(logits) if loss_of else flax_next(logits, jnp.asarray(tokens))
        return main + flax_aux(mods, weight=0.01)

    params = jax.tree_util.tree_map(jnp.asarray, variables)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), grads


def _check_grads(model, want_grads):
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4 * scale, rtol=0, err_msg=name)


def test_converter_covers_every_parameter():
    for moe_every in (1, 2):
        _, variables, _ = _flax_lm(moe_every, seed=0)
        state = moe_state_dict_from_flax(variables, moe_every)
        model = MoETransformerLM(moe_every=moe_every, device='cpu', **LM)
        assert sorted(state) == sorted(model.state_dict())
        for name, value in model.state_dict().items():
            assert state[name].shape == value.shape and state[name].dtype == torch.float32


@pytest.mark.parametrize('moe_every', [1, 2])
def test_lm_logits_losses_gradients_and_adam_step_match_flax(moe_every):
    import jax
    import jax.numpy as jnp
    import optax
    from petastorm_tpu.models.moe import moe_drop_fractions as flax_drops
    flax_model, variables, tokens = _flax_lm(moe_every, seed=moe_every)
    want_logits, mods = flax_model.apply(variables, jnp.asarray(tokens), mutable='losses')
    loss, grads = _flax_loss_and_grads(flax_model, variables, tokens)

    model = _port_lm(variables, moe_every)
    logits, losses = model(torch.from_numpy(tokens))
    assert sorted(losses) == sorted(mods['losses'])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose([d.item() for d in moe_drop_fractions(losses)],
                               [float(d) for d in flax_drops(mods)], atol=1e-6, rtol=0)
    got_loss = next_token_loss(logits, torch.from_numpy(tokens)) + moe_aux_total(losses, 0.01)
    np.testing.assert_allclose(got_loss.item(), loss, rtol=2e-4, atol=2e-5)
    got_loss.backward()
    want_grads = moe_state_dict_from_flax({'params': _numpy(grads['params'])}, moe_every)
    _check_grads(model, want_grads)

    tx = optax.adam(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    updates, _ = tx.update(grads, tx.init(params), params)
    want_params = moe_state_dict_from_flax(_numpy(optax.apply_updates(params, updates)),
                                           moe_every)
    for name, param in model.named_parameters():
        param.grad = want_grads[name].clone()
    torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8).step()
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), atol=3e-8,
                                   rtol=3e-7, err_msg=name)


def test_remat_gives_the_same_outputs_losses_and_gradients():
    _, variables, tokens = _flax_lm(2, seed=7)
    tokens = torch.from_numpy(tokens)
    results = []
    for remat in (False, True):
        model = _port_lm(variables, 2, remat=remat)
        logits, losses = model(tokens)
        loss = next_token_loss(logits, tokens) + moe_aux_total(losses, 0.01)
        loss.backward()
        results.append((logits.detach(), moe_aux_total(losses).item(),
                        [p.grad.clone() for p in model.parameters()]))
    (plain_logits, plain_aux, plain_grads), (remat_logits, remat_aux, remat_grads) = results
    torch.testing.assert_close(remat_logits, plain_logits)
    assert remat_aux == plain_aux
    for plain, recomputed in zip(plain_grads, remat_grads):
        torch.testing.assert_close(plain, recomputed)


def test_packed_batch_matches_flax():
    import jax.numpy as jnp
    from petastorm_tpu.ops.packing import packed_next_token_loss as flax_packed_loss
    from petastorm_tpu.ops.packing import segment_causal_attention as flax_segment_attention
    from petastorm_tpu_torch.ops.packing import (pack_sequences, packed_next_token_loss,
                                                 segment_causal_attention)
    rng = np.random.RandomState(8)
    packed = pack_sequences([rng.randint(1, 32, size=n).astype(np.int32)
                             for n in (10, 7, 12, 5, 9, 6)], 16)
    tokens, segments = packed['tokens'], packed['segments']
    flax_model, variables, _ = _flax_lm(
        2, seed=8, attention_fn=flax_segment_attention(jnp.asarray(segments)), tokens=tokens)
    loss, grads = _flax_loss_and_grads(
        flax_model, variables, tokens,
        lambda logits: flax_packed_loss(logits, jnp.asarray(tokens), jnp.asarray(segments)))

    model = _port_lm(variables, 2)
    tokens_t, segments_t = torch.from_numpy(tokens), torch.from_numpy(segments)
    logits, losses = model(tokens_t, attention_fn=segment_causal_attention(segments_t))
    got = packed_next_token_loss(logits, tokens_t, segments_t) + moe_aux_total(losses, 0.01)
    np.testing.assert_allclose(got.item(), loss, rtol=2e-4, atol=2e-5)
    got.backward()
    _check_grads(model, moe_state_dict_from_flax({'params': _numpy(grads['params'])}, 2))


def _spec_by_name(flax_tree, specs, state_of):
    """The JAX specs keyed by the port's names: each flax leaf is replaced by
    an array holding its index, and the converter says where it lands."""
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(flax_tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: type(x).__name__ == 'PartitionSpec')
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), i, np.float32) for i, leaf in enumerate(leaves)])
    return {name: tuple(spec_leaves[int(value.flatten()[0])])
            for name, value in state_of(ids).items()}


def test_expert_partition_specs_match_jax():
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models.moe import expert_partition_specs as jax_specs
    for moe_every in (1, 2):
        _, variables, _ = _flax_lm(moe_every, seed=0)
        want = _spec_by_name(variables, jax_specs(variables),
                             lambda tree: moe_state_dict_from_flax(tree, moe_every))
        state = _port_lm(variables, moe_every).state_dict()
        assert expert_partition_specs(state) == want
        assert sum(spec[0] == 'expert' for spec in want.values()) == 2 * (2 // moe_every)
    # a root MoEMlp, recognised by its router sibling
    _, variables, _ = _flax_mlp(1, 1.25, seed=0)
    want = _spec_by_name(variables, jax_specs(variables), moe_state_dict_from_flax)
    assert expert_partition_specs(_port_mlp(variables, 1, 1.25).state_dict()) == want
    assert want['w1'] == ('expert', None, None) and want['router.weight'] == (None, None)
    # 3-D w1/w2 with no router (stacked stage weights) stay replicated
    stacked = {'w1': np.zeros((4, 8, 16), np.float32), 'w2': np.zeros((4, 16, 8), np.float32)}
    want = jax_specs({name: jnp.asarray(x) for name, x in stacked.items()})
    got = expert_partition_specs({name: torch.from_numpy(x) for name, x in stacked.items()})
    assert got == {name: tuple(spec) for name, spec in want.items()} == {
        'w1': (None, None, None), 'w2': (None, None, None)}
    # a stacked MoE weight beside a router raises, in both
    scope = {'router': {'kernel': jnp.zeros((8, 4))}, 'w1': jnp.zeros((2, 4, 8, 16)),
             'w2': jnp.zeros((2, 4, 16, 8))}
    with pytest.raises(ValueError, match='ndim'):
        jax_specs({'params': {'MoEBlock_0': {'MoEMlp_0': scope}}})
    with pytest.raises(ValueError, match='ndim'):
        expert_partition_specs({'blocks.0.moe.router.weight': torch.zeros(4, 8),
                                'blocks.0.moe.w1': torch.zeros(2, 4, 8, 16),
                                'blocks.0.moe.w2': torch.zeros(2, 4, 16, 8)})
    del jax


def test_errors_and_collectors():
    with pytest.raises(ValueError, match='num_selected'):
        MoEMlp(8, 2, num_selected=3, device='cpu')
    with pytest.raises(ValueError, match='num_selected'):
        switch_routing(torch.full((4, 2), 0.5), 4, 3)
    with pytest.raises(ValueError, match='divisible'):
        MoETransformerLM(embed=10, heads=3, device='cpu')
    model = MoETransformerLM(moe_every=3, device='cpu', **LM)   # no MoE layer
    logits, losses = model(torch.zeros(1, 4, dtype=torch.int64))
    assert losses == {} and moe_drop_fractions(losses) == []
    assert float(moe_aux_total(losses)) == 0.0
    nested = {'MoEBlock_0': {'MoEMlp_0': {'moe_aux': torch.tensor(2.0),
                                          'moe_drop_fraction': torch.tensor(0.5)}}}
    assert float(moe_aux_total(nested, weight=0.5)) == 1.0
    assert [float(d) for d in moe_drop_fractions(nested)] == [0.5]


def test_generator_draws_the_weights():
    first = MoETransformerLM(device='cpu', generator=torch.Generator().manual_seed(3), **LM)
    again = MoETransformerLM(device='cpu', generator=torch.Generator().manual_seed(3), **LM)
    other = MoETransformerLM(device='cpu', generator=torch.Generator().manual_seed(4), **LM)
    for (name, a), b, c in zip(first.state_dict().items(), again.state_dict().values(),
                               other.state_dict().values()):
        assert torch.equal(a, b), name
        if name.endswith(('w1', 'w2', 'qkv.weight', 'tok_embed.weight')):
            assert not torch.equal(a, c), name


def test_mfu_flop_count_is_the_jax_package_s():
    from petastorm_tpu.benchmark.mfu import moe_transformer_train_flops_per_step as jax_flops
    from petastorm_tpu_torch.benchmark.mfu import moe_transformer_train_flops_per_step
    for args in ((4, 2048, 256, 512, 2, 8), (2, 16, 32, 16, 3, 4, 2, 2)):
        assert moe_transformer_train_flops_per_step(*args) == jax_flops(*args)
    assert moe_transformer_train_flops_per_step(4, 2048, 256, 512, 2, 8) == 419161964544
