"""Composed parallelism in the port on ONE gloo world of 8 CPU ranks, against
the JAX package on one CPU device: the twin of tests/test_multichip_scale.py
and of the dry run it drives.

- ``petastorm_tpu_torch.graft_entry.dryrun_multichip(8, device='cpu')`` on
  the meshes of ``__graft_entry__.py`` at n = 8 (phase 1 on (data, seq,
  model) = (2, 2, 2)), fed the JAX package's own initial weights where the
  JAX script initializes flax modules (phase 3's Blocks, phase 4's
  MoETransformerLM, phase 6's stages), converted by ``convert.py``. Phases
  1, 3, 4 and 6: the loss and every gradient against the JAX package's
  dense network on the same global batch (``dense_attention``, flax
  ``Block``, flax ``MoETransformerLM`` applied to the whole batch as the JAX
  script applies it, the phase-6 MLP stages in sequence).
  Each phase's global batch holds rows of the store, and each rank its
  piece of it (under ``P('data', 'seq')`` its data rows' seq columns).
  Phase 2's carry equals twice the sum of every row (each epoch serves them
  all at this size), phase 5's six Adam losses fall.
- ``compose4`` on one (data, seq, stage, model) = (1, 2, 2, 2) mesh: ring
  attention over 'seq' feeding a pipeline over 'stage' of tensor-parallel
  MLP stages (f and g over 'model'); ``compose4_expert`` on (1, 2, 2, 2)
  with expert-parallel MoE stages (the all-to-all over 'expert'), the oracle
  routing per (microbatch, data shard, seq shard) token block with the
  shard-local capacity; ``wide3`` on (data, seq, model) = (1, 4, 2): a
  4-hop ring with 2-way tensor parallelism. Each: the loss and every
  gradient (of replicated and of sharded parameters) against the dense
  network, then 4 Adam steps whose loss falls by more than 1e-3.
- ``TensorParallelLM`` (the composed dp + sp + tp LM of the card's phase
  23b) on (data, seq, model) = (2, 2, 2): the next-token loss and every
  gradient against flax ``TransformerLM`` on the global batch, the weights
  carried over by ``transformer_state_dict_from_flax``.

Tolerance: the JAX scale suite's ``PARITY_TOL``, 3e-4 absolute on the loss
and on every gradient element (float32). Each gradient must also lie within
``GRAD_RTOL`` (1e-4) of its own largest magnitude: the dry run's weights are
scaled by 0.02, and 3e-4 alone passed a phase-6 embedding gradient 16% off
(f without its all-reduce). The largest share measured here is 4.3e-6.

Cut from the JAX suite: its meshes of 16 and 32 devices ((2, 2, 2, 2), (2, 2,
4, 2), (2, 4, 4) and the dry run at 16) do not fit in a world of 8 ranks, so
compose4 and compose4_expert run with data 1 and wide3 with 2-way tensor
parallelism. The rings' head_dim is 64 (the JAX suite's 4): their blocks are
the flash kernels, which take 64 or 128; the weights' scales shrink by the
square root of the wider fan-in so the activations keep the JAX suite's size.
The ranks are this file run as a script (no JAX in them)."""

import os
import sys

import numpy as np

from test_torch_sharded_moe import init_world, run_world

PARITY_TOL = 3e-4
GRAD_RTOL = 1e-4
WORLD = 8
H, D = 2, 64
E = H * D
F = 32                  # MLP hidden, over 'model'
V = 32
B, T, M = 4, 16, 2
X, FE, CAP = 4, 16, 8.0  # experts, expert hidden, no-drop capacity factor
#: (phase, mesh dimension names, sizes)
SCALE = (('compose4', ('data', 'seq', 'stage', 'model'), (1, 2, 2, 2)),
         ('compose4_expert', ('data', 'seq', 'stage', 'expert'), (1, 2, 2, 2)),
         ('wide3', ('data', 'seq', 'model'), (1, 4, 2)))


def _mat(rng, *shape, scale):
    return (rng.randn(*shape) * scale).astype(np.float32)


def scale_inputs():
    """The three scale phases' weights, tokens and labels (numpy)."""
    out = {}
    for phase, seed in (('compose4', 0), ('compose4_expert', 2), ('wide3', 1)):
        rng = np.random.RandomState(seed)
        if phase == 'wide3':
            params = {'embed': _mat(rng, V, E, scale=0.3), 'w1': _mat(rng, E, F, scale=0.025),
                      'w2': _mat(rng, F, E, scale=0.1), 'w_out': _mat(rng, E, V, scale=0.075)}
        else:
            stages = 2
            if phase == 'compose4':
                params = {'w1': _mat(rng, stages, E, F, scale=0.025),
                          'w2': _mat(rng, stages, F, E, scale=0.1)}
            else:
                params = {'router': _mat(rng, stages, E, X, scale=0.125),
                          'w1': _mat(rng, stages, X, E, FE, scale=0.075),
                          'w2': _mat(rng, stages, X, FE, E, scale=0.3)}
            params.update(embed=_mat(rng, V, E, scale=0.3),
                          **{k: _mat(rng, E, E, scale=0.025) for k in ('wq', 'wk', 'wv', 'wo')},
                          w_out=_mat(rng, E, V, scale=0.075))
        params['tokens'] = rng.randint(0, V, (B, T)).astype(np.int32)
        params['labels'] = rng.randint(0, V, (B, T)).astype(np.int32)
        out[phase] = params
    return out


def _specs(phase):
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    if phase == 'wide3':
        return {'w1': P(None, 'model'), 'w2': P('model', None)}
    if phase == 'compose4':
        return {'w1': P('stage', None, 'model'), 'w2': P('stage', 'model', None)}
    return {'router': P('stage', None, None), 'w1': P('stage', 'expert', None, None),
            'w2': P('stage', 'expert', None, None)}


def flatten(tree, prefix=''):
    """A nested dict (lists as dicts of their indices) -> ``{'a/b/c': array}``."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flatten(value, '{}{}/'.format(prefix, key)))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat):
    """The inverse of :func:`flatten` (dicts whose keys are 0..n-1 -> lists)."""
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split('/')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == [str(i) for i in range(len(node))]:
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(tree)


# ------------------------------------------------------------------ the ranks

def _run_scale(phase, names, sizes, params_np):
    """One scale phase on this rank: the first Adam step's loss and
    gradients, and the losses of 4 steps."""
    import torch

    from petastorm_tpu_torch.graft_entry import _leaves, _nll_sum, _step
    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.sharded_moe import gelu, sharded_moe_ffn
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.pipeline import make_pipeline, microbatch
    from petastorm_tpu_torch.parallel.tensor_parallel import (copy_to_group,
                                                              reduce_from_group,
                                                              shard_by_spec)
    mesh = make_mesh(names, sizes, device='cpu')
    specs = _specs(phase)
    tokens, labels = (shard_by_spec(torch.from_numpy(params_np[k]), P('data', 'seq'),
                                    mesh).contiguous() for k in ('tokens', 'labels'))
    weights = {k: v for k, v in params_np.items() if k not in ('tokens', 'labels')}
    p = _leaves(weights, 'cpu', mesh, specs)
    seq = mesh.get_group('seq')
    b, t = tokens.shape
    stage_leaves = {k: p[k] for k in specs}
    copies = 1

    if phase == 'wide3':
        model = mesh.get_group('model')

        def forward():
            x = p['embed'][tokens.long()].reshape(b, t, H, D)
            e = ring_attention(x, x, x, seq, causal=True).reshape(b, t, E)
            h = gelu(copy_to_group(e, model) @ p['w1'])
            return e + reduce_from_group(h @ p['w2'], model)
    else:
        if phase == 'compose4':
            model = mesh.get_group('model')

            def stage_fn(sp, mb):
                h = gelu(copy_to_group(mb, model) @ sp['w1'][0])
                return mb + reduce_from_group(h @ sp['w2'][0], model)
        else:
            copies = mesh['expert'].size()

            def stage_fn(sp, mb):
                out = sharded_moe_ffn(mb.reshape(-1, E), sp['router'][0], sp['w1'][0],
                                      sp['w2'][0], mesh['expert'], capacity_factor=CAP)[0]
                return mb + out.reshape(mb.shape)
        pipe = make_pipeline(stage_fn, mesh, params_spec=specs)

        def forward():
            x = p['embed'][tokens.long()]
            q, k, v = ((x @ p[n]).reshape(b, t, H, D) for n in ('wq', 'wk', 'wv'))
            x = x + ring_attention(q, k, v, seq, causal=True).reshape(b, t, E) @ p['wo']
            return pipe(stage_leaves, microbatch(x, M)).reshape(x.shape)

    axes = ('data', 'seq', 'expert') if copies > 1 else ('data', 'seq')
    optimizer = torch.optim.Adam(p.values(), lr=1e-2)
    losses, first = [], None
    for _ in range(4):
        share = _nll_sum(forward() @ p['w_out'], labels) / (B * T * copies)
        loss, grads = _step(p, specs, mesh, share, optimizer, axes)
        losses.append(loss)
        first = first or {'loss': loss, 'grads': grads}
    first['adam_losses'] = np.asarray(losses)
    first['coords'] = dict(zip(names, mesh.get_coordinate()))
    return first


def _run_composed_lm(inputs):
    """TensorParallelLM on (data, seq, model) = (2, 2, 2): this rank's loss
    and gradients on its shard of the batch."""
    import torch

    from petastorm_tpu_torch.models.transformer import TransformerLM
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.tensor_parallel import TensorParallelLM, shard_by_spec
    names = ('data', 'seq', 'model')
    mesh = make_mesh(names, (2, 2, 2), device='cpu')
    lm = TransformerLM(vocab=V, embed=E, heads=H, layers=2, max_len=T, dtype=torch.float32,
                       device='cpu')
    lm.load_state_dict({k: torch.from_numpy(v) for k, v in inputs['lm'].items()})
    composed = TensorParallelLM(lm, mesh)
    tokens = shard_by_spec(torch.from_numpy(inputs['tokens']), P('data', 'seq'), mesh)
    share, loss = composed.loss(tokens.contiguous())
    share.backward()
    composed.reduce_gradients()
    return {'loss': float(loss), 'coords': dict(zip(names, mesh.get_coordinate())),
            'grads': {k: p.grad.numpy() for k, p in composed.named_parameters()}}


def _worker(rank, world, store, workdir):
    import torch.distributed as dist

    from petastorm_tpu_torch.graft_entry import dryrun_multichip
    init_world(rank, world, store)
    inputs = unflatten(dict(np.load(os.path.join(workdir, 'inputs.npz'))))
    out = {'dryrun': dryrun_multichip(WORLD, device='cpu', weights=inputs['weights'])}
    out['dryrun']['mesh'] = np.asarray(out['dryrun']['mesh'])
    for phase, names, sizes in SCALE:
        out[phase] = _run_scale(phase, names, sizes, inputs['scale'][phase])
    out['composed_lm'] = _run_composed_lm(inputs['composed_lm'])
    np.savez(os.path.join(workdir, 'rank{}.npz'.format(rank)), **flatten(out))
    dist.destroy_process_group()


# ------------------------------------------------------------------ the JAX side

def _jax_nll(logits, labels):
    import jax
    import jax.numpy as jnp
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return jnp.mean(-jnp.take_along_axis(logp, labels[..., None], axis=-1))


def _value_and_grad(loss_fn, params, *args):
    import jax
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
    return float(loss), jax.tree.map(np.asarray, grads)


def _attended(params, tokens, heads):
    """The JAX scale worker's attention front end with the shared dense
    reference."""
    from petastorm_tpu.ops.ring_attention import dense_attention
    x = params['embed'][tokens]
    b, t, e = x.shape
    q, k, v = ((x @ params[n]).reshape(b, t, heads, e // heads) for n in ('wq', 'wk', 'wv'))
    return x + dense_attention(q, k, v, causal=True).reshape(b, t, e) @ params['wo']


def _jax_weights(n_rows_length):
    """The JAX dry run's flax-initialized weights at n = 8, in the port's
    layout: phase 3's Blocks (keys 10 + i), phase 4's MoETransformerLM (key
    20), phase 6's stages (keys 30 + i); with the flax trees for the
    oracles."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models import MoETransformerLM
    from petastorm_tpu.models.transformer import Block, dense_causal_attention
    from petastorm_tpu_torch import graft_entry as ge
    from petastorm_tpu_torch.convert import (block_state_dicts_from_flax,
                                             moe_state_dict_from_flax)
    length = n_rows_length
    block = Block(heads=ge.H2, attention_fn=dense_causal_attention, dtype=jnp.float32)
    probe = jnp.zeros((2, length, ge.E2), jnp.float32)
    blocks = [jax.tree.map(np.asarray, block.init(jax.random.PRNGKey(10 + i), probe)['params'])
              for i in range(4)]
    stacked = jax.tree.map(lambda *leaves: np.stack(leaves), *blocks)
    moe = MoETransformerLM(vocab=ge.V, embed=ge.EP_EMBED, heads=ge.EP_HEADS, layers=2,
                           num_experts=4, max_len=length, dtype=jnp.float32)
    moe_params = jax.tree.map(np.asarray, moe.init(jax.random.PRNGKey(20),
                                                   jnp.zeros((2, length), jnp.int32))['params'])
    tp = []
    for i in range(2):
        k1, k2 = jax.random.split(jax.random.PRNGKey(30 + i))
        tp.append((np.asarray(jax.random.normal(k1, (ge.TE, ge.TF), jnp.float32) * 0.1),
                   np.asarray(jax.random.normal(k2, (ge.TF, ge.TE), jnp.float32) * 0.1)))
    port = {'pp_dp': {'stages': [{k: v.numpy() for k, v in s.items()}
                                 for s in block_state_dicts_from_flax(stacked)]},
            'ep_dp': {'model': {k: v.numpy() for k, v in moe_state_dict_from_flax(
                {'params': moe_params}).items()}},
            'pp_tp_dp': {'w1': np.stack([w1 for w1, _ in tp]),
                         'w2': np.stack([w2 for _, w2 in tp])}}
    flax = {'blocks': stacked, 'moe': moe_params, 'moe_model': moe}
    return port, flax


def _dryrun_references(weights, flax, record):
    """{phase: (loss, grads in the port's names and layout)} from the JAX
    package on one device, on the global batches the ranks trained on."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models import moe_aux_total, next_token_loss
    from petastorm_tpu.models.transformer import Block, dense_causal_attention
    from petastorm_tpu_torch import graft_entry as ge
    from petastorm_tpu_torch.convert import (block_state_dicts_from_flax,
                                             moe_state_dict_from_flax)
    refs = {}

    phase = record['dp_sp_tp']

    def dp_sp_tp(params, tokens, labels):
        x = _attended(params, tokens, ge.H)
        x = x + jax.nn.relu(x @ params['w1']) @ params['w2']
        return _jax_nll(x @ params['w_out'], labels)
    refs['dp_sp_tp'] = _value_and_grad(dp_sp_tp, weights['dp_sp_tp'], phase['tokens'],
                                       phase['labels'])

    block = Block(heads=ge.H2, attention_fn=dense_causal_attention, dtype=jnp.float32)
    n_stages = len(weights['pp_dp']['stages'])

    def pp_dp(params, tokens, labels):
        y = params['embed'][tokens]
        for i in range(n_stages):
            y = block.apply({'params': jax.tree.map(lambda x: x[i], params['blocks'])}, y)
        return _jax_nll(y @ params['w_out'], labels)
    pp = record['pp_dp']
    loss, grads = _value_and_grad(pp_dp, {'blocks': flax['blocks'],
                                          'embed': weights['pp_dp']['embed'],
                                          'w_out': weights['pp_dp']['w_out']},
                                  pp['tokens'], pp['labels'])
    stage_grads = [{'0.' + k: v.numpy() for k, v in s.items()}
                   for s in block_state_dicts_from_flax(grads['blocks'])]
    refs['pp_dp'] = (loss, {'stages': stage_grads, 'embed': grads['embed'],
                            'w_out': grads['w_out']})

    moe = flax['moe_model']
    ep_tokens = record['ep_dp']['tokens']

    def ep_dp(params):
        logits, mods = moe.apply({'params': params}, ep_tokens, mutable='losses')
        return next_token_loss(logits, ep_tokens) + moe_aux_total(mods, weight=0.01)
    loss, grads = _value_and_grad(ep_dp, flax['moe'])
    refs['ep_dp'] = (loss, {k: v.numpy() for k, v in
                            moe_state_dict_from_flax({'params': grads}).items()})

    def pp_tp_dp(params, tokens, labels):
        y = params['embed'][tokens]
        for i in range(params['w1'].shape[0]):
            y = y + jax.nn.gelu(y @ params['w1'][i]) @ params['w2'][i]
        return _jax_nll(y @ params['w_out'], labels)
    tp = record['pp_tp_dp']
    refs['pp_tp_dp'] = _value_and_grad(pp_tp_dp, weights['pp_tp_dp'], tp['tokens'],
                                       tp['labels'])
    return refs


def _scale_reference(phase, params):
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.moe import _capacity, switch_routing
    from petastorm_tpu.ops.ring_attention import dense_attention
    weights = {k: v for k, v in params.items() if k not in ('tokens', 'labels')}

    def loss(w, tokens, labels):
        if phase == 'wide3':
            x = w['embed'][tokens].reshape(B, T, H, D)
            e = dense_attention(x, x, x, causal=True).reshape(B, T, E)
            y = e + jax.nn.gelu(e @ w['w1']) @ w['w2']
        elif phase == 'compose4':
            y = _attended(w, tokens, H)
            for i in range(w['w1'].shape[0]):
                y = y + jax.nn.gelu(y @ w['w1'][i]) @ w['w2'][i]
        else:
            xs = _attended(w, tokens, H).reshape(M, B // M, T, E)
            t_blk = T // 2                         # seq 2, data 1
            blocks = []
            for m in range(M):
                row = []
                for s in range(2):
                    block = xs[m, :, s * t_blk:(s + 1) * t_blk]
                    for i in range(w['w1'].shape[0]):
                        flat = block.reshape(-1, E)
                        probs = jax.nn.softmax(flat @ w['router'][i], axis=-1)
                        cap = _capacity(flat.shape[0], X, 1, CAP)
                        dispatch, combine, _, _ = switch_routing(probs, cap, 1)
                        h = jax.nn.gelu(jnp.einsum('xcd,xdf->xcf', jnp.einsum(
                            'sxc,sd->xcd', dispatch, flat), w['w1'][i]))
                        out = jnp.einsum('xcf,xfd->xcd', h, w['w2'][i])
                        block = block + jnp.einsum('xcd,sxc->sd', out,
                                                   combine).reshape(block.shape)
                    row.append(block)
                blocks.append(jnp.concatenate(row, axis=1))
            y = jnp.stack(blocks).reshape(B, T, E)
        return _jax_nll(y @ w['w_out'], labels)
    return _value_and_grad(loss, weights, params['tokens'], params['labels'])


def _composed_lm_inputs():
    """flax TransformerLM weights (in the port's layout for the ranks) and a
    batch, with the JAX package's loss and gradients in the port's names."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.transformer import TransformerLM, next_token_loss
    from petastorm_tpu_torch.convert import transformer_state_dict_from_flax
    model = TransformerLM(vocab=V, embed=E, heads=H, layers=2, max_len=T, dtype=jnp.float32)
    tokens = np.random.RandomState(3).randint(0, V, (B, T)).astype(np.int32)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(7), tokens)['params'])
    loss, grads = _value_and_grad(
        lambda p, x: next_token_loss(model.apply({'params': p}, x), x), params, tokens)
    port = {k: v.numpy() for k, v in transformer_state_dict_from_flax({'params': params}).items()}
    want = {'lm.' + k: v.numpy()
            for k, v in transformer_state_dict_from_flax({'params': grads}).items()}
    return {'lm': port, 'tokens': tokens}, loss, want


# ------------------------------------------------------------------ the checks

def _piece(array, spec, coords, sizes):
    """This rank's piece of ``array`` by ``spec`` (numpy ``shard_by_spec``)."""
    for dim, axis in enumerate(spec):
        if axis is not None and sizes[axis] > 1:
            size = array.shape[dim] // sizes[axis]
            array = np.take(array, range(coords[axis] * size, (coords[axis] + 1) * size),
                            axis=dim)
    return array


def _close(got_loss, got_grads, want_loss, want_grads, label):
    assert abs(float(got_loss) - want_loss) < PARITY_TOL, (label, got_loss, want_loss)
    assert sorted(got_grads) == sorted(want_grads), (label, sorted(got_grads))
    for name, want in want_grads.items():
        delta = float(np.max(np.abs(got_grads[name] - want)))
        assert delta < PARITY_TOL and delta <= GRAD_RTOL * float(np.abs(want).max()), (
            label, name, delta, float(np.abs(want).max()))


def _check_batches(d, rows):
    """Each phase's global batch is rows of the store, its tokens beside
    their labels, and this rank holds its piece: the rows of its 'data'
    coordinate and, under P('data', 'seq'), the columns of its 'seq' one, in
    storage that holds nothing else (one copy a field on the CPU)."""
    store = {tuple(t): tuple(l) for t, l in zip(rows['tokens'], rows['labels'])}
    for name, rows_per_rank in (('dp_sp_tp', 2), ('pp_dp', 4), ('ep_dp', 2), ('pp_tp_dp', 4)):
        phase = d[name]
        tokens = phase['tokens']
        data = len(tokens) // rows_per_rank
        assert tokens.shape == (data * rows_per_rank, rows['tokens'].shape[1]), name
        assert all(tuple(t) in store for t in tokens), name
        if 'labels' in phase:
            assert [store[tuple(t)] for t in tokens] == [tuple(l) for l in phase['labels']]
        coords = phase['coords']
        want = tokens[coords['data'] * rows_per_rank:(coords['data'] + 1) * rows_per_rank]
        if 'seq' in coords:
            cols = tokens.shape[1] // 2
            want = want[:, coords['seq'] * cols:(coords['seq'] + 1) * cols]
        np.testing.assert_array_equal(phase['local_tokens'], want, err_msg=name)
        # the loader cut the rows on the host: only the piece was copied
        assert phase['local_storage_bytes'] == want.nbytes, (name, phase['local_storage_bytes'])


def _check_dryrun(ranks, weights, refs, rows):
    from petastorm_tpu_torch.graft_entry import _two_way
    assert all((r['dryrun']['mesh'] == (2, 2, 2)).all() for r in ranks)
    total = 2 * (int(rows['tokens'].sum()) + int(rows['labels'].sum()))
    for r in ranks:
        d = r['dryrun']
        _check_batches(d, rows)
        assert float(d['scan_epochs']['carry']) == total
        combo = d['dp_sp_ep']['losses']
        assert np.isfinite(combo).all() and combo[-1] < combo[0] - 1e-3, combo

        phase = d['dp_sp_tp']
        sizes = {'data': 2, 'seq': 2, 'model': 2}
        loss, grads = refs['dp_sp_tp']
        specs = {'w1': (None, 'model'), 'w2': ('model', None)}
        want = {k: _piece(v, specs.get(k, ()), phase['coords'], sizes) for k, v in grads.items()}
        _close(phase['loss'], phase['grads'], loss, want, 'dp_sp_tp')

        phase = d['pp_dp']
        loss, grads = refs['pp_dp']
        want = dict(grads['stages'][int(phase['coords']['stage'])], embed=grads['embed'],
                    w_out=grads['w_out'])
        _close(phase['loss'], phase['grads'], loss, want, 'pp_dp')

        phase = d['ep_dp']
        loss, grads = refs['ep_dp']
        sizes = {'expert': _two_way(WORLD, four=True)}
        want = {k: _piece(v, ('expert',) if k.endswith(('.w1', '.w2')) else (),
                          phase['coords'], sizes) for k, v in grads.items()}
        _close(phase['loss'], phase['grads'], loss, want, 'ep_dp')

        phase = d['pp_tp_dp']
        loss, grads = refs['pp_tp_dp']
        sizes = {'stage': 2, 'model': 2}
        want = {'w1': _piece(grads['w1'], ('stage', None, 'model'), phase['coords'], sizes)[0],
                'w2': _piece(grads['w2'], ('stage', 'model', None), phase['coords'], sizes)[0],
                'embed': grads['embed'], 'w_out': grads['w_out']}
        _close(phase['loss'], phase['grads'], loss, want, 'pp_tp_dp')


def test_composed_meshes_on_a_gloo_world_of_eight(tmp_path):
    from petastorm_tpu_torch.graft_entry import dryrun_inputs
    dryrun = dryrun_inputs(WORLD)
    length = dryrun['rows']['tokens'].shape[1]
    fed, flax = _jax_weights(length)
    scale = scale_inputs()
    lm_inputs, lm_loss, lm_grads = _composed_lm_inputs()
    ranks = [unflatten(r) for r in run_world(
        os.path.abspath(__file__), tmp_path,
        flatten({'weights': fed, 'scale': scale, 'composed_lm': lm_inputs}), world=WORLD)]

    weights = dryrun['weights']
    for phase, values in fed.items():
        weights[phase] = dict(weights[phase], **values)
    refs = _dryrun_references(weights, flax, ranks[0]['dryrun'])
    for r in ranks[1:]:
        for phase in refs:
            for name in ('tokens', 'labels'):
                if name in r['dryrun'][phase]:
                    np.testing.assert_array_equal(r['dryrun'][phase][name],
                                                  ranks[0]['dryrun'][phase][name])
    _check_dryrun(ranks, weights, refs, dryrun['rows'])

    for phase, names, sizes in SCALE:
        loss, grads = _scale_reference(phase, scale[phase])
        specs = {k: tuple(v) for k, v in _specs(phase).items()}
        dims = dict(zip(names, sizes))
        for r in ranks:
            got = r[phase]
            want = {k: _piece(v, specs.get(k, ()), got['coords'], dims)
                    for k, v in grads.items()}
            _close(got['loss'], got['grads'], loss, want, phase)
            losses = got['adam_losses']
            assert losses[-1] < losses[0] - 1e-3, (phase, losses)

    # TensorParallelLM: each block's MLP over 'model', ring over 'seq'
    cuts = {'mlp_up.weight': ('model', None), 'mlp_up.bias': ('model',),
            'mlp_down.weight': (None, 'model')}
    for r in ranks:
        got = r['composed_lm']
        want = {k: _piece(v, cuts.get(k.split('.', 3)[-1], ()), got['coords'],
                          {'data': 2, 'seq': 2, 'model': 2}) for k, v in lm_grads.items()}
        _close(got['loss'], got['grads'], lm_loss, want, 'composed_lm')


if __name__ == '__main__':
    _worker(*sys.argv[1:])
