"""The port's twin of the root ``__graft_entry__.py``.

``entry(device=None)`` gives a forward step on ``MnistCNN`` and its inputs.

``dryrun_multichip(n_devices, device=None)`` trains every parallelism family
of the port over the current ``torch.distributed`` world of ``n_devices``
ranks, each phase fed by the real input pipeline (``write_rows`` writes a
token store, ``make_reader`` reads it, the loaders lay the batch out on a
``DeviceMesh``), in the JAX script's order:

1. dp + sp + tp: one SGD step of a small transformer on a ``('data', 'seq',
   'model')`` mesh, the batch from ``TorchDataLoader(partition_spec=
   P('data', 'seq'))``, ring attention over ``'seq'`` and an MLP cut over
   ``'model'`` (:mod:`~petastorm_tpu_torch.parallel.tensor_parallel`);
2. ``InMemTorchLoader(mesh=).scan_epochs`` over a ``('data',)`` mesh, two
   epochs summing the batches;
3. pp + dp: transformer ``Block`` s pipelined over ``'stage'``
   (``make_pipeline``), the batch over ``'data'``;
4. ep + dp: ``MoETransformerLM(expert_group=, batch_group=)`` on a
   ``('data', 'expert')`` mesh, routing the global batch as the JAX module
   does;
5. dp + sp + ep on one ``('data', 'seq', 'expert')`` mesh: ring attention
   and ``sharded_moe_ffn``, six Adam steps whose loss must fall;
6. pp x tp x dp on one ``('stage', 'data', 'model')`` mesh: a pipeline of
   tensor-parallel MLP stages (``make_pipeline(params_spec=)``).

It runs over a group that its caller started (``torchrun --nproc-per-node N
-m petastorm_tpu_torch.graft_entry [--device cpu]`` starts one from
torchrun's environment); with ``n_devices == 1`` and no group it starts a
one-rank group (gloo on the CPU, NCCL on the card) and destroys it
afterwards. It returns each phase's values and prints the JAX script's OK
line on rank 0.

Defined differences from the JAX script:

- **Head dim 64** in the phases with a ring (1: ``H, D = 4, 64``; 5:
  ``CH, CD = 2, 64``; the JAX script's 8). The ring's blocks are the flash
  kernels, which take head_dim 64 or 128; the CPU runs the same shapes as
  the card.
- **Weights.** The arrays the JAX script draws from ``RandomState(0)`` come
  from it in the same order (:func:`dryrun_inputs`). Where it initializes a
  flax module from a PRNG key (phase 3's Blocks at keys ``10 + i``, phase
  4's LM at 20, phase 6's stages at ``30 + i``), the twin draws the port's
  module (or ``RandomState``) from the same seed. ``weights=`` replaces any
  of them, in the port's layout (``state_dict`` names for modules), so that
  a test can feed the JAX package's.
- **Gradients are explicit.** Each rank's loss is its share of the global
  mean (its partial sum over the global count of tokens, summed over the
  data and sequence ranks for the value);
  :func:`~petastorm_tpu_torch.parallel.tensor_parallel.reduce_gradients`
  sums the gradients over the batch dimensions, as GSPMD does for the JAX
  script. Where the batch is copied over ``'expert'`` (phases 4 and 5) each
  copy's loss is also divided by the expert group's size and the gradients
  of everything but the experts are summed over it. Phase 4's load-balance
  term is global and the same on every rank, so it is divided with the rest
  of the share and the ranks' shares add up to it once.
- **Each rank writes its own copy of the store** in a temporary directory
  and reads it on one worker thread (the JAX script's two), so that the
  ranks of one ``'data'`` coordinate, which read the same rowgroups, get
  them in the same order (and ``scan_epochs``' ranks, which each keep a
  block of the whole store, the same store order).
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

V = 64                    # vocabulary
H, D = 4, 64              # phase 1 heads and head dim (the JAX script: 4, 8)
E2, H2, M = 16, 2, 2      # phase 3: embed, heads, microbatches
EP_EMBED, EP_HEADS = 16, 2
CH, CD = 2, 64            # phase 5 heads and head dim (the JAX script: 2, 8)
TE, TF, TM = 16, 32, 2    # phase 6: embed, MLP hidden (over 'model'), microbatches
COMBO_STEPS = 6


def entry(device=None):
    """``(forward, (model, images))``: ``MnistCNN`` on zeros of ``[8, 28, 28,
    1]`` float32 (NHWC), on the card unless ``device='cpu'``."""
    import torch

    from petastorm_tpu_torch.models.mnist import MnistCNN
    model = MnistCNN(device=device)
    images = torch.zeros((8, 28, 28, 1), dtype=torch.float32,
                         device=model.fc1.weight.device)

    def forward(model, images):
        return model(images)

    return forward, (model, images)


def _mesh_axis_sizes(n_devices):
    """Factor n into (data, seq, model) as the JAX script does, widening the
    non-data axes as the device count grows: model goes 4-way when 16 | n and
    seq goes 4-way when the remainder allows, so mistakes that only show past
    2-way axes (ring ordering, halo arithmetic) surface in the dry run too.
    n=4 -> (1,2,2), n=8 -> (2,2,2), n=16 -> (2,2,4), n=32 -> (2,4,4),
    n=64 -> (4,4,4)."""
    model = 4 if n_devices % 16 == 0 else (2 if n_devices % 2 == 0 else 1)
    rem = n_devices // model
    seq = 4 if rem % 8 == 0 else (2 if rem % 2 == 0 else 1)
    data = rem // seq
    return data, seq, model


def _two_way(n_devices, four=False):
    """The JAX script's split for phases 3-5: 4 (with ``four``) or 2 where n
    divides, else 1."""
    if four and n_devices % 4 == 0:
        return 4
    return 2 if n_devices % 2 == 0 else 1


def dryrun_inputs(n_devices):
    """``{'weights': {phase: {name: array}}, 'rows': {'tokens', 'labels'}}``:
    every numpy array of the dry run at ``n_devices``, drawn as the module
    docstring says."""
    import torch

    from petastorm_tpu_torch.models.moe import MoETransformerLM
    from petastorm_tpu_torch.models.transformer import Block
    data, seq, _ = _mesh_axis_sizes(n_devices)
    batch, length = 2 * data, 8 * seq
    embed = H * D
    rng = np.random.RandomState(0)

    def draw(shape, scale, source=rng):
        return (source.randn(*shape) * scale).astype(np.float32)

    def state(module):
        return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}

    weights = {'dp_sp_tp': {name: draw(shape, 0.02) for name, shape in (
        ('embed', (V, embed)), ('wq', (embed, embed)), ('wk', (embed, embed)),
        ('wv', (embed, embed)), ('wo', (embed, embed)), ('w1', (embed, 4 * embed)),
        ('w2', (4 * embed, embed)), ('w_out', (embed, V)))}}
    # enough rows for every phase's batch at any factorization
    n_rows = max(4 * batch, 2 * n_devices)
    drawn = [(rng.randint(0, V, (length,)), rng.randint(0, V, (length,)))
             for _ in range(n_rows)]
    rows = {'tokens': np.stack([t for t, _ in drawn]).astype(np.int32),
            'labels': np.stack([l for _, l in drawn]).astype(np.int32)}

    stages = [state(Block(E2, H2, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(10 + i)))
              for i in range(_two_way(n_devices, four=True))]
    weights['pp_dp'] = {'stages': stages, 'embed': draw((V, E2), 0.02),
                        'w_out': draw((E2, V), 0.02)}
    experts = max(2, _two_way(n_devices, four=True))
    weights['ep_dp'] = {'model': state(MoETransformerLM(
        vocab=V, embed=EP_EMBED, heads=EP_HEADS, layers=2, num_experts=experts,
        max_len=length, dtype=torch.float32, device='cpu',
        generator=torch.Generator().manual_seed(20)))}
    combo_embed, combo_experts = CH * CD, 2 * _two_way(n_devices)
    weights['dp_sp_ep'] = {
        'embed': draw((V, combo_embed), 0.02),
        'router': draw((combo_embed, combo_experts), 0.1),
        'w1': draw((combo_experts, combo_embed, 2 * combo_embed), 0.1),
        'w2': draw((combo_experts, 2 * combo_embed, combo_embed), 0.1),
        'w_out': draw((combo_embed, V), 0.02)}
    t_stage = _mesh_axis_sizes(n_devices)[2]
    tp_rngs = [np.random.RandomState(30 + i) for i in range(t_stage)]
    tp = [(draw((TE, TF), 0.1, r), draw((TF, TE), 0.1, r)) for r in tp_rngs]
    weights['pp_tp_dp'] = {'w1': np.stack([w1 for w1, _ in tp]),
                           'w2': np.stack([w2 for _, w2 in tp]),
                           'embed': draw((V, TE), 0.02), 'w_out': draw((TE, V), 0.02)}
    return {'weights': weights, 'rows': rows}


# ------------------------------------------------------------------ the phases

def _leaves(arrays, device, mesh=None, specs=None):
    """``{name: leaf}`` on ``device``, each this rank's piece by ``specs``."""
    import torch

    from petastorm_tpu_torch.parallel.tensor_parallel import shard_by_spec
    out = {}
    for name, array in arrays.items():
        x = torch.from_numpy(np.asarray(array))
        if specs and name in specs:
            x = shard_by_spec(x, specs[name], mesh)
        out[name] = x.to(device).clone().requires_grad_()
    return out


def _nll_sum(logits, labels):
    import torch
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long()).sum()


def _step(params, specs, mesh, share, optimizer, axes=('data', 'seq')):
    """``share.backward()``, the gradients summed over ``axes``
    (:func:`~petastorm_tpu_torch.parallel.tensor_parallel.reduce_gradients`),
    one optimizer step: ``(global loss, {name: this rank's gradient})``."""
    from petastorm_tpu_torch.parallel.tensor_parallel import reduce_gradients, sum_over
    optimizer.zero_grad(set_to_none=True)
    share.backward()
    reduce_gradients(params, specs, mesh, axes)
    grads = {name: p.grad.detach().cpu().numpy().copy() for name, p in dict(params).items()
             if p.grad is not None}
    optimizer.step()
    return float(sum_over(share, mesh, axes)), grads


def _local(batch, name):
    return batch[name].to_local().contiguous()


def _record(mesh, batch, loss, grads, names=('tokens', 'labels')):
    """A phase's values: its loss, this rank's gradients, the global batch
    (gathered over the mesh) beside this rank's piece of its tokens and the
    bytes of the storage that piece lies in, and this rank's mesh
    coordinates."""
    record = {'loss': loss, 'grads': grads,
              'local_tokens': _local(batch, 'tokens').cpu().numpy(),
              'local_storage_bytes': batch['tokens'].to_local().untyped_storage().nbytes(),
              'coords': dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
    for name in names:
        record[name] = batch[name].full_tensor().cpu().numpy()
    return record


def phase_dp_sp_tp(mesh, weights, batch):
    """Phase 1: one SGD step of embed -> attention (ring over ``'seq'``) ->
    ReLU MLP (cut over ``'model'``) -> projection on this rank's shard of a
    ``P('data', 'seq')`` batch."""
    import torch

    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.tensor_parallel import (axis_size, copy_to_group,
                                                              reduce_from_group)
    specs = {'w1': P(None, 'model'), 'w2': P('model', None)}
    tokens, labels = _local(batch, 'tokens'), _local(batch, 'labels')
    p = _leaves(weights, tokens.device, mesh, specs)
    model = mesh.get_group('model')
    b, t = tokens.shape
    x = p['embed'][tokens.long()]
    q, k, v = ((x @ p[name]).reshape(b, t, H, -1) for name in ('wq', 'wk', 'wv'))
    attn = ring_attention(q, k, v, mesh.get_group('seq'), causal=True).reshape(b, t, -1)
    x = x + attn @ p['wo']
    h = torch.relu(copy_to_group(x, model) @ p['w1'])
    x = x + reduce_from_group(h @ p['w2'], model)
    share = _nll_sum(x @ p['w_out'], labels) / (b * t * axis_size(mesh, 'data')
                                                  * axis_size(mesh, 'seq'))
    loss, grads = _step(p, specs, mesh, share, torch.optim.SGD(p.values(), lr=1e-2))
    return _record(mesh, batch, loss, grads)


def phase_scan_epochs(mesh, reader, n_devices, device):
    """Phase 2: ``InMemTorchLoader(mesh=).scan_epochs`` for two shuffled
    epochs of global batch ``n_devices``; each step sums its batch, and the
    carry is the sum over the epochs and the ranks."""
    import torch

    from petastorm_tpu_torch.parallel.inmem_loader import InMemTorchLoader
    from petastorm_tpu_torch.parallel.tensor_parallel import sum_over

    def step(batch):
        return batch['tokens'].to_local().sum() + batch['labels'].to_local().sum()

    with InMemTorchLoader(reader, batch_size=n_devices, num_epochs=None, shuffle=True,
                          seed=5, mesh=mesh, drop_last=True, device=device) as inmem:
        sums = inmem.scan_epochs(step, num_epochs=2, state=())
    carry = torch.stack([s.sum() for s in sums]).sum().to(torch.float64)
    return {'carry': float(sum_over(carry, mesh, ('data',)))}


def _pipeline_share(pipe, stage_params, extra, batch, n_micro, global_rows):
    """The JAX script's ``pipeline_lm_loss`` on this rank's rows: embed ->
    pipeline over microbatches -> projection; the partial NLL sum over the
    global token count."""
    from petastorm_tpu_torch.parallel.pipeline import microbatch
    tokens, labels = _local(batch, 'tokens'), _local(batch, 'labels')
    xs = microbatch(extra['embed'][tokens.long()], n_micro)
    logits = pipe(stage_params, xs) @ extra['w_out']
    return _nll_sum(logits, microbatch(labels, n_micro)) / (global_rows * tokens.shape[1])


def phase_pp_dp(mesh, weights, batch):
    """Phase 3: one SGD step of ``Block`` stages (dense causal attention,
    float32) pipelined over ``'stage'``, the batch over ``'data'``."""
    import torch

    from petastorm_tpu_torch.models.transformer import Block, dense_causal_attention
    from petastorm_tpu_torch.parallel.pipeline import blocks_stage_fn, make_pipeline
    device = batch['tokens'].to_local().device
    stage = weights['stages'][mesh.get_local_rank('stage')]
    stage_params = _leaves({'0.' + k: v for k, v in stage.items()}, device)
    extra = _leaves({k: weights[k] for k in ('embed', 'w_out')}, device)
    block = Block(E2, H2, dtype=torch.float32).to(device)
    pipe = make_pipeline(blocks_stage_fn([block], dense_causal_attention), mesh)
    rows = batch['tokens'].shape[0]
    share = _pipeline_share(pipe, stage_params, extra, batch, M, rows)
    params = dict(stage_params, **extra)
    loss, grads = _step(params, {}, mesh, share, torch.optim.SGD(params.values(), lr=1e-2))
    return _record(mesh, batch, loss, grads)


def phase_ep_dp(mesh, weights, batch):
    """Phase 4: one SGD step of ``MoETransformerLM`` with its experts over
    ``'expert'`` (one expert group a data coordinate) and the batch over
    ``'data'`` (the batch group), next-token loss plus 0.01 times the
    load-balance loss of the global batch."""
    import torch

    from petastorm_tpu_torch.models.moe import (MoETransformerLM, expert_partition_specs,
                                                moe_aux_total)
    from petastorm_tpu_torch.models.transformer import next_token_loss
    from petastorm_tpu_torch.parallel.tensor_parallel import axis_size, shard_by_spec
    tokens = _local(batch, 'tokens')
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in weights['model'].items()}
    specs = expert_partition_specs(state)
    experts = state['blocks.0.moe.w1'].shape[0]
    model = MoETransformerLM(vocab=V, embed=EP_EMBED, heads=EP_HEADS, layers=2,
                             num_experts=experts, max_len=tokens.shape[1],
                             dtype=torch.float32, expert_group=mesh['expert'],
                             batch_group=mesh['data'], device=tokens.device)
    model.load_state_dict({k: shard_by_spec(v, specs[k], mesh) for k, v in state.items()})
    logits, losses = model(tokens)
    # this rank's rows' mean and the global aux, over its share of the mean
    # (data) and its copies (expert): the ranks' shares sum to the JAX loss
    ranks = axis_size(mesh, 'data') * axis_size(mesh, 'expert')
    share = (next_token_loss(logits, tokens) + moe_aux_total(losses, weight=0.01)) / ranks
    loss, grads = _step(dict(model.named_parameters()), specs, mesh, share,
                        torch.optim.SGD(model.parameters(), lr=1e-2), ('data', 'expert'))
    return _record(mesh, batch, loss, grads, names=('tokens',))


def phase_dp_sp_ep(mesh, weights, batch, steps=COMBO_STEPS):
    """Phase 5: ``steps`` Adam steps of embed -> ring attention over
    ``'seq'`` -> residual expert FFN with its all-to-all over ``'expert'``
    -> projection; returns the global loss of each step."""
    import torch

    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.sharded_moe import sharded_moe_ffn
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.tensor_parallel import axis_size
    specs = {'w1': P('expert', None, None), 'w2': P('expert', None, None)}
    tokens, labels = _local(batch, 'tokens'), _local(batch, 'labels')
    p = _leaves(weights, tokens.device, mesh, specs)
    optimizer = torch.optim.Adam(p.values(), lr=1e-2)
    b, t = tokens.shape
    embed = CH * CD
    count = b * t * axis_size(mesh, 'data') * axis_size(mesh, 'seq') * axis_size(mesh, 'expert')
    losses = []
    for _ in range(steps):
        x = p['embed'][tokens.long()].reshape(b, t, CH, CD)
        attn = ring_attention(x, x, x, mesh.get_group('seq'), causal=True).reshape(-1, embed)
        y = attn + sharded_moe_ffn(attn, p['router'], p['w1'], p['w2'], mesh['expert'],
                                   capacity_factor=float(p['router'].shape[1] * 2))[0]
        share = _nll_sum(y.reshape(b, t, embed) @ p['w_out'], labels) / count
        losses.append(_step(p, specs, mesh, share, optimizer, ('data', 'seq', 'expert'))[0])
    return {'losses': losses}


def phase_pp_tp_dp(mesh, weights, batch):
    """Phase 6: one SGD step of a pipeline over ``'stage'`` whose stages are
    tensor-parallel MLPs (hidden dimension over ``'model'``), the batch over
    ``'data'``."""
    import torch

    from petastorm_tpu_torch.ops.sharded_moe import gelu
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.pipeline import make_pipeline
    from petastorm_tpu_torch.parallel.tensor_parallel import (copy_to_group,
                                                              reduce_from_group,
                                                              shard_by_spec)
    device = batch['tokens'].to_local().device
    specs = {'w1': P('stage', None, 'model'), 'w2': P('stage', 'model', None)}
    stage_params = _leaves({k: shard_by_spec(torch.from_numpy(weights[k]), specs[k],
                                             mesh)[0].numpy() for k in specs}, device)
    extra = _leaves({k: weights[k] for k in ('embed', 'w_out')}, device)
    model = mesh.get_group('model')

    def stage_fn(p, mb):
        h = gelu(copy_to_group(mb, model) @ p['w1'])
        return mb + reduce_from_group(h @ p['w2'], model)

    pipe = make_pipeline(stage_fn, mesh, params_spec=specs)
    share = _pipeline_share(pipe, stage_params, extra, batch, TM, batch['tokens'].shape[0])
    params = dict(stage_params, **extra)
    loss, grads = _step(params, {}, mesh, share, torch.optim.SGD(params.values(), lr=1e-2))
    return _record(mesh, batch, loss, grads)


# ------------------------------------------------------------------ the dry run

def _first_batch(url, fields, rows, mesh, spec, device):
    """One batch of ``rows`` rows of this rank through ``make_reader``
    (sharded by the mesh's ``'data'`` coordinate) and ``TorchDataLoader``."""
    from petastorm_tpu_torch.parallel.loader import TorchDataLoader
    from petastorm_tpu_torch.parallel.mesh import mesh_shard_info
    from petastorm_tpu_torch.reader import make_reader
    cur_shard, shard_count = mesh_shard_info(mesh, 'data')
    reader = make_reader(url, reader_pool_type='thread', workers_count=1, schema_fields=fields,
                         num_epochs=1, shuffle_row_groups=False, cur_shard=cur_shard,
                         shard_count=shard_count)
    with TorchDataLoader(reader, batch_size=rows, mesh=mesh, partition_spec=spec,
                         drop_last=True, device=device) as loader:
        return next(iter(loader))


def _write_store(url, rows, rows_per_file):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    length = rows['tokens'].shape[1]
    schema = Unischema('DryrunTokens', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (length,), NdarrayCodec(), False),
        UnischemaField('labels', np.int32, (length,), NdarrayCodec(), False),
    ])
    write_rows(url, schema, [{'idx': i, 'tokens': tokens, 'labels': labels}
                             for i, (tokens, labels) in enumerate(zip(rows['tokens'],
                                                                      rows['labels']))],
               rows_per_file=rows_per_file)


def _check(result):
    losses = [result[name]['loss'] for name in ('dp_sp_tp', 'pp_dp', 'ep_dp', 'pp_tp_dp')]
    combo = result['dp_sp_ep']['losses']
    if not np.isfinite(losses + combo + [result['scan_epochs']['carry']]).all():
        raise RuntimeError('non-finite value in the multichip dryrun: losses {}, dp+sp+ep {}, '
                           'carry {}'.format(losses, combo, result['scan_epochs']['carry']))
    if not combo[-1] < combo[0] - 1e-3:
        raise RuntimeError('dp+sp+ep composed training did not decrease the loss over {} '
                           'steps: {}'.format(len(combo), combo))


def _ok_line(result, meshes):
    (data, seq, model), pp, ep, combo, tp = meshes
    return ('dryrun_multichip OK: mesh=({}x{}x{}) data/seq/model, loader-fed batch {}x{} '
            'sharded P(data, seq), loss={:.4f}; mesh scan_epochs carry={:.1f}; pp loss={:.4f} '
            '(stage={}x data={}); ep loss={:.4f} (data={}x expert={}); dp+sp+ep composed mesh '
            '({}x{}x{}) {}-step loss {:.4f}->{:.4f} (decreasing); pp*tp*dp composed mesh '
            '(stage={} data={} model={}) loss={:.4f}'.format(
                data, seq, model, 2 * data, 8 * seq, result['dp_sp_tp']['loss'],
                result['scan_epochs']['carry'], result['pp_dp']['loss'], pp[0], pp[1],
                result['ep_dp']['loss'], ep[0], ep[1], *combo, COMBO_STEPS,
                result['dp_sp_ep']['losses'][0], result['dp_sp_ep']['losses'][-1], *tp,
                result['pp_tp_dp']['loss']))


def _run_phases(n_devices, device, weights, root):
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.reader import make_reader
    inputs = dryrun_inputs(n_devices)
    weights = {phase: dict(values, **(weights or {}).get(phase, {}))
               for phase, values in inputs['weights'].items()}
    data, seq, model = _mesh_axis_sizes(n_devices)
    url = 'file://' + os.path.join(root, 'tokens')
    _write_store(url, inputs['rows'], rows_per_file=4 * data)
    fields = ['tokens', 'labels']
    result = {}

    def mesh_of(names, sizes):
        return make_mesh(names, sizes, device=device)

    mesh = mesh_of(('data', 'seq', 'model'), (data, seq, model))
    batch = _first_batch(url, fields, 2, mesh, P('data', 'seq'), device)
    result['dp_sp_tp'] = phase_dp_sp_tp(mesh, weights['dp_sp_tp'], batch)

    reader = make_reader(url, reader_pool_type='thread', workers_count=1, schema_fields=fields,
                         num_epochs=1, shuffle_row_groups=False)
    result['scan_epochs'] = phase_scan_epochs(mesh_of(('data',), (n_devices,)), reader,
                                              n_devices, device)

    pp = (_two_way(n_devices, four=True), n_devices // _two_way(n_devices, four=True))
    mesh = mesh_of(('stage', 'data'), pp)
    batch = _first_batch(url, fields, 2 * M, mesh, P('data'), device)
    result['pp_dp'] = phase_pp_dp(mesh, weights['pp_dp'], batch)

    ep = (n_devices // _two_way(n_devices, four=True), _two_way(n_devices, four=True))
    mesh = mesh_of(('data', 'expert'), ep)
    batch = _first_batch(url, ['tokens'], 2, mesh, P('data'), device)
    result['ep_dp'] = phase_ep_dp(mesh, weights['ep_dp'], batch)

    c_exp, c_seq = _two_way(n_devices), 2 if n_devices % 4 == 0 else 1
    combo = (n_devices // (c_exp * c_seq), c_seq, c_exp)
    mesh = mesh_of(('data', 'seq', 'expert'), combo)
    batch = _first_batch(url, fields, 2, mesh, P('data', 'seq'), device)
    result['dp_sp_ep'] = phase_dp_sp_ep(mesh, weights['dp_sp_ep'], batch)

    # the JAX script's slots: data -> data, seq -> model, model -> stage
    t_data, t_model, t_stage = _mesh_axis_sizes(n_devices)
    mesh = mesh_of(('stage', 'data', 'model'), (t_stage, t_data, t_model))
    batch = _first_batch(url, fields, 2 * TM, mesh, P('data'), device)
    result['pp_tp_dp'] = phase_pp_tp_dp(mesh, weights['pp_tp_dp'], batch)
    result['mesh'] = (data, seq, model)
    return result, ((data, seq, model), pp, ep, combo, (t_stage, t_data, t_model))


def dryrun_multichip(n_devices, device=None, weights=None):
    """Run the six phases over the current world of ``n_devices`` ranks (see
    the module docstring) and return their values: ``{'mesh', 'dp_sp_tp',
    'scan_epochs', 'pp_dp', 'ep_dp', 'dp_sp_ep', 'pp_tp_dp'}``. A world of
    another size raises ``RuntimeError``, as does a non-finite value or a
    phase-5 loss that does not fall.

    :param device: ``'cuda'`` (default) or ``'cpu'``.
    :param weights: ``{phase: {name: array}}`` replacing those of
        :func:`dryrun_inputs` name by name (the port's layout).
    """
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.loader import resolve_device
    from petastorm_tpu_torch.parallel.mesh import initialize_distributed
    device = resolve_device(device)
    root = tempfile.mkdtemp(prefix='graft_dryrun_')
    started = False
    try:
        if not dist.is_initialized() and n_devices == 1:
            started = initialize_distributed('file://' + os.path.join(root, 'store'),
                                             world_size=1, rank=0, device=device)
        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != n_devices:
            raise RuntimeError('dryrun_multichip({}) needs a torch.distributed world of {} '
                               'ranks (torchrun --nproc-per-node {}); the world has {}'
                               .format(n_devices, n_devices, n_devices, world))
        result, meshes = _run_phases(n_devices, device, weights, root)
        rank = dist.get_rank()
    finally:
        if started:
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    _check(result)
    if rank == 0:
        print(_ok_line(result, meshes))
    return result


def main(argv=None):
    """``python -m petastorm_tpu_torch.graft_entry [--device cpu]``: the dry
    run over ``torchrun`` 's world (its environment starts the group), or
    at one rank without it."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import initialize_distributed
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    started = 'WORLD_SIZE' in os.environ and initialize_distributed(device=args.device)
    try:
        dryrun_multichip(dist.get_world_size() if dist.is_initialized() else 1,
                         device=args.device)
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
