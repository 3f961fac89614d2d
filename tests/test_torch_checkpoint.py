"""TrainingCheckpointer on the CPU: round trip, retention, refusals, the
interval gate, a failed save leaving the previous step whole, the JSON of a
JAX checkpoint's input position resuming a port reader, and a small
TransformerLM trained through make_torch_loader on read-time packed batches
whose interrupted-and-resumed run gives the uninterrupted run's losses bit
for bit."""

import json
import os

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import (TrainingCheckpointer, TransformerLM, make_packing_transform,
                                 make_torch_loader)
from petastorm_tpu_torch.benchmark.lm_data import full_bin_rowgroups, write_ragged_store
from petastorm_tpu_torch.ops.packing import packed_next_token_loss, segment_causal_attention

SEQ = 64
STEPS = 6
SPLIT = 3
LM = dict(vocab=256, embed=64, heads=1, layers=2, max_len=SEQ)


def _model(seed):
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.float32, device='cpu', **LM)
    return model, torch.optim.Adam(model.parameters(), lr=1e-3)


def _train_state(model, optimizer):
    return {'model': model.state_dict(), 'optimizer': optimizer.state_dict()}


def _step(model, optimizer):
    model.train()
    inputs = torch.randint(0, LM['vocab'], (2, SEQ), generator=torch.Generator().manual_seed(0))
    optimizer.zero_grad()
    logits = model(inputs)
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, LM['vocab']),
                                             inputs[:, 1:].reshape(-1).long())
    loss.backward()
    optimizer.step()


def _assert_state_equal(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.device == want.device
        assert torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_state_equal(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_state_equal(g, w)
    else:
        assert got == want


class _Loader(object):
    def __init__(self, state=None, error=None):
        self.calls = 0
        self._state = state or {'version': 1, 'items_per_epoch': 4, 'epochs_consumed': 0,
                                'consumed_by_epoch': {'0': [[1, 0]]}}
        self._error = error

    def state_dict(self):
        self.calls += 1
        if self._error is not None:
            raise self._error
        return self._state


def test_round_trip_restores_model_optimizer_and_position(tmp_path):
    model, optimizer = _model(0)
    _step(model, optimizer)
    saved = _train_state(model, optimizer)
    loader = _Loader()
    with TrainingCheckpointer(tmp_path / 'ckpt') as ckpt:
        assert ckpt.save(1, saved, loader=loader)
        assert sorted(os.listdir(tmp_path / 'ckpt' / '1')) == ['input_pipeline.json',
                                                               'train_state.pt']
        fresh_model, fresh_optimizer = _model(1)
        state, loader_state = ckpt.restore(_train_state(fresh_model, fresh_optimizer),
                                           device='cpu')
    _assert_state_equal(state, saved)
    assert loader_state == {'reader': loader._state}
    fresh_model.load_state_dict(state['model'])
    fresh_optimizer.load_state_dict(state['optimizer'])
    _step(model, optimizer)
    _step(fresh_model, fresh_optimizer)
    _assert_state_equal(_train_state(fresh_model, fresh_optimizer),
                        _train_state(model, optimizer))


def test_restore_without_position_and_of_a_named_step(tmp_path):
    ckpt = TrainingCheckpointer(str(tmp_path), max_to_keep=None)
    for step in (2, 4):
        ckpt.save(step, {'x': torch.full((3,), float(step))})
    state, loader_state = ckpt.restore({'x': torch.zeros(3)}, step=2, device='cpu')
    assert loader_state is None and torch.equal(state['x'], torch.full((3,), 2.0))
    assert ckpt.restore({'x': torch.zeros(3)}, device='cpu')[0]['x'][0] == 4
    with pytest.raises(ValueError, match='No checkpoint of step 3'):
        ckpt.restore({'x': torch.zeros(3)}, step=3, device='cpu')


def test_loader_state_given_directly_is_wrapped(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path)
    position = {'version': 1, 'items_per_epoch': 2, 'epochs_consumed': 0,
                'consumed_by_epoch': {}}
    ckpt.save(1, {}, loader_state=position)
    ckpt.save(2, {}, loader_state={'reader': position})
    for step in (1, 2):
        assert ckpt.restore({}, step=step, device='cpu')[1] == {'reader': position}


def test_retention_keeps_the_newest(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path, max_to_keep=2)
    for step in range(1, 5):
        assert ckpt.save(step, {'step': torch.tensor(step)})
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step == 4
    assert sorted(os.listdir(tmp_path)) == ['3', '4']


def test_restore_of_an_empty_directory_raises(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path / 'empty')
    assert ckpt.latest_step is None and ckpt.all_steps() == []
    with pytest.raises(ValueError, match='No checkpoint found'):
        ckpt.restore({}, device='cpu')


def test_restore_defaults_to_cuda(tmp_path, monkeypatch):
    ckpt = TrainingCheckpointer(tmp_path)
    ckpt.save(1, {'x': torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ckpt.restore({'x': torch.zeros(2)})


def test_loader_and_loader_state_are_mutually_exclusive(tmp_path):
    with pytest.raises(ValueError, match='not both'):
        TrainingCheckpointer(tmp_path).save(1, {}, loader=_Loader(), loader_state={})


def test_interval_gate_is_checked_before_the_loader(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path, save_interval_steps=5)
    loader = _Loader(error=ValueError('rows pending behind a shuffling buffer'))
    assert not ckpt.save(3, {}, loader=loader)
    assert loader.calls == 0 and ckpt.all_steps() == []
    with pytest.raises(ValueError, match='shuffling buffer'):
        ckpt.save(5, {}, loader=loader)
    assert loader.calls == 1 and ckpt.all_steps() == []
    assert ckpt.save(7, {}, force=True)
    assert not ckpt.save(5, {})   # not newer than the latest step


def test_saving_an_existing_step_raises(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path)
    ckpt.save(1, {})
    with pytest.raises(ValueError, match='already exists'):
        ckpt.save(1, {}, force=True)


class _Unsaveable(object):
    def __reduce__(self):
        raise RuntimeError('cannot be saved')


def test_failed_save_leaves_the_previous_step_whole(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path)
    ckpt.save(1, {'x': torch.arange(4)}, loader=_Loader())
    before = {name: open(os.path.join(tmp_path, '1', name), 'rb').read()
              for name in os.listdir(os.path.join(tmp_path, '1'))}
    with pytest.raises(RuntimeError, match='cannot be saved'):
        # torch.save fails part way through the file, after the tensor
        ckpt.save(2, {'x': torch.arange(4), 'bad': _Unsaveable()}, loader=_Loader())
    assert ckpt.all_steps() == [1] and sorted(os.listdir(tmp_path)) == ['1']
    after = {name: open(os.path.join(tmp_path, '1', name), 'rb').read()
             for name in os.listdir(os.path.join(tmp_path, '1'))}
    assert after == before
    state, _ = ckpt.restore({'x': torch.zeros(4, dtype=torch.int64)}, device='cpu')
    assert torch.equal(state['x'], torch.arange(4))


def test_json_check_names_the_offending_key(tmp_path):
    ckpt = TrainingCheckpointer(tmp_path)
    with pytest.raises(TypeError, match="reader/consumed_by_epoch/0"):
        ckpt.save(1, {}, loader_state={'reader': {'consumed_by_epoch': {0: {(1, 0)}}}})
    assert ckpt.all_steps() == []


# ------------------------------------------------- positions across the packages

@pytest.fixture(scope='module')
def ragged_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('ckpt_lm') / 'ragged')
    write_ragged_store(url, full_bin_rowgroups(STEPS, 2, SEQ, 8, 32, LM['vocab'], seed=6),
                       n_files=2)
    return url


def test_jax_checkpoint_position_resumes_the_port_reader(tmp_path, ragged_store):
    import petastorm_tpu
    from petastorm_tpu.parallel.checkpoint import TrainingCheckpointer as JaxCheckpointer
    from petastorm_tpu.parallel.loader import JaxDataLoader
    kwargs = dict(reader_pool_type='dummy', seed=3, shuffle_row_groups=True, num_epochs=1,
                  schema_fields=['doc_id'])
    reader = petastorm_tpu.make_batch_reader(ragged_store, **kwargs)
    loader = JaxDataLoader(reader, batch_size=4, device_put=False, drop_last=False)
    it = iter(loader)
    for _ in range(5):
        next(it)
    with JaxCheckpointer(str(tmp_path / 'jax')) as jax_ckpt:
        jax_ckpt.save(5, {'w': np.zeros(2, np.float32)}, loader=loader, force=True)
        jax_ckpt.wait_until_finished()
        _, loader_state = jax_ckpt.restore({'w': np.zeros(2, np.float32)})
    loader.stop()
    loader.join()
    # the port's checkpointer stores the same JSON under the same key
    ckpt = TrainingCheckpointer(tmp_path / 'port')
    ckpt.save(5, {}, loader_state=loader_state)
    with open(tmp_path / 'port' / '5' / 'input_pipeline.json') as f:
        assert json.load(f) == json.loads(json.dumps(loader_state))
    position = ckpt.restore({}, device='cpu')[1]['reader']

    def remaining(make):
        with make(ragged_store, resume_state=position, **kwargs) as resumed:
            return [int(i) for b in resumed.iter_columnar() for i in b.columns['doc_id']]
    from petastorm_tpu_torch import make_batch_reader
    ours, theirs = remaining(make_batch_reader), remaining(petastorm_tpu.make_batch_reader)
    assert ours == theirs and len(ours) > 0


# --------------------------------------------------------- the small LM resumed

def _packed_loss(model, batch):
    segments = batch['tokens_segments']
    logits = model(batch['tokens'], positions=batch['tokens_positions'],
                   attention_fn=segment_causal_attention(segments, use_flash=True))
    return packed_next_token_loss(logits, batch['tokens'], segments)


def _train(model, optimizer, loader, steps):
    losses, batches = [], []
    it = iter(loader)
    for _ in range(steps):
        batch = next(it)
        optimizer.zero_grad(set_to_none=True)
        loss = _packed_loss(model, batch)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach().clone())
        batches.append({k: v.clone() for k, v in batch.items()})
    return losses, batches, it


def _lm_loader(url, resume_state=None):
    return make_torch_loader(url, batch_size=2, reader_pool_type='dummy', seed=5,
                             shuffle_row_groups=True, num_epochs=1,
                             transform_spec=make_packing_transform('tokens', SEQ),
                             resume_state=resume_state,
                             loader_kwargs={'device': 'cpu', 'shuffling_queue_capacity': 0})


def test_small_lm_interrupted_and_resumed_matches_uninterrupted(tmp_path, ragged_store):
    model, optimizer = _model(11)
    with _lm_loader(ragged_store) as loader:
        want_losses, want_batches, it = _train(model, optimizer, loader, STEPS)
        with pytest.raises(StopIteration):
            next(it)

    model, optimizer = _model(11)
    ckpt = TrainingCheckpointer(tmp_path / 'lm')
    with _lm_loader(ragged_store) as loader:
        first_losses, _, _ = _train(model, optimizer, loader, SPLIT)
        assert ckpt.save(SPLIT, _train_state(model, optimizer), loader=loader)
    del model, optimizer

    model, optimizer = _model(12)   # other weights, overwritten by the restore
    state, loader_state = ckpt.restore(_train_state(model, optimizer), device='cpu')
    model.load_state_dict(state['model'])
    optimizer.load_state_dict(state['optimizer'])
    # every step is one whole rowgroup (two full bins): SPLIT items delivered
    assert len(loader_state['reader']['consumed_by_epoch']['0']) == SPLIT
    with _lm_loader(ragged_store, resume_state=loader_state['reader']) as loader:
        rest_losses, rest_batches, it = _train(model, optimizer, loader, STEPS - SPLIT)
        with pytest.raises(StopIteration):
            next(it)

    for got, want in zip(rest_batches, want_batches[SPLIT:]):
        for name in want:
            assert torch.equal(got[name], want[name]), name
    got_losses = torch.stack(first_losses + rest_losses)
    assert torch.equal(got_losses, torch.stack(want_losses)), (got_losses, want_losses)
    assert torch.isfinite(got_losses).all()
