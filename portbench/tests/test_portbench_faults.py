"""A run at a small size, on the CPU, with the timed path broken underneath:
``correct`` comes out false for each fault the cells can have, and true on
the unbroken path. The control, the reference one precision lower in the
program's place, fails the check too. One chip exchanges nothing, so the
fault of an exchange left out does not arise."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import control, harness
from portbench.reference.precision import Precision
from portbench.tests import tiny

SEED = 2 ** 31 + 101
CELLS = {'image': tiny.image_cell, 'lm': tiny.lm_cell}


def _run(cell, program_class=None):
    return harness.run_cell(cell, SEED, 4.0, 0, device='cpu', program_class=program_class)


def unchanged(base):
    """Every step leaves the weights as they were."""
    class Program(base):
        def __init__(self, *args):
            super().__init__(*args)
            self.optimizer.step = lambda *a, **k: None
    return Program


def half_batch(base):
    """The loss is the mean over the first half of each batch."""
    class Program(base):
        def step(self, batch, capture=False):
            half = self.batch_size // 2
            if 'image' in batch:
                logits = self.model(batch['image'])
                loss = F.cross_entropy(logits[:half], batch['label'][:half])
                sample = logits
            else:
                from petastorm_tpu_torch.ops.packing import (packed_next_token_loss,
                                                             segment_causal_attention)
                tokens, segments = batch['tokens'], batch['tokens_segments']
                logits = self.model(tokens, positions=batch['tokens_positions'],
                                    attention_fn=segment_causal_attention(segments,
                                                                          use_flash=True))
                loss = packed_next_token_loss(logits[:half], tokens[:half], segments[:half])
                sample = logits[self.sample] if capture else None
            if capture:
                self.logit_sample = sample.detach().float()
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            return loss.detach()
    return Program


def altered(base):
    """One pixel of each image, or one token of each bin, changed where the
    loader produced it."""
    class Program(base):
        def __init__(self, *args):
            super().__init__(*args)
            self.batches = (self._alter(batch) for batch in self.batches)

        @staticmethod
        def _alter(batch):
            if 'image' in batch:
                batch['image'][:, 0, 0, 0] += 0.5
            else:
                batch['tokens'][:, 0] = (batch['tokens'][:, 0] + 1) % 7
            return batch
    return Program


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_the_unbroken_path_is_correct(cell):
    result, checks = _run(CELLS[cell]())
    assert result['correct'], checks
    assert result['failed'] == 0 and result['attempted'] >= 1


@pytest.mark.parametrize('fault', [unchanged, half_batch, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_a_broken_path_is_not_correct(cell, fault):
    made = CELLS[cell]()
    result, checks = _run(made, fault(harness.program_class_of(made.config)))
    assert not result['correct'], checks


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_the_control_one_precision_lower_is_not_correct(cell):
    made = CELLS[cell]()
    program = harness.program_class_of(made.config)(made.config, made.workload, SEED, 'cpu',
                                                    harness.data_cache(tiny.REPO))
    readings = harness.first_steps(program)
    program.close()
    program.judge(readings, 'cpu')
    readings = control.fault_readings(program, readings, 'cpu',
                                      Precision(**made.workload['control']))['control']
    limits = made.workload['limits']
    assert any(readings[name] > limit for name, limit in limits.items() if name in readings), \
        readings
    assert np.isfinite(list(readings.values())).all()
