"""On the card: each cell runs through the command of ``BENCHMARK.json`` and
its first steps prove correct. Run there with
``python -m pytest portbench/tests -m cuda``; skips without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests.tiny import REPO


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the CUDA kernels have no CPU mode')


def _cells():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return [cell['name'] for cell in json.load(f)['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', _cells())
def test_a_short_run_of_the_cell_is_correct(card, cell):
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', cell,
                          '--seed', str(2 ** 31 + 77), '--seconds', '3', '--trace', '0'],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu' and result['device']['count'] == 1
    assert list(result)[-1] == 'checks'
