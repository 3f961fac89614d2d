"""The benchmark's cells cut to a size a CPU test run holds: every width,
depth, batch and store shrunk, the paths and the checks unchanged. The
ResNet runs its convolutions and its delivered images in float32 here: at
this size a bfloat16 ResNet's gradients differ from float32 by tenths, so
only float32 leaves room to tell a sound run from a fault. The limits are
this size's own, set between the readings of sound runs and of the faults
(see ``test_portbench_faults.py``)."""

import json
import os

from portbench import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load(*parts):
    with open(os.path.join(REPO, 'portbench', *parts)) as f:
        return json.load(f)


def image_cell():
    config = _load('configs', 'resnet50-imagenet.json')
    config.update(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)
    config['run']['conv_dtype'] = 'float32'
    workload = _load('workloads', 'resnet50-dct-b128.json')
    workload['data'].update(rows=96, distinct_images=16, image_hw=64, classes=10,
                            embedding_len=64, rowgroup_mb=1, files=2)
    workload['read']['workers'] = 2
    workload['load'].update(batch_size=16, crop=56, normalize_dtype='float32')
    workload['limits'] = {'rows_wrong': 0, 'image_gap': 8.0, 'logit_gap': 0.01,
                          'loss_gap': 0.001, 'grad_gap': 0.01, 'change_gap': 0.1}
    return harness.Cell(REPO, 'resnet50-dct-b128', config=config, workload=workload)


def lm_cell():
    config = _load('configs', 'gpt2-medium.json')
    config.update(vocab_size=512, n_positions=128, n_embd=128, n_head=2, n_layer=2)
    workload = _load('workloads', 'gpt2m-packed-1k.json')
    workload['data'].update(total_tokens=20000, vocab=512, median=40, min=8, max=128,
                            docs_per_rowgroup=32)
    workload['read'].update(workers=2, pack_len=128)
    workload['load'].update(batch_size=4)
    workload['check']['logit_positions'] = 16
    workload['limits'] = {'batch_wrong': 0, 'logit_gap': 0.15, 'loss_gap': 0.0005,
                          'grad_gap': 0.007, 'change_gap': 0.05}
    return harness.Cell(REPO, 'gpt2m-packed-1k', config=config, workload=workload)


