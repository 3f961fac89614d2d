"""The plain references against the port at small sizes on the CPU. The tests
may import the port; the references themselves import nothing of it."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import traffic, weights
from portbench.reference import dct, gpt2, resnet
from portbench.tests.tiny import REPO


def _config(name):
    with open(os.path.join(REPO, 'portbench', 'configs', name + '.json')) as f:
        return json.load(f)


def test_dct_blob_reads_back_through_the_port_codec():
    from petastorm_tpu_torch.codecs import DctImageCodec
    from petastorm_tpu_torch.unischema import UnischemaField
    rng = np.random.default_rng(3)
    image = traffic.synthetic_photo(rng, 64, 16, 4.0)
    blob = dct.encode_blob(image, 90)
    field = UnischemaField('image', np.uint8, (64, 64, 3), DctImageCodec(quality=90), False)
    port = DctImageCodec(quality=90).decode(field, blob)
    ours = dct.decode_blob(blob, 90)
    assert port.shape == ours.shape == (64, 64, 3)
    assert np.abs(port.astype(int) - ours.astype(int)).max() <= 1
    assert np.abs(ours.astype(int) - image.astype(int)).mean() < 3


def test_crop_gaps_finds_each_crop_and_mirror():
    rng = np.random.default_rng(4)
    full = torch.from_numpy(np.stack([traffic.synthetic_photo(rng, 32, 8, 8.0)
                                      for _ in range(3)]))
    crops = torch.stack([full[0, 3:27, 5:29], full[1, 0:24, 8:32].flip(1),
                         full[2, 8:32, 0:24]]).float()
    gaps, oy, ox, flips = dct.crop_gaps(crops, full)
    assert gaps.max() == 0
    assert oy.tolist() == [3, 0, 8] and ox.tolist() == [5, 8, 0]
    assert flips.tolist() == [False, True, False]


def test_stored_embedding_decodes_through_the_port_codec():
    from petastorm_tpu_torch.codecs import CompressedNdarrayCodec
    from petastorm_tpu_torch.unischema import UnischemaField
    value = np.random.default_rng(5).standard_normal(16, dtype=np.float32)
    blob = traffic.stored_npz(value)
    field = UnischemaField('e', np.float32, (16,), CompressedNdarrayCodec(stored=True), False)
    assert CompressedNdarrayCodec().decode(field, blob).tobytes() == value.tobytes()


def test_documents_follow_the_seed():
    spec = {'total_tokens': 5000, 'vocab': 100, 'median': 40, 'sigma': 1.0, 'min': 8,
            'max': 128, 'docs_per_rowgroup': 16}
    a = traffic.DocumentStore(spec, 2 ** 31 + 5, '/nonexistent', 'x').documents
    b = traffic.DocumentStore(spec, 2 ** 31 + 5, '/nonexistent', 'x').documents
    c = traffic.DocumentStore(spec, 2 ** 31 + 6, '/nonexistent', 'x').documents
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    assert not all(len(x) == len(y) and np.array_equal(x, y) for x, y in zip(a, c))
    lengths = np.array([len(d) for d in a])
    assert lengths.min() >= 8 and lengths.max() <= 128
    assert 5000 <= lengths.sum() < 5000 + 128


@pytest.mark.parametrize('stages', [[1, 1, 1, 1], [2, 1]])
def test_resnet_reference_equals_the_port_in_float32(stages):
    from petastorm_tpu_torch.models.resnet import ResNet
    rules = _config('resnet50-imagenet')['run']['init']
    rules = [r for r in rules if r['init'] != 'zeros' or 'bn3' not in r['match']]
    model = ResNet(stage_sizes=stages, num_classes=10, num_filters=8, dtype=torch.float32,
                   device='cpu').train()
    weights.load(model, rules, 9)
    images = torch.randn(6, 40, 40, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.tensor([0, 3, 9, 1, 1, 5])
    F.cross_entropy(model(images), labels).backward()
    params = weights.parameters({n: tuple(p.shape) for n, p in model.named_parameters()},
                                rules, 9, 'cpu')
    for leaf in params.values():
        leaf.requires_grad_(True)
    cfg = {'stage_sizes': stages, 'num_filters': 8, 'batch_norm_epsilon': 1e-5}
    resnet.loss(params, {'images': images, 'labels': labels}, cfg).backward()
    for name, leaf in model.named_parameters():
        torch.testing.assert_close(params[name].grad, leaf.grad, rtol=2e-4, atol=2e-5)


def test_gpt2_reference_equals_the_port_on_a_packed_batch():
    from petastorm_tpu_torch import TransformerLM
    from petastorm_tpu_torch.ops.packing import (pack_sequences, packed_next_token_loss,
                                                 segment_causal_attention)
    rules = _config('gpt2-medium')['run']['init']
    model = TransformerLM(vocab=64, embed=128, heads=2, layers=2, max_len=32,
                          dtype=torch.float32, device='cpu')
    weights.load(model, rules, 4)
    rng = np.random.default_rng(2)
    docs = [rng.integers(0, 64, n).astype(np.int32) for n in (5, 17, 9, 30, 3, 12)]
    packed = {k: torch.from_numpy(v).long() for k, v in pack_sequences(docs, 32).items()}
    logits = model(packed['tokens'], positions=packed['positions'],
                   attention_fn=segment_causal_attention(packed['segments']))
    packed_next_token_loss(logits, packed['tokens'], packed['segments']).backward()
    params = weights.parameters({n: tuple(p.shape) for n, p in model.named_parameters()},
                                rules, 4, 'cpu')
    for leaf in params.values():
        leaf.requires_grad_(True)
    cfg = {'layers': 2, 'heads': 2, 'layer_norm_epsilon': 1e-6}
    batch = {'tokens': packed['tokens'], 'segments': packed['segments'],
             'positions': packed['positions']}
    gpt2.loss(params, batch, cfg).backward()
    real = packed['segments'] > 0
    rows, cols = torch.nonzero(real, as_tuple=True)
    torch.testing.assert_close(gpt2.logits_at(params, batch, cfg, rows, cols),
                               logits[real].detach(), rtol=1e-4, atol=1e-4)
    for name, leaf in model.named_parameters():
        torch.testing.assert_close(params[name].grad, leaf.grad, rtol=1e-3, atol=1e-5)


def test_weights_are_drawn_again_alike_and_by_rule():
    rules = _config('gpt2-medium')['run']['init']
    shapes = {'tok_embed.weight': (50, 16), 'blocks.0.qkv.weight': (48, 16),
              'blocks.0.norm_attn.weight': (16,), 'head.bias': (50,)}
    a = weights.parameters(shapes, rules, 2 ** 40 + 1, 'cpu')
    b = weights.parameters(shapes, rules, 2 ** 40 + 1, 'cpu')
    assert all(torch.equal(a[n], b[n]) for n in shapes)
    assert torch.equal(a['blocks.0.norm_attn.weight'], torch.ones(16))
    assert torch.equal(a['head.bias'], torch.zeros(50))
    assert a['tok_embed.weight'].std().item() == pytest.approx(16 ** -0.5, rel=0.2)
    assert a['blocks.0.qkv.weight'].std().item() == pytest.approx(16 ** -0.5, rel=0.2)
