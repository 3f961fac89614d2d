"""The whole-program helper (``parallel/graphs.py``) and the two scan entry
points on the card. The file imports nothing of JAX, so on the machine with
the card it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py

Without a card the ``cuda`` tests skip; the others run the eager programs on
the CPU. On the card a scan's CUDA graph must compute the losses an eager run
of the same batches from the same weights computes: the same kernels run on
the same inputs, so the limit is 1e-5 relative, for float32 work where cuDNN
may pick a convolution algorithm per stream."""

import copy

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.parallel.graphs import WARMUP_STEPS, StepProgram, program_state

GRAPH_RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def test_state_is_required_on_the_card_only():
    assert program_state(None, 'cpu') == ()
    with pytest.raises(ValueError, match='state='):
        program_state(None, 'cuda')
    model = torch.nn.Linear(2, 2)
    assert program_state(model, 'cuda') == (model,)
    assert program_state([model], 'cpu') == (model,)
    with pytest.raises(TypeError, match='modules, optimizers and tensors'):
        StepProgram(lambda batch: None, lambda i: {}, 1, ('model',), 'cpu')


@pytest.mark.parametrize('aux,want', [
    (lambda i: None, None),
    (lambda i: torch.tensor(float(i)), torch.tensor([0., 1., 2.])),
    (lambda i: (torch.tensor(i), torch.tensor([i, -i])),
     (torch.tensor([0, 1, 2]), torch.tensor([[0, 0], [1, -1], [2, -2]]))),
    (lambda i: {'loss': torch.tensor(i)}, {'loss': torch.tensor([0, 1, 2])}),
])
def test_eager_program_stacks_aux_over_steps(aux, want):
    program = StepProgram(lambda batch: aux(batch['i']), lambda i: {'i': i}, 3, (), 'cpu')
    got = program.run()
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert list(got) == ['loss'] and torch.equal(got['loss'], want['loss'])
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        assert torch.equal(got, want)
    assert program.replays == 0   # eager: nothing captured or replayed


def test_eager_program_refuses_other_aux():
    program = StepProgram(lambda batch: 1.5, lambda i: {}, 2, (), 'cpu')
    with pytest.raises(TypeError, match='step_fn must return'):
        program.run()


def _mnist_loader(tmp_path, device, rows=96, batch_size=32):
    from petastorm_tpu_torch import InMemTorchLoader, make_reader
    from petastorm_tpu_torch.benchmark.mnist_data import write_mnist_store
    url = 'file://' + str(tmp_path / 'mnist')
    write_mnist_store(url, rows, n_files=2)
    reader = make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False)
    return InMemTorchLoader(reader, batch_size=batch_size, num_epochs=None, seed=3,
                            device=device)


def _mnist_step(model, optimizer):
    from petastorm_tpu_torch.ops.image import normalize_image

    def step(batch):
        images = normalize_image(batch['image'][..., None], [0.1307], [0.3081], model.dtype)
        loss = torch.nn.functional.cross_entropy(model(images), batch['digit'])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@pytest.mark.cuda
@pytest.mark.parametrize('optimizer', ['sgd_momentum', 'adam_capturable'])
def test_scan_epochs_graph_matches_eager(card, tmp_path, optimizer):
    from petastorm_tpu_torch import MnistCNN

    def make(model):
        if optimizer == 'sgd_momentum':
            return torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        return torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True)

    torch.manual_seed(0)
    model = MnistCNN(dtype=torch.float32, device=card)
    eager_model = copy.deepcopy(model)
    opt, eager_opt = make(model), make(eager_model)
    loader = _mnist_loader(tmp_path, card)
    graph_losses = loader.scan_epochs(_mnist_step(model, opt), num_epochs=2,
                                      state=(model, opt))
    program = loader._scan_cache.programs()[0]
    assert program.replays == 2 and program.capture_s > 0
    eager_step = _mnist_step(eager_model, eager_opt)
    eager = torch.stack([eager_step(batch) for batch, _ in zip(loader, range(2 * 3))])
    got = torch.cat(graph_losses).cpu().numpy()
    np.testing.assert_allclose(got, eager.cpu().numpy(), rtol=GRAPH_RTOL)
    for param, eager_param in zip(model.parameters(), eager_model.parameters()):
        torch.testing.assert_close(param, eager_param, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_capture_failure_is_refused_and_loader_stays_usable(card, tmp_path):
    from petastorm_tpu_torch import MnistCNN
    torch.manual_seed(0)
    model = MnistCNN(dtype=torch.float32, device=card)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    step = _mnist_step(model, opt)
    loader = _mnist_loader(tmp_path, card)

    def syncing_step(batch):
        loss = step(batch)
        float(loss)   # reads back to the host: a capture refuses it
        return loss

    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError, match='could not be captured'):
        loader.scan_epochs(syncing_step, state=(model, opt))
    assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))
    assert len(loader._scan_cache) == 0
    with pytest.raises(ValueError, match='state='):
        loader.scan_epochs(step)
    (losses,) = loader.scan_epochs(step, state=(model, opt))
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert sum(int(b['idx'].numel()) for b, _ in zip(loader, range(3))) == 96


def traced_kernel_calls(run):
    """How often each flash kernel ran on the card during ``run()``, read
    from a profiler trace, which sees a graph replay's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {'fwd': 'flash_fwd_kernel', 'dq': 'flash_bwd_dq_kernel',
             'dkv': 'flash_bwd_dkv_kernel'}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    calls = dict.fromkeys(names, 0)
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:
            for name, key in names.items():
                if key in event.key:
                    calls[name] += event.count
    return calls


@pytest.mark.cuda
def test_scan_stream_counts_flash_launches_per_replay(card, tmp_path):
    """A TransformerLM step with the flash kernels as a CUDA graph: the
    wrappers count only the warm-up's eager launches, a profiler trace of a
    replay shows K2-K4 once per layer and step, and the graph's losses are
    the eager run's on the same batches."""
    from petastorm_tpu_torch import TorchDataLoader, TransformerLM, make_reader
    from petastorm_tpu_torch.benchmark.lm_data import write_token_store
    from petastorm_tpu_torch.models.transformer import next_token_loss
    from petastorm_tpu_torch.ops.flash_attention import flash_attention
    url = 'file://' + str(tmp_path / 'tokens')
    write_token_store(url, rows=16, seq_len=256, n_files=1)
    config = dict(vocab=256, embed=128, heads=2, layers=2, max_len=256, dtype=torch.bfloat16)
    torch.manual_seed(0)
    model = TransformerLM(**config).to(card)
    eager_model = copy.deepcopy(model)

    def make_step(model):
        opt = torch.optim.Adam(model.parameters(), lr=3e-4, capturable=True)

        def step(batch):
            loss = next_token_loss(model(batch['tokens'], attention_fn=lambda q, k, v:
                                         flash_attention(q, k, v, causal=True)),
                                   batch['tokens'])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()
        return step, opt

    step, opt = make_step(model)
    before = dict(flash_attention.launches)
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        loader = TorchDataLoader(reader, batch_size=2, device=card)
        chunks = loader.scan_stream(step, chunk_batches=4, state=(model, opt))
        ((program, _, _),) = loader._scan_stream_programs.programs()
    assert program.replays == len(chunks) == 2
    # the capture records its launches and the replays call no wrapper
    assert {name: n - before[name] for name, n in flash_attention.launches.items()} == \
        dict.fromkeys(before, WARMUP_STEPS * 2)
    after_scan = dict(flash_attention.launches)
    assert traced_kernel_calls(program.run) == dict.fromkeys(before, 2 * 4)
    assert flash_attention.launches == after_scan
    eager_step, _ = make_step(eager_model)
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        eager = [eager_step(batch) for batch in TorchDataLoader(reader, batch_size=2,
                                                                 device=card)]
    np.testing.assert_allclose(torch.cat(chunks).float().cpu().numpy(),
                               torch.stack(eager).float().cpu().numpy(), rtol=GRAPH_RTOL)
