"""An in-memory table -> torch training in three lines with
``petastorm_tpu_torch``: ``make_converter`` writes a ``pyarrow.Table`` to a
cached Parquet store once, then ``make_torch_loader`` hands out
``TorchDataLoader`` s over it. The twin of
``examples/converter/jax_converter_example.py`` (an Arrow table in place of
its pandas frame: the port needs no pandas).

Run: ``python -m examples.converter.torch_converter_example``
"""

import argparse
import os
import tempfile

import numpy as np


def make_table(rows=1024, seed=0):
    """Eight float32 features and a noisy linear target; also the true
    weights."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    features = rng.normal(size=(rows, 8)).astype(np.float32)
    true_w = rng.normal(size=(8,)).astype(np.float32)
    target = features @ true_w + 0.01 * rng.normal(size=rows).astype(np.float32)
    columns = {'f{}'.format(i): features[:, i] for i in range(8)}
    columns['y'] = target.astype(np.float32)
    return pa.table(columns), true_w


def run(cache_dir=None, rows=1024, steps=30, batch_size=128, device=None):
    """Linear regression by SGD on ``steps`` loader batches; returns the final
    loss."""
    import torch

    from petastorm_tpu_torch.converter import make_converter
    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)
    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(), 'converter_cache_torch')
    table, true_w = make_table(rows)
    converter = make_converter(table, parent_cache_dir_url='file://{}'.format(cache_dir))
    print('materialized {} rows'.format(len(converter)))
    w = torch.zeros(8, device=device, requires_grad=True)
    optimizer = torch.optim.SGD([w], lr=0.1)
    loss = None
    try:
        with converter.make_torch_loader(batch_size=batch_size, num_epochs=None,
                                         loader_kwargs={'device': device}) as loader:
            for step, batch in enumerate(loader):
                if step >= steps:
                    break
                x = torch.stack([batch['f{}'.format(i)] for i in range(8)], dim=1)
                loss = torch.mean((x @ w - batch['y']) ** 2)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                loss = loss.detach()
    finally:
        converter.delete()
    error = float(torch.linalg.norm(w.detach().cpu() - torch.from_numpy(true_w)))
    print('final loss {:.5f}; w error {:.4f}'.format(float(loss), error))
    return float(loss)


def main(argv=None):
    """Run the example; returns the final loss."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cache-dir', default=None)
    parser.add_argument('--rows', type=int, default=1024)
    parser.add_argument('--steps', type=int, default=30)
    parser.add_argument('--batch-size', type=int, default=128)
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    return run(args.cache_dir, rows=args.rows, steps=args.steps,
               batch_size=args.batch_size, device=args.device)


if __name__ == '__main__':
    main()
