"""Causal LM pretraining on documents packed at read time: a plain Parquet
store of ragged documents -> ``make_batch_reader`` with
``make_packing_transform`` (first-fit bins in the workers) ->
``TorchDataLoader`` -> the port's ``TransformerLM`` with the packed
positions and ``segment_causal_attention(use_flash=True)`` (the segmented
kernels K2-K4) -> ``packed_next_token_loss`` and the configuration's
optimizer.

The output check holds the first steps' packed batches against the
generated documents (every segment one whole document, numbered from 1 in
order, its positions counting from 0, padding after the last, no document
twice), the first step's logits at positions drawn from the seed, and those
steps' training against :mod:`portbench.reference.gpt2` on batches the
reference packs again from its own documents in the order the program chose.
"""

import numpy as np
import torch

from portbench import flops, traffic, weights
from portbench.reference import gpt2
from portbench.reference.precision import EXACT
from portbench.reference.train import follow
from portbench.tasks import common

FIELDS = ('tokens', 'tokens_segments', 'tokens_positions')


def attending_pairs(segments):
    """Causal (query, key) pairs within the documents of ``[B, T]``
    ``segments``, on their device without a synchronize."""
    b, t = segments.shape
    ids = (segments.long() + (t + 1) * torch.arange(b, device=segments.device)[:, None])
    counts = torch.zeros(b * (t + 1), dtype=torch.int64, device=segments.device)
    counts.scatter_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    counts = counts.view(b, t + 1)[:, 1:]
    return (counts * (counts + 1) // 2).sum()


class Program(object):

    def __init__(self, config, workload, seed, device, cache_root):
        from petastorm_tpu_torch import (TorchDataLoader, TransformerLM, make_batch_reader,
                                         make_packing_transform)
        self.config, self.workload, self.seed = config, workload, seed
        self.run = config['run']
        self.data = traffic.make(workload['data'], seed, cache_root, workload['name'])
        with torch.device(device):
            self.model = TransformerLM(vocab=config['vocab_size'], embed=config['n_embd'],
                                       heads=config['n_head'], layers=config['n_layer'],
                                       max_len=config['n_positions'],
                                       dtype=getattr(torch, self.run['block_dtype']),
                                       device=device)
        weights.load(self.model, self.run['init'], seed)
        self.shapes = {name: tuple(p.shape) for name, p in self.model.named_parameters()}
        self.optimizer = common.make_optimizer(self.model.parameters(), self.run['optimizer'])
        read, load = workload['read'], workload['load']
        self.seq_len = read['pack_len']
        self.reader = make_batch_reader(
            self.data.url, reader_pool_type=read['pool'], workers_count=read['workers'],
            seed=traffic.sub_seed(seed, 'reader'), num_epochs=None,
            transform_spec=make_packing_transform(read['pack_field'], self.seq_len))
        self.batch_size = load['batch_size']
        self.loader = TorchDataLoader(self.reader, batch_size=self.batch_size, device=device)
        self.batches = iter(self.loader)
        self.captured = []
        self.sample = None

    # ------------------------------------------------------------ the timed path

    def step(self, batch, capture=False):
        from petastorm_tpu_torch.ops.packing import (packed_next_token_loss,
                                                     segment_causal_attention)
        tokens, segments, positions = (batch[name] for name in FIELDS)
        logits = self.model(tokens, positions=positions,
                            attention_fn=segment_causal_attention(segments, use_flash=True))
        loss = packed_next_token_loss(logits, tokens, segments)
        if capture:
            rows, cols = self.sample
            self.logit_sample = logits[rows, cols].detach().float().to('cpu')
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def work(self, batch):
        segments = batch['tokens_segments']
        return torch.stack([(segments > 0).sum(), attending_pairs(segments)])

    def totals(self, works):
        real, pairs = (int(x) for x in torch.stack(works).sum(dim=0).tolist())
        c = self.config
        return {'tokens': real, 'slots': len(works) * self.batch_size * self.seq_len,
                'flops': flops.lm_train_flops(real, pairs, c['n_embd'], c['n_layer'],
                                              c['vocab_size'])}

    def trace_fact(self, batch):
        c = self.config
        return {'segments': batch['tokens_segments'].clone(), 'heads': c['n_head'],
                'head_dim': c['n_embd'] // c['n_head'], 'layers': c['n_layer'],
                'elem_bytes': torch.finfo(getattr(torch, self.run['block_dtype'])).bits // 8}

    # ------------------------------------------------------- the first steps' readings

    def capture(self, batch):
        host = {name: batch[name].detach().to('cpu').numpy() for name in FIELDS}
        if not self.captured:
            rows, cols = np.nonzero(host['tokens_segments'] > 0)
            pick = np.random.default_rng([int(self.seed), 5]).choice(
                len(rows), size=min(self.workload['check']['logit_positions'], len(rows)),
                replace=False)
            self.sample = (torch.from_numpy(rows[pick]), torch.from_numpy(cols[pick]))
        self.captured.append(host)

    def first_grad_norms(self):
        return common.first_grad_norms(self.model, self.optimizer, self.run['optimizer'])

    def change_norms(self):
        return common.change_norms(self.model, self.run['init'], self.seed)

    def close(self):
        self.loader.stop()
        self.loader.join()
        self.reader.stop()
        self.reader.join()
        del self.batches, self.loader, self.reader, self.model, self.optimizer

    # ---------------------------------------------------------------- the check

    def batch_checks(self, device, captured=None):
        """``batch_wrong``: bins that are not whole documents of the store
        packed as stated, plus documents delivered twice. Keeps the
        reference's own packing of the same documents for :meth:`follow`
        (unless judging ``captured``, other batches)."""
        index = {doc.tobytes(): i for i, doc in enumerate(self.data.documents)}
        wrong, used = 0, set()
        reference_batches = []
        for batch in (captured or self.captured):
            tokens, segments, positions = (batch[name] for name in FIELDS)
            rebuilt = {name: np.zeros_like(tokens, dtype=np.int64)
                       for name in ('tokens', 'segments', 'positions')}
            for row in range(tokens.shape[0]):
                seg = segments[row]
                offset, ident = 0, 1
                row_ok = True
                while offset < len(seg) and seg[offset] == ident:
                    end = offset + int(np.argmax(seg[offset:] != ident)) \
                        if (seg[offset:] != ident).any() else len(seg)
                    doc = index.get(tokens[row, offset:end].astype(np.int32).tobytes())
                    if (doc is None or doc in used
                            or not np.array_equal(positions[row, offset:end],
                                                  np.arange(end - offset))):
                        row_ok = False
                        break
                    used.add(doc)
                    rebuilt['tokens'][row, offset:end] = self.data.documents[doc]
                    rebuilt['segments'][row, offset:end] = ident
                    rebuilt['positions'][row, offset:end] = np.arange(end - offset)
                    offset, ident = end, ident + 1
                tail = slice(offset, None)
                if not row_ok or ident == 1 or (segments[row, tail] != 0).any() \
                        or (tokens[row, tail] != 0).any() or (positions[row, tail] != 0).any():
                    wrong += 1
            reference_batches.append({name: torch.from_numpy(value).to(device)
                                           for name, value in rebuilt.items()})
        if captured is None:
            self.reference_batches = reference_batches
        return {'batch_wrong': wrong}

    def cfg(self):
        c = self.config
        return {'layers': c['n_layer'], 'heads': c['n_head'],
                'layer_norm_epsilon': self.run['layer_norm_epsilon']}

    def params(self, device):
        return weights.parameters(self.shapes, self.run['init'], self.seed, device)

    def reference_logits(self, device, precision=EXACT):
        """The reference's first-step logits at the sampled positions, from
        the initial weights."""
        rows, cols = (x.to(device) for x in self.sample)
        return gpt2.logits_at(self.params(device), self.reference_batches[0], self.cfg(),
                              rows, cols, precision)

    def follow(self, device, precision=EXACT, rows=None):
        """The reference's readings of the first steps, from the initial
        weights made again from the seed; ``rows`` keeps only those rows of
        each batch (a planted fault)."""
        batches = [dict(batch, rows=rows) if rows is not None else batch
                   for batch in self.reference_batches]
        cfg = self.cfg()
        return follow(lambda p, b: gpt2.loss(p, b, cfg, precision), self.params(device),
                      batches, self.run['optimizer'])

    def judge(self, readings, device):
        checks = self.batch_checks(device)
        with common.exact_float32():
            checks['logit_gap'] = common.logit_gap(self.logit_sample,
                                                   self.reference_logits(device))
            checks.update(common.training_gaps(readings, self.follow(device)))
        return checks
