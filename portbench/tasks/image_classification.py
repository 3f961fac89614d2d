"""Image classification training on the device-decode path: a petastorm image
store -> ``make_reader(device_decode_fields=...)`` -> ``TorchDataLoader``
with a ``DeviceTransform`` (stored inflate K1 for the embedding, the DCT
decode tail, random crop, flip and normalize for the image) -> the port's
``ResNet`` -> cross-entropy and the configuration's optimizer.

The output check holds the first steps' batches against the store's own
data (every label and embedding exact; every image, decoded again by
:mod:`portbench.reference.dct`, found at some crop and mirror within
``image_gap`` 0-255 steps) and follows those steps with
:mod:`portbench.reference.resnet` on the reference's own decode of the same
rows.
"""

import numpy as np
import torch
import torch.nn.functional as F

from portbench import bounds, flops, traffic, weights
from portbench.reference import dct, resnet
from portbench.reference.precision import EXACT
from portbench.reference.train import follow
from portbench.tasks import common


class Program(object):

    def __init__(self, config, workload, seed, device, cache_root):
        from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
        from petastorm_tpu_torch.models.resnet import ResNet
        self.config, self.workload, self.seed = config, workload, seed
        self.run = config['run']
        self.data = traffic.make(workload['data'], seed, cache_root, workload['name'])
        with torch.device(device):
            self.model = ResNet(stage_sizes=config['stage_sizes'],
                                num_classes=config['num_classes'],
                                num_filters=config['num_filters'],
                                dtype=getattr(torch, self.run['conv_dtype']),
                                device=device).train()
        weights.load(self.model, self.run['init'], seed)
        self.shapes = {name: tuple(p.shape) for name, p in self.model.named_parameters()}
        self.optimizer = common.make_optimizer(self.model.parameters(), self.run['optimizer'])
        read, load = workload['read'], workload['load']
        self.batch_size = load['batch_size']
        self.reader = make_reader(self.data.url, reader_pool_type=read['pool'],
                                  workers_count=read['workers'],
                                  seed=traffic.sub_seed(seed, 'reader'), num_epochs=None,
                                  device_decode_fields=read['device_decode_fields'])
        mean, std = load['normalize']
        transform = DeviceTransform(crop=(load['crop'], load['crop']),
                                    random_flip=load['random_flip'], normalize=(mean, std),
                                    normalize_dtype=load['normalize_dtype'],
                                    seed=traffic.sub_seed(seed, 'augment'))
        self.loader = TorchDataLoader(self.reader, batch_size=self.batch_size, device=device,
                                      device_transforms={'image': transform})
        self.batches = iter(self.loader)
        self.captured = []
        self.flops_per_image = 3 * flops.resnet_forward_flops(
            config['stage_sizes'], config['num_filters'], config['num_classes'], load['crop'])

    # ------------------------------------------------------------ the timed path

    def step(self, batch, capture=False):
        logits = self.model(batch['image'])
        loss = F.cross_entropy(logits, batch['label'])
        if capture:
            self.logit_sample = logits.detach().float().to('cpu')
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def work(self, batch):
        return self.batch_size

    def totals(self, works):
        images = sum(works)
        return {'images': images, 'flops': images * self.flops_per_image}

    def trace_fact(self, batch):
        embed_bytes = 4 * self.workload['data']['embedding_len']
        return {'stored_copy_bytes': bounds.stored_copy_bytes(self.batch_size, embed_bytes,
                                                              self.batch_size)}

    # ------------------------------------------------------- the first steps' readings

    def capture(self, batch):
        self.captured.append({name: batch[name].detach().to('cpu')
                              for name in ('idx', 'label', 'embedding', 'image')})

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
        """``rows_wrong``: delivered rows whose label or embedding is not the
        store's, or that came twice; ``image_gap``: the largest difference,
        in 0-255 steps, between a delivered image and the best crop and
        mirror of the reference's decode. Keeps the reference's inputs for
        :meth:`follow` (unless judging ``captured``, other batches)."""
        mean, std = (torch.tensor(v, dtype=torch.float32, device=device)
                     for v in self.workload['load']['normalize'])
        quality = self.data.quality
        wrong, worst, seen = 0, 0.0, set()
        reference_batches = []
        for batch in (captured or self.captured):
            idx = batch['idx'].numpy()
            labels = self.data.labels[idx]
            wrong += int((batch['label'].numpy() != labels).sum())
            for row, i in enumerate(idx):
                want = self.data.embedding(i)
                wrong += int(batch['embedding'][row].numpy().tobytes() != want.tobytes())
                wrong += int(int(i) in seen)
                seen.add(int(i))
            full = torch.from_numpy(np.stack([dct.decode_blob(self.data.blob(i), quality)
                                              for i in idx])).to(device)
            delivered = (batch['image'].to(device, torch.float32) * std + mean) * 255.0
            gaps, oy, ox, flips = dct.crop_gaps(delivered, full)
            worst = max(worst, float(gaps.max()))
            crop = self.workload['load']['crop']
            rows = torch.arange(crop, device=device)
            images = full[torch.arange(len(idx), device=device)[:, None, None],
                          (oy[:, None] + rows)[:, :, None],
                          torch.where(flips[:, None], ox[:, None] + crop - 1 - rows,
                                      ox[:, None] + rows)[:, None, :]]
            reference_batches.append({
                'images': (images.to(torch.float32) / 255.0 - mean) / std,
                'labels': torch.from_numpy(labels).to(device)})
        if captured is None:
            self.reference_batches = reference_batches
        return {'rows_wrong': wrong, 'image_gap': worst}

    def cfg(self):
        return {'stage_sizes': self.config['stage_sizes'],
                'num_filters': self.config['num_filters'],
                'batch_norm_epsilon': self.config['batch_norm_epsilon']}

    def params(self, device):
        return weights.parameters(self.shapes, self.run['init'], self.seed, device)

    def reference_logits(self, device, precision=EXACT):
        """The reference's logits of the first batch, from the initial weights."""
        with torch.no_grad():
            return resnet.logits(self.params(device), self.reference_batches[0]['images'],
                                 self.cfg(), precision)

    def follow(self, device, precision=EXACT, rows=None):
        """The reference's readings of the first steps, from the initial
        weights made again from the seed; ``rows`` keeps only those rows of
        each batch (a planted fault)."""
        batches = [dict(batch, rows=rows) if rows is not None else batch
                   for batch in self.reference_batches]
        cfg = self.cfg()
        return follow(lambda p, b: resnet.loss(p, b, cfg, precision), self.params(device),
                      batches, self.run['optimizer'])

    def judge(self, readings, device):
        checks = self.batch_checks(device)
        with common.exact_float32():
            checks['logit_gap'] = common.logit_gap(self.logit_sample,
                                                   self.reference_logits(device))
            checks.update(common.training_gaps(readings, self.follow(device)))
        return checks
