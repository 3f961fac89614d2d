"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu for NVIDIA Hopper.

Reads the same Parquet stores as ``petastorm_tpu`` (same codecs and metadata)
and feeds PyTorch training on the card: :func:`make_reader` (or
:func:`make_batch_reader` for plain Parquet, with worker-side
:class:`TransformSpec` s such as :func:`make_packing_transform`; or both
through :func:`make_torch_loader`) ->
:class:`TorchDataLoader` (with the device decode tail and its CUDA kernels,
and ``scan_stream`` for whole chunks of steps as CUDA graphs) or
:class:`InMemTorchLoader` (the dataset resident on the card, whole epochs as
CUDA graphs through ``scan_epochs``) -> models such as :class:`MnistCNN`,
:class:`~petastorm_tpu_torch.models.resnet.ResNet` or
:class:`~petastorm_tpu_torch.models.transformer.TransformerLM` with the
flash-attention kernels (:func:`flash_attention`). Readers and loaders
checkpoint their read position (``state_dict``, ``resume_state=``), and
:class:`TrainingCheckpointer` saves it with the model and optimizer as one
unit. The readers' row-space features are the JAX package's: predicates
(:mod:`~petastorm_tpu_torch.predicates`), rowgroup indexes and selectors
(:mod:`~petastorm_tpu_torch.etl.rowgroup_indexing`,
:mod:`~petastorm_tpu_torch.selectors`), :class:`NGram` windows, the
local-disk rowgroup cache (:mod:`~petastorm_tpu_torch.cache`) and weighted
mixing (:class:`WeightedSamplingReader`). Entry points run on CUDA unless the
caller passes ``device='cpu'``.
"""

import importlib

#: public name -> the module that defines it, imported on first access (PEP 562):
#: importing a submodule such as ``petastorm_tpu_torch.reader`` or a spawned
#: process-pool worker then loads no torch
_EXPORTS = {
    'DeviceTransform': 'petastorm_tpu_torch.parallel.device_stage',
    'InMemTorchLoader': 'petastorm_tpu_torch.parallel.inmem_loader',
    'MnistCNN': 'petastorm_tpu_torch.models.mnist',
    'NGram': 'petastorm_tpu_torch.ngram',
    'Reader': 'petastorm_tpu_torch.reader',
    'TorchDataLoader': 'petastorm_tpu_torch.parallel.loader',
    'TrainingCheckpointer': 'petastorm_tpu_torch.parallel.checkpoint',
    'TransformSpec': 'petastorm_tpu_torch.transform',
    'TransformerLM': 'petastorm_tpu_torch.models.transformer',
    'Unischema': 'petastorm_tpu_torch.unischema',
    'UnischemaField': 'petastorm_tpu_torch.unischema',
    'WeightedSamplingReader': 'petastorm_tpu_torch.weighted_sampling_reader',
    'flash_attention': 'petastorm_tpu_torch.ops.flash_attention',
    'flash_attention_segmented': 'petastorm_tpu_torch.ops.flash_attention',
    'make_batch_reader': 'petastorm_tpu_torch.reader',
    'make_packing_transform': 'petastorm_tpu_torch.ops.packing',
    'make_reader': 'petastorm_tpu_torch.reader',
    'make_torch_loader': 'petastorm_tpu_torch.parallel.loader',
    'pack_sequences': 'petastorm_tpu_torch.ops.packing',
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
