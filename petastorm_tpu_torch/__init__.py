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
flash-attention kernels (:func:`flash_attention`), or the expert-routed
:class:`MoETransformerLM` (its losses collected by :func:`moe_aux_total`). Readers and loaders
checkpoint their read position (``state_dict``, ``resume_state=``), and
:class:`TrainingCheckpointer` saves it with the model and optimizer as one
unit. The readers' row-space features are the JAX package's: predicates
(:mod:`~petastorm_tpu_torch.predicates`), rowgroup indexes and selectors
(:mod:`~petastorm_tpu_torch.etl.rowgroup_indexing`,
:mod:`~petastorm_tpu_torch.selectors`), :class:`NGram` windows, the
local-disk rowgroup cache (:mod:`~petastorm_tpu_torch.cache`) and weighted
mixing (:class:`WeightedSamplingReader`). Expert and sequence parallelism run
over ``torch.distributed`` groups named by
:func:`~petastorm_tpu_torch.parallel.mesh.make_mesh`
(:mod:`~petastorm_tpu_torch.ops.sharded_moe`,
:mod:`~petastorm_tpu_torch.ops.ring_attention`), pipeline parallelism over
its ``'stage'`` dimension (:func:`make_pipeline`), and both loaders take a
``mesh`` and yield ``DTensor`` batches laid out by a :class:`PartitionSpec`
(:func:`batch_sharding`; :func:`initialize_distributed` starts the group).
Entry points run on CUDA unless the caller passes ``device='cpu'``.
"""

import importlib

#: public name -> the module that defines it, imported on first access (PEP 562):
#: importing a submodule such as ``petastorm_tpu_torch.reader`` or a spawned
#: process-pool worker then loads no torch
_EXPORTS = {
    'DeviceTransform': 'petastorm_tpu_torch.parallel.device_stage',
    'InMemTorchLoader': 'petastorm_tpu_torch.parallel.inmem_loader',
    'MnistCNN': 'petastorm_tpu_torch.models.mnist',
    'MoETransformerLM': 'petastorm_tpu_torch.models.moe',
    'NGram': 'petastorm_tpu_torch.ngram',
    'PartitionSpec': 'petastorm_tpu_torch.parallel.mesh',
    'Reader': 'petastorm_tpu_torch.reader',
    'TorchDataLoader': 'petastorm_tpu_torch.parallel.loader',
    'TrainingCheckpointer': 'petastorm_tpu_torch.parallel.checkpoint',
    'TransformSpec': 'petastorm_tpu_torch.transform',
    'TransformerLM': 'petastorm_tpu_torch.models.transformer',
    'Unischema': 'petastorm_tpu_torch.unischema',
    'UnischemaField': 'petastorm_tpu_torch.unischema',
    'WeightedSamplingReader': 'petastorm_tpu_torch.weighted_sampling_reader',
    'batch_sharding': 'petastorm_tpu_torch.parallel.mesh',
    'flash_attention': 'petastorm_tpu_torch.ops.flash_attention',
    'flash_attention_segmented': 'petastorm_tpu_torch.ops.flash_attention',
    'initialize_distributed': 'petastorm_tpu_torch.parallel.mesh',
    'make_batch_reader': 'petastorm_tpu_torch.reader',
    'make_mesh': 'petastorm_tpu_torch.parallel.mesh',
    'make_packing_transform': 'petastorm_tpu_torch.ops.packing',
    'make_pipeline': 'petastorm_tpu_torch.parallel.pipeline',
    'make_reader': 'petastorm_tpu_torch.reader',
    'make_torch_loader': 'petastorm_tpu_torch.parallel.loader',
    'microbatch': 'petastorm_tpu_torch.parallel.pipeline',
    'moe_aux_total': 'petastorm_tpu_torch.models.moe',
    'moe_drop_fractions': 'petastorm_tpu_torch.models.moe',
    'pack_sequences': 'petastorm_tpu_torch.ops.packing',
    'stack_stage_params': 'petastorm_tpu_torch.parallel.pipeline',
    'stage_partition_specs': 'petastorm_tpu_torch.parallel.pipeline',
    'unstack_stage_params': 'petastorm_tpu_torch.parallel.pipeline',
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
