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

from petastorm_tpu_torch.models.mnist import MnistCNN
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.models.transformer import TransformerLM
from petastorm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_segmented
from petastorm_tpu_torch.ops.packing import make_packing_transform, pack_sequences
from petastorm_tpu_torch.parallel.checkpoint import TrainingCheckpointer
from petastorm_tpu_torch.parallel.device_stage import DeviceTransform
from petastorm_tpu_torch.parallel.inmem_loader import InMemTorchLoader
from petastorm_tpu_torch.parallel.loader import TorchDataLoader, make_torch_loader
from petastorm_tpu_torch.reader import Reader, make_batch_reader, make_reader
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader

__all__ = ['DeviceTransform', 'InMemTorchLoader', 'MnistCNN', 'NGram', 'Reader',
           'TorchDataLoader', 'TrainingCheckpointer', 'TransformSpec', 'TransformerLM',
           'Unischema', 'UnischemaField', 'WeightedSamplingReader', 'flash_attention',
           'flash_attention_segmented', 'make_batch_reader', 'make_packing_transform',
           'make_reader', 'make_torch_loader', 'pack_sequences']
