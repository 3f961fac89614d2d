"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu for NVIDIA Hopper.

Reads the same Parquet stores as ``petastorm_tpu`` (same codecs and metadata)
and feeds PyTorch training on the card: :func:`make_reader` ->
:class:`TorchDataLoader` (with the device decode tail and its CUDA kernels,
and ``scan_stream`` for whole chunks of steps as CUDA graphs) or
:class:`InMemTorchLoader` (the dataset resident on the card, whole epochs as
CUDA graphs through ``scan_epochs``) -> models such as :class:`MnistCNN`,
:class:`~petastorm_tpu_torch.models.resnet.ResNet` or
:class:`~petastorm_tpu_torch.models.transformer.TransformerLM` with the
flash-attention kernels (:func:`flash_attention`). Entry points run on CUDA
unless the caller passes ``device='cpu'``.
"""

from petastorm_tpu_torch.models.mnist import MnistCNN
from petastorm_tpu_torch.models.transformer import TransformerLM
from petastorm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_segmented
from petastorm_tpu_torch.ops.packing import pack_sequences
from petastorm_tpu_torch.parallel.device_stage import DeviceTransform
from petastorm_tpu_torch.parallel.inmem_loader import InMemTorchLoader
from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.reader import Reader, make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['DeviceTransform', 'InMemTorchLoader', 'MnistCNN', 'Reader', 'TorchDataLoader',
           'TransformerLM', 'Unischema', 'UnischemaField', 'flash_attention',
           'flash_attention_segmented', 'make_reader', 'pack_sequences']
