"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu for NVIDIA Hopper.

Reads the same Parquet stores as ``petastorm_tpu`` (same codecs and metadata)
and feeds PyTorch training on the card: :func:`make_reader` ->
:class:`TorchDataLoader` (with the device decode tail and its CUDA kernels) ->
models such as :class:`~petastorm_tpu_torch.models.resnet.ResNet`. Entry points
run on CUDA unless the caller passes ``device='cpu'``.
"""

from petastorm_tpu_torch.parallel.device_stage import DeviceTransform
from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.reader import Reader, make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ['DeviceTransform', 'Reader', 'TorchDataLoader', 'Unischema', 'UnischemaField',
           'make_reader']
