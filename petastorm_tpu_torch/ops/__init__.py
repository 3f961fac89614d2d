"""Decode and augmentation ops, attention and packing, and the CUDA kernel
wrappers."""

from petastorm_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_segmented)
from petastorm_tpu_torch.ops.index_shuffle import random_index_shuffle  # noqa: F401
from petastorm_tpu_torch.ops.packing import (  # noqa: F401
    masked_dense_attention, pack_sequences, packed_next_token_loss, segment_causal_attention,
    segment_mask)
from petastorm_tpu_torch.ops.ring_attention import dense_attention  # noqa: F401
