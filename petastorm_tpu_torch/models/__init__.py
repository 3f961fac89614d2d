"""Models that consume the loader's batches."""

from petastorm_tpu_torch.models.mnist import MnistCNN  # noqa: F401
from petastorm_tpu_torch.models.moe import (  # noqa: F401
    MoETransformerLM, moe_aux_total, moe_drop_fractions)
from petastorm_tpu_torch.models.resnet import ResNet, ResNet50  # noqa: F401
from petastorm_tpu_torch.models.transformer import (  # noqa: F401
    TransformerLM, next_token_loss)
