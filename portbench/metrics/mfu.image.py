"""mfu.image: the window's model FLOPs (3 x the forward's convolutions and
head an image) over its span and the card's dense bf16 peak, in percent."""

from portbench.records import model_flops_share


def read(record):
    return model_flops_share(record)
