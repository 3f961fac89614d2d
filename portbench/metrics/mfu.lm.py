"""mfu.lm: the window's model FLOPs (dense and head per real token, attention
per attending pair within documents, x 3) over its span and the card's dense
bf16 peak, in percent."""

from portbench.records import model_flops_share


def read(record):
    return model_flops_share(record)
