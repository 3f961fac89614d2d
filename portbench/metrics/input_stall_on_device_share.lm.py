"""input_stall_on_device_share.lm: the training stream's wait for the
loader's stream on the card (the loader's ``input_stall_on_device`` span,
CUDA events) per batch, over the window's mean step interval, in percent."""

from portbench.program_spans import stall_share


def read(record):
    return stall_share(record)
