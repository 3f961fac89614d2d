"""flash_roofline.lm: K2, K3 and K4's least times on the profiled batches'
attending pairs, summed, over their profiled device times summed, in
percent."""

from portbench.records import flash_roofline


def read(record):
    return flash_roofline(record)
