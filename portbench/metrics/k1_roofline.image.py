"""k1_roofline.image: K1's least time (the bytes it must move at the memory
rate) over its profiled device time, in percent."""

from portbench.records import stored_copy_roofline


def read(record):
    return stored_copy_roofline(record)
