"""input_wait_share.image: the loader's ``wait_time_s`` over its
``total_time_s`` across the window, in percent."""

from portbench.records import input_wait_share


def read(record):
    return input_wait_share(record)
