"""decode_tail_ms_per_batch.image: the loader's ``device_decode`` span (the
decode tail's host planning and issue) summed over the window, per batch."""

from portbench.records import stage_ms_per_batch


def read(record):
    return stage_ms_per_batch(record, 'loader', ('device_decode',))
