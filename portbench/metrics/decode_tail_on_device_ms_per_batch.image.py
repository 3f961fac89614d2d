"""decode_tail_on_device_ms_per_batch.image: the decode tail on the
loader's stream from the end of the copy to its last launch's end, timed by
CUDA events (the loader's ``decode_tail_on_device`` span), per batch it
timed. Stream time: the tail's kernels and any stretch the stream stood idle
while the producer thread issued them."""

from portbench.program_spans import span_ms_per_count


def read(record):
    return span_ms_per_count(record, 'decode_tail_on_device')
