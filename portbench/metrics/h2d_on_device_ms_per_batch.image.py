"""h2d_on_device_ms_per_batch.image: the upload's copy on the loader's
stream, timed by CUDA events (the loader's ``h2d_on_device`` span), per
batch it timed. Stream time: the copy and any stretch the stream stood idle
until the producer thread issued it and recorded the end event."""

from portbench.program_spans import span_ms_per_count


def read(record):
    return span_ms_per_count(record, 'h2d_on_device')
