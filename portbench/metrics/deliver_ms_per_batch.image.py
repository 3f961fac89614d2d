"""deliver_ms_per_batch.image: the loader's own host time on the training
thread from the queue's return to the yield (its ``deliver`` span), per
batch it timed."""

from portbench.program_spans import span_ms_per_count


def read(record):
    return span_ms_per_count(record, 'deliver')
