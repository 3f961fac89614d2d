"""reader_ms_per_batch.lm: the reader workers' ``rowgroup_read``,
``decode`` and ``transform`` spans summed over the window, per batch
delivered."""

from portbench.records import stage_ms_per_batch


def read(record):
    return stage_ms_per_batch(record, 'reader', ('rowgroup_read', 'decode', 'transform'))
