"""device_idle_share.lm: percent of the profiled steps' range in which the
card ran no kernel, copy or fill."""

from portbench.records import device_idle_share


def read(record):
    return device_idle_share(record)
