"""step_ms_p95: the 95th percentile of the intervals between consecutive step
ends over every step of the window (linear interpolation between order
statistics)."""

from portbench.harness import quantile


def read(record):
    return quantile(record['window']['intervals_ms'], 0.95)
