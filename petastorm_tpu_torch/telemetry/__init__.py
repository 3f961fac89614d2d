"""Pipeline telemetry: per-stage latency histograms, cross-process span merging,
exportable snapshots, and bottleneck attribution. The port's copy of
``petastorm_tpu.telemetry`` (plain Python; no module here imports torch, since
process-pool workers import the worker side):

- :mod:`~petastorm_tpu_torch.telemetry.registry` — the metric primitives:
  counters, gauges, power-of-two-bucket histograms with lock-free per-thread
  write shards merged on ``snapshot()``, and snapshot-level merge (the
  cross-process primitive).
- :mod:`~petastorm_tpu_torch.telemetry.spans` — stage spans over the data
  plane (``fs_open`` .. ``h2d``); worker-process spans ride each published
  batch's ``telemetry`` sidecar on the results channel and merge into the
  consumer-side registry, so ONE snapshot covers every process.
- :mod:`~petastorm_tpu_torch.telemetry.export` — Prometheus text exposition
  and a periodic JSONL event log (dual-clock ``ts_unix``/``ts_mono`` stamps).
- :mod:`~petastorm_tpu_torch.telemetry.http_exporter` — the scrape endpoint
  (``/metrics``, ``/healthz``, ``/vars``) of ``make_reader(metrics_port=)``
  and ``TorchDataLoader(metrics_port=)``.
- :mod:`~petastorm_tpu_torch.telemetry.slo` — input-efficiency SLOs:
  starvation fraction / goodput-vs-ideal from the recorded wait-stage spans,
  with edge-triggered ``slo_breach`` accounting.
- :mod:`~petastorm_tpu_torch.telemetry.tracing` /
  :mod:`~petastorm_tpu_torch.telemetry.trace_export` — the flight recorder: a
  bounded per-process ring buffer of span/instant events tagged with the
  causal ``(epoch, rowgroup, attempt)`` context, exported as
  Chrome-trace/Perfetto JSON with worker→consumer flow arrows
  (``PETASTORM_TPU_TRACE=1`` / ``make_reader(..., trace=True)`` /
  ``Reader.dump_trace()``; ``python -m
  petastorm_tpu_torch.telemetry.trace_export``).
- :mod:`~petastorm_tpu_torch.telemetry.analyze` — bottleneck attribution: rank
  stages by time share, map the top stage to the knob that moves it
  (``python -m petastorm_tpu_torch.telemetry.analyze``).

Entry points on the pipeline objects: ``Reader.telemetry_snapshot()`` /
``Reader.diagnostics['telemetry']`` and ``TorchDataLoader.telemetry_snapshot()``.
``PETASTORM_TPU_TELEMETRY=0`` disables all instrumentation;
``PETASTORM_TPU_TELEMETRY_JSONL=<path>`` streams periodic snapshots from the
loader. The environment switches are the JAX package's names and arm both
packages; each package keeps its own in-process state.

Left for later: the cost model, lineage, incident, history and sentinel
modules of the JAX package.
"""

from petastorm_tpu_torch.telemetry.registry import (Counter, Gauge,  # noqa: F401
                                                    Histogram, MetricsRegistry,
                                                    merge_snapshots,
                                                    set_telemetry_enabled,
                                                    telemetry_enabled)
from petastorm_tpu_torch.telemetry.spans import (STAGES, TRACE_INSTANTS,  # noqa: F401
                                                 StageRecorder, drain_stage_times,
                                                 record_stage, stage_span)
from petastorm_tpu_torch.telemetry.tracing import (TraceRecorder,  # noqa: F401
                                                   reset_tracing, set_trace_enabled,
                                                   trace_complete, trace_enabled,
                                                   trace_instant, trace_snapshot)
