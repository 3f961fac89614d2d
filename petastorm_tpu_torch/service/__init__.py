"""Disaggregated input service: one shared decode fleet serving many readers.
The port of ``petastorm_tpu.service``, after the tf.data-service split
(arXiv 2210.14826, "A Case for Disaggregating ML Input Data Processing"):
decode workers and a warm Arrow-IPC rowgroup cache are amortized across every
job reading the same dataset, and a reader joins with nothing but
``make_reader(..., service_url='tcp://host:port')``.

Three roles:

- :class:`~petastorm_tpu_torch.service.dispatcher.Dispatcher` — the broker: a
  ROUTER front-end for N concurrent reader clients, a ROUTER back-end where
  elastic decode workers register and heartbeat, per-client
  deficit-round-robin fair-share scheduling over rowgroup work items, and
  admission control with a bounded per-client in-flight window (explicit
  BUSY rejection), with an optional durable token ledger
  (:mod:`~petastorm_tpu_torch.service.ledger`);
- :mod:`~petastorm_tpu_torch.service.service_worker` — a stateless decode
  worker process: wraps the port's
  :class:`~petastorm_tpu_torch.reader_worker.RowGroupWorker` decode path,
  serves results over TCP through the
  :mod:`~petastorm_tpu_torch.workers.serializers` wire codec (one-shot
  ``ptt-svc-*`` shared-memory segments when co-located with the client), and
  shares one :class:`~petastorm_tpu_torch.cache.ArrowIpcDiskCache` directory
  with its siblings;
- :class:`~petastorm_tpu_torch.service.service_client.ServicePool` — the
  client transport: the pool interface the port's reader calls, so
  ``on_error`` modes, the quarantine ledger, telemetry sidecars, the device
  decode tail and trace context work unchanged over the network.

:class:`~petastorm_tpu_torch.service.fleet.ServiceFleet` runs dispatcher + N
worker processes on one host (the ``petastorm-tpu-torch-throughput serve``
CLI and the tests). The exports load lazily: importing this package loads
neither zmq nor torch, and the workers load no torch at all.
"""

import importlib

_EXPORTS = {
    'Dispatcher': 'petastorm_tpu_torch.service.dispatcher',
    'FairShareScheduler': 'petastorm_tpu_torch.service.dispatcher',
    'ServiceFleet': 'petastorm_tpu_torch.service.fleet',
    'ServicePool': 'petastorm_tpu_torch.service.service_client',
    'fetch_service_state': 'petastorm_tpu_torch.service.service_client',
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
