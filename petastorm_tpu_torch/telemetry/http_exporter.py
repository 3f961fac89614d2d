"""Live metrics plane: a stdlib HTTP scrape endpoint over telemetry snapshots.
A copy of ``petastorm_tpu.telemetry.http_exporter``.

The SAME snapshots the reader and loader hand out are scrapeable while the
pipeline runs, with zero new dependencies — ``http.server`` only:

- ``GET /metrics`` — Prometheus text exposition
  (:func:`~petastorm_tpu_torch.telemetry.export.to_prometheus_text` over the
  live ``snapshot_fn()``), plus the optional per-label block
  (:func:`~petastorm_tpu_torch.telemetry.export.to_prometheus_text_labeled`)
  and any extra pre-rendered exposition text (``extra_text_fn`` — the
  dispatcher's per-client/per-worker state gauges ride here);
- ``GET /healthz`` — one small JSON liveness document (``health_fn()`` merged
  over ``{"status": "ok"}``);
- ``GET /vars`` — the raw JSON snapshot (the debug view: exactly what the
  Prometheus rendering was derived from).

Attach points: ``make_reader(..., metrics_port=0)`` /
``TorchDataLoader(..., metrics_port=0)`` serve their own pipeline snapshot;
``Dispatcher(metrics_port=...)`` / ``serve --metrics-port`` serve the
FLEET-wide merge of every worker's heartbeat metric snapshots. Port 0 binds an ephemeral port — ``start()`` returns the bound one and
``url`` names the scrape target. The endpoint binds ``127.0.0.1``.

The server runs on one daemon thread (``ThreadingHTTPServer``, so a slow
scraper cannot wedge ``/healthz``); a ``snapshot_fn`` that raises turns into
a 500 response, never into a dead endpoint or a broken pipeline — the scrape
plane observes the data plane, it must not be able to take it down. The
owner's ``stop()`` stops it.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from petastorm_tpu_torch.telemetry.export import (METRIC_PREFIX, escape_label_value,
                                                  to_prometheus_text,
                                                  to_prometheus_text_labeled)

logger = logging.getLogger(__name__)

#: the content type Prometheus scrapers expect for the text exposition
PROMETHEUS_CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

SnapshotFn = Callable[[], Dict[str, Any]]
LabeledFn = Callable[[], Dict[str, Dict[str, Any]]]
TextFn = Callable[[], str]


class _MetricsRequestHandler(BaseHTTPRequestHandler):
    """Routes ``/metrics`` / ``/healthz`` / ``/vars`` against the owning
    :class:`MetricsHttpServer` (stored on the HTTP server instance)."""

    #: silence the default stderr access log — scrapes are periodic
    def log_message(self, format: str, *args: Any) -> None:
        pass

    def do_GET(self) -> None:
        """Serve one scrape; handler errors answer 500, never propagate."""
        owner: 'MetricsHttpServer' = self.server.owner  # type: ignore[attr-defined]
        path = self.path.split('?', 1)[0]
        try:
            if path == '/metrics':
                body = owner.render_metrics().encode('utf-8')
                content_type = PROMETHEUS_CONTENT_TYPE
            elif path == '/healthz':
                body = json.dumps(owner.render_health()).encode('utf-8')
                content_type = 'application/json'
            elif path == '/vars':
                body = json.dumps(owner.render_vars()).encode('utf-8')
                content_type = 'application/json'
            else:
                self.send_error(404, 'unknown path (serving /metrics, '
                                     '/healthz, /vars)')
                return
        except Exception:  # noqa: BLE001 - a broken snapshot_fn must answer 500, not kill the serving thread
            logger.exception('metrics endpoint: snapshot rendering failed')
            self.send_error(500, 'snapshot rendering failed')
            return
        self.send_response(200)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _ReusableThreadingHTTPServer(ThreadingHTTPServer):
    """The scrape listener with ``SO_REUSEADDR`` pinned on: a reader that
    restarts onto the same fixed ``metrics_port`` within the previous
    socket's TIME_WAIT must bind, not crash the new pipeline. (Ephemeral
    ``port=0`` binds never collide — ``start()`` returns the kernel's pick
    and ``url`` names it.)"""

    allow_reuse_address = True


class MetricsHttpServer(object):
    """One scrape endpoint over live telemetry callables (module docstring).

    ``snapshot_fn`` returns the registry snapshot rendered at each scrape
    (evaluated fresh per request — attach the SLO-refresh side effects
    there). ``labeled_fn`` (optional) returns ``{label_value: snapshot}``
    rendered as a per-``label`` exposition block under
    ``prefix + '_' + label`` (e.g. ``petastorm_tpu_worker_decode_*`` series
    carrying ``{worker="3"}``) — aggregate and per-member series use
    DISTINCT metric namespaces so PromQL ``sum()`` over the labeled family
    never double-counts the aggregate. ``extra_text_fn`` appends
    pre-rendered exposition text (the dispatcher's state gauges);
    ``health_fn`` extends the ``/healthz`` document."""

    def __init__(self, snapshot_fn: SnapshotFn, port: int = 0,
                 host: str = '127.0.0.1',
                 health_fn: Optional[SnapshotFn] = None,
                 labeled_fn: Optional[LabeledFn] = None,
                 label: str = 'worker',
                 extra_text_fn: Optional[TextFn] = None,
                 prefix: str = METRIC_PREFIX) -> None:
        self._snapshot_fn = snapshot_fn
        self._prefix = prefix
        self._labeled_fn = labeled_fn
        self._label = label
        self._extra_text_fn = extra_text_fn
        self._requested_port = int(port)
        self._host = host
        self._health_fn = health_fn
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        """Bind and start serving on a daemon thread; returns the bound port
        (the requested one, or the ephemeral pick for port 0)."""
        if self._server is not None:
            return self.port
        server = _ReusableThreadingHTTPServer(
            (self._host, self._requested_port), _MetricsRequestHandler)
        server.daemon_threads = True
        server.owner = self  # type: ignore[attr-defined]
        self._server = server
        self._thread = threading.Thread(target=server.serve_forever,
                                        daemon=True,
                                        name='petastorm-tpu-torch-metrics-http')
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        """The bound port (0 until :meth:`start`)."""
        if self._server is None:
            return 0
        return int(self._server.server_address[1])

    @property
    def url(self) -> str:
        """The scrape base URL, e.g. ``http://127.0.0.1:9400``."""
        return 'http://{}:{}'.format(self._host, self.port)

    def stop(self) -> None:
        """Stop serving and release the socket (idempotent)."""
        server = self._server
        if server is None:
            return
        self._server = None
        server.shutdown()
        server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------ rendering

    def render_metrics(self) -> str:
        """The full ``/metrics`` body: aggregate exposition + optional
        per-label block + optional extra pre-rendered text."""
        text = to_prometheus_text(self._snapshot_fn(), prefix=self._prefix)
        if self._labeled_fn is not None:
            labeled = self._labeled_fn()
            if labeled:
                text += to_prometheus_text_labeled(
                    labeled, self._label,
                    prefix='{}_{}'.format(self._prefix, self._label))
        if self._extra_text_fn is not None:
            text += self._extra_text_fn()
        return text

    def render_health(self) -> Dict[str, Any]:
        """The ``/healthz`` document: ``{"status": "ok"}`` merged with the
        owner's ``health_fn`` fields."""
        doc: Dict[str, Any] = {'status': 'ok'}
        if self._health_fn is not None:
            doc.update(self._health_fn())
        return doc

    def render_vars(self) -> Dict[str, Any]:
        """The ``/vars`` document: the raw aggregate snapshot plus the
        per-label snapshots when a ``labeled_fn`` is attached."""
        doc: Dict[str, Any] = {'snapshot': self._snapshot_fn()}
        if self._labeled_fn is not None:
            doc['labeled'] = {self._label: self._labeled_fn()}
        return doc

    def __enter__(self) -> 'MetricsHttpServer':
        self.start()
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        self.stop()


def service_state_text(state: Dict[str, Any], prefix: str = METRIC_PREFIX) -> str:
    """Render a dispatcher ``state`` snapshot as per-client / per-worker
    labeled gauge series: queue depth, in-flight and served counts per
    ``{client="<name>"}``, assigned items and heartbeat age per
    ``{worker="<id>"}`` — the scheduling-plane half of the fleet scrape
    surface (the decode-plane half is the workers' heartbeat metric
    snapshots)."""
    lines = []

    def gauge(metric: str, label: str, key: str, value: float) -> None:
        name = '{}_{}'.format(prefix, metric)
        if not any(line.startswith('# TYPE {} '.format(name))
                   for line in lines):
            lines.append('# HELP {} petastorm_tpu service state gauge '
                         '(docs/service.md)'.format(name))
            lines.append('# TYPE {} gauge'.format(name))
        lines.append('{}{{{}="{}"}} {}'.format(
            name, label, escape_label_value(key),
            int(value) if float(value).is_integer() else value))

    for client in state.get('clients') or []:
        key = str(client.get('name', ''))
        gauge('service_client_queued', 'client', key,
              float(client.get('queued', 0)))
        gauge('service_client_in_flight', 'client', key,
              float(client.get('in_flight', 0)))
        gauge('service_client_served', 'client', key,
              float(client.get('served', 0)))
        gauge('service_client_window_size', 'client', key,
              float(client.get('window', 0)))
    for worker in state.get('workers') or []:
        key = str(worker.get('worker_id', ''))
        gauge('service_worker_assigned', 'worker', key,
              float(worker.get('assigned', 0)))
        gauge('service_worker_heartbeat_age_seconds', 'worker', key,
              float(worker.get('heartbeat_age_s', 0.0)))
    return '\n'.join(lines) + '\n' if lines else ''
