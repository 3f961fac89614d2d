"""Live metrics plane: a stdlib HTTP scrape endpoint over telemetry snapshots.
A copy of ``petastorm_tpu.telemetry.http_exporter`` without the input
service's fleet blocks (per-worker labels and dispatcher state gauges wait
with the service).

The SAME snapshots the reader and loader hand out are scrapeable while the
pipeline runs, with zero new dependencies — ``http.server`` only:

- ``GET /metrics`` — Prometheus text exposition
  (:func:`~petastorm_tpu_torch.telemetry.export.to_prometheus_text` over the
  live ``snapshot_fn()``);
- ``GET /healthz`` — one small JSON liveness document (``health_fn()`` merged
  over ``{"status": "ok"}``);
- ``GET /vars`` — the raw JSON snapshot (the debug view: exactly what the
  Prometheus rendering was derived from).

Attach points: ``make_reader(..., metrics_port=0)`` /
``TorchDataLoader(..., metrics_port=0)`` serve their own pipeline snapshot.
Port 0 binds an ephemeral port — ``start()`` returns the bound one and
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

from petastorm_tpu_torch.telemetry.export import to_prometheus_text

logger = logging.getLogger(__name__)

#: the content type Prometheus scrapers expect for the text exposition
PROMETHEUS_CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

SnapshotFn = Callable[[], Dict[str, Any]]


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
    there); ``health_fn`` extends the ``/healthz`` document."""

    def __init__(self, snapshot_fn: SnapshotFn, port: int = 0,
                 host: str = '127.0.0.1',
                 health_fn: Optional[SnapshotFn] = None) -> None:
        self._snapshot_fn = snapshot_fn
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
        """The ``/metrics`` body."""
        return to_prometheus_text(self._snapshot_fn())

    def render_health(self) -> Dict[str, Any]:
        """The ``/healthz`` document: ``{"status": "ok"}`` merged with the
        owner's ``health_fn`` fields."""
        doc: Dict[str, Any] = {'status': 'ok'}
        if self._health_fn is not None:
            doc.update(self._health_fn())
        return doc

    def render_vars(self) -> Dict[str, Any]:
        """The ``/vars`` document: the raw snapshot."""
        return {'snapshot': self._snapshot_fn()}

    def __enter__(self) -> 'MetricsHttpServer':
        self.start()
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        self.stop()

