"""Single-host service runner: one dispatcher plus N spawned decode workers.
A copy of ``petastorm_tpu.service.fleet`` without ``incidents=`` and
``history=`` (those planes are not in the port yet).

:class:`ServiceFleet` is how the service is started — by the
``petastorm-tpu-torch-throughput serve`` CLI and by the tests: it runs a
:class:`~petastorm_tpu_torch.service.dispatcher.Dispatcher` in-process (a
daemon thread) and spawns each worker as a fresh interpreter running
:mod:`petastorm_tpu_torch.service.service_worker` (spawn, never fork: the
parent may hold a CUDA context, which a forked child cannot use), all sharing
one cache directory. Workers are *elastic*: :meth:`spawn_worker` adds one at
any time (it registers with the live dispatcher), :meth:`kill_worker`
SIGKILLs one (the dispatcher's heartbeat watchdog deregisters it and
re-queues its items).

A multi-host deployment runs the same two entry points by hand: one
``serve --workers 0`` for the dispatcher, and ``service_worker`` processes
pointed at its URL from every decode host."""

from __future__ import annotations

import logging
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from petastorm_tpu_torch.service.dispatcher import (DEFAULT_ADMISSION_WINDOW,
                                                    DEFAULT_CLIENT_TTL_S,
                                                    DEFAULT_MAX_ITEM_ATTEMPTS,
                                                    DEFAULT_QUANTUM,
                                                    DEFAULT_STALE_TIMEOUT_S,
                                                    Dispatcher)
from petastorm_tpu_torch.service.wire import worker_endpoint

logger = logging.getLogger(__name__)

#: how long ``start`` waits for the initial workers to register
_WORKER_STARTUP_TIMEOUT_S = 60


class ServiceFleet(object):
    """Dispatcher + N service-worker processes on this host (module doc).

    ``cache_dir`` (created when missing) is shared by every worker — the
    fleet-wide warm Arrow-IPC rowgroup cache; None disables the shared cache
    and each client's own cache setting applies. ``shm_results`` enables the
    one-shot shared-memory result path for co-located clients. ``autotune``
    (True or an :class:`~petastorm_tpu_torch.autotune.AutotunePolicy`) arms
    the dispatcher's closed-loop admission retuning. ``metrics_port``
    attaches the dispatcher's fleet-wide scrape endpoint (``/metrics``
    aggregating every worker's heartbeat metric snapshots with per-worker
    labels and per-client gauges, ``/healthz``, ``/vars``; ``0`` binds an
    ephemeral port — ``dispatcher.metrics_url`` names it). ``ledger`` (True
    or an explicit journal path) arms the dispatcher's durable token ledger,
    which lets :meth:`crash_dispatcher` restart the dispatcher mid-epoch
    without re-delivering retired work or losing in-flight items."""

    def __init__(self, workers: int = 2, host: str = '127.0.0.1',
                 port: Optional[int] = None,
                 cache_dir: Optional[str] = None,
                 cache_size_limit: Optional[int] = None,
                 shm_results: bool = True,
                 heartbeat_interval_s: float = 0.5,
                 stale_timeout_s: float = DEFAULT_STALE_TIMEOUT_S,
                 admission_window: int = DEFAULT_ADMISSION_WINDOW,
                 quantum: float = DEFAULT_QUANTUM,
                 max_item_attempts: int = DEFAULT_MAX_ITEM_ATTEMPTS,
                 item_deadline_s: Optional[float] = None,
                 client_ttl_s: float = DEFAULT_CLIENT_TTL_S,
                 autotune: Any = None,
                 metrics_port: Optional[int] = None,
                 ledger: Any = None) -> None:
        self._initial_workers = workers
        self._cache_dir = cache_dir
        self._cache_size_limit = cache_size_limit
        self._shm_results = shm_results
        self._heartbeat_interval_s = heartbeat_interval_s
        self._ledger_path = self._resolve_ledger(ledger)
        # the dispatcher's construction arguments, kept so crash_dispatcher
        # can rebuild an identical incarnation on the same port
        self._dispatcher_kwargs: Dict[str, Any] = dict(
            host=host, port=port, admission_window=admission_window,
            quantum=quantum, stale_timeout_s=stale_timeout_s,
            max_item_attempts=max_item_attempts,
            item_deadline_s=item_deadline_s, client_ttl_s=client_ttl_s,
            autotune=autotune, metrics_port=metrics_port,
            ledger=self._ledger_path)
        self.dispatcher = Dispatcher(**self._dispatcher_kwargs)
        self.processes: List[subprocess.Popen] = []
        self._next_worker_id = 0
        self.service_url: Optional[str] = None

    def _resolve_ledger(self, ledger: Any) -> Optional[str]:
        """``None``/``False`` → no ledger; a str → that journal path;
        ``True`` → the fleet cache directory (or a private temp directory
        when the fleet runs cacheless)."""
        if not ledger:
            return None
        if isinstance(ledger, str):
            return ledger
        from petastorm_tpu_torch.service.ledger import default_ledger_path
        home = self._cache_dir or tempfile.mkdtemp(
            prefix='petastorm-tpu-torch-ledger-')
        os.makedirs(home, exist_ok=True)
        return default_ledger_path(home)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> str:
        """Start the dispatcher and the initial workers; blocks until every
        initial worker has registered. Returns the ``service_url``."""
        self.service_url = self.dispatcher.start()
        if self._cache_dir:
            os.makedirs(self._cache_dir, exist_ok=True)
        for _ in range(self._initial_workers):
            self.spawn_worker()
        deadline = time.monotonic() + _WORKER_STARTUP_TIMEOUT_S
        while (self.dispatcher.scheduler.worker_count()
               < self._initial_workers):
            if time.monotonic() > deadline:
                self.stop()
                raise RuntimeError(
                    'only {} of {} service workers registered within {}s'
                    .format(self.dispatcher.scheduler.worker_count(),
                            self._initial_workers,
                            _WORKER_STARTUP_TIMEOUT_S))
            time.sleep(0.05)
        return self.service_url

    def spawn_worker(self) -> subprocess.Popen:
        """Spawn one decode worker (elastic join — works mid-epoch; it
        registers with the dispatcher on its own)."""
        if self.service_url is None:
            raise RuntimeError('start() the fleet before spawning workers')
        worker_id = self._next_worker_id
        self._next_worker_id += 1
        bootstrap: Dict[str, Any] = {
            'worker_id': worker_id,
            'worker_endpoint': worker_endpoint(self.service_url),
            'heartbeat_interval_s': self._heartbeat_interval_s,
            'shm_results': self._shm_results,
            'parent_pid': os.getpid(),
            'cache_dir': self._cache_dir,
            'cache_size_limit': self._cache_size_limit,
        }
        fd, path = tempfile.mkstemp(suffix='.petastorm-tpu-torch-service-worker')
        try:
            with os.fdopen(fd, 'wb') as f:
                pickle.dump(bootstrap, f)
            env = dict(os.environ)
            parent_paths = [p for p in sys.path if p]
            existing = env.get('PYTHONPATH')
            env['PYTHONPATH'] = os.pathsep.join(
                parent_paths + ([existing] if existing else []))
            # after a successful spawn the WORKER owns the bootstrap file
            # (service_worker.main unlinks it right after loading)
            process = subprocess.Popen(
                [sys.executable, '-m',
                 'petastorm_tpu_torch.service.service_worker', path], env=env)
        except Exception:  # noqa: BLE001 - failed spawn: reclaim the bootstrap file, then surface
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        self.processes.append(process)
        return process

    def kill_worker(self, index: int = -1) -> int:
        """SIGKILL one worker process (crash injection); the dispatcher's
        staleness watchdog deregisters it and re-queues its in-flight items.
        Returns the killed pid."""
        process = self.processes[index]
        process.kill()
        process.wait(timeout=10)
        return process.pid

    def crash_dispatcher(self) -> str:
        """Hard-stop the dispatcher WITHOUT the goodbye choreography (no
        ``w_stop`` broadcast, no worker-tail drain — the moral equivalent of
        SIGKILL for the in-process thread) and start a fresh incarnation on
        the same port. With a ledger armed the replacement replays the
        journal, re-adopts the live workers via the ``w_rejoin`` handshake
        and resumes the epoch without re-delivering retired tokens; without
        one it comes up empty and the clients' starvation re-arm recovers
        the in-flight work the slow way. Returns the (unchanged)
        ``service_url``."""
        if self.service_url is None:
            raise RuntimeError('start() the fleet before crashing it')
        # the replacement must bind the SAME client port or nobody finds it:
        # recover the actual bound port for fleets started with port=None
        port = int(self.service_url.rsplit(':', 1)[1])
        self.dispatcher.crash()
        kwargs = dict(self._dispatcher_kwargs)
        kwargs['port'] = port
        self.dispatcher = Dispatcher(**kwargs)
        self.service_url = self.dispatcher.start()
        return self.service_url

    @property
    def ledger_path(self) -> Optional[str]:
        """The durable ledger journal path (None when the ledger is off)."""
        return self._ledger_path

    def state(self) -> Dict[str, Any]:
        """The dispatcher's scheduler snapshot (clients/workers/queues)."""
        return self.dispatcher.state()

    def stop(self) -> None:
        """Stop the dispatcher (it broadcasts ``w_stop``) and reap the
        worker processes — SIGTERM, then SIGKILL, for any worker that missed
        the broadcast (e.g. one spawned moments before stop that never
        finished registering)."""
        self.dispatcher.stop()
        self.dispatcher.join()
        deadline = time.monotonic() + 5
        for process in self.processes:
            while process.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if process.poll() is None:
                logger.info('service worker (pid %d) missed the stop '
                            'broadcast; terminating it', process.pid)
                process.terminate()
                try:
                    process.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    logger.warning('service worker (pid %d) survived '
                                   'SIGTERM; sending SIGKILL', process.pid)
                    process.kill()
                    try:
                        process.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        logger.error('service worker (pid %d) is unreaped '
                                     'after SIGKILL; abandoning it as a '
                                     'zombie', process.pid)
        self.processes = []

    def __enter__(self) -> 'ServiceFleet':
        self.start()
        return self

    def __exit__(self, exc_type: Any, exc_val: Any, exc_tb: Any) -> None:
        self.stop()


def serve(argv: Optional[List[str]] = None) -> int:
    """``petastorm-tpu-torch-throughput serve`` entry: run dispatcher +
    workers in one command until interrupted, printing the service URL and a
    periodic one-line state summary."""
    import argparse
    import json
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-torch-throughput serve',
        description='Run a petastorm_tpu_torch input-service fleet '
                    '(dispatcher + decode workers) on this host')
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8780,
                        help='client port (workers register on port+1; 0 = a free '
                             'pair from the ephemeral range)')
    parser.add_argument('--workers', type=int, default=4,
                        help='decode workers to spawn (0 = dispatcher only; '
                             'point remote service_worker processes at the '
                             'worker endpoint)')
    parser.add_argument('--cache-dir', default=None,
                        help='shared Arrow-IPC rowgroup cache directory '
                             '(warm across every client reading the same '
                             'dataset)')
    parser.add_argument('--cache-size-limit', type=int, default=None,
                        help='shared cache size limit in bytes')
    parser.add_argument('--admission-window', type=int,
                        default=DEFAULT_ADMISSION_WINDOW,
                        help='per-client in-flight window before BUSY')
    parser.add_argument('--item-deadline-s', type=float, default=None,
                        help='per-item wall-clock budget: a worker holding '
                             'one rowgroup longer is deregistered and the '
                             'item re-queued (default: off — catches hung '
                             'decodes that keep heartbeating)')
    parser.add_argument('--autotune', action='store_true',
                        help='arm the closed-loop service autotuner: retunes '
                             'the admission window and live per-client '
                             'in-flight depth from queue-depth/busy signals')
    parser.add_argument('--no-shm', action='store_true',
                        help='disable the co-located shared-memory result '
                             'path (TCP frames only)')
    parser.add_argument('--metrics-port', type=int, default=None,
                        help='serve the fleet-wide Prometheus scrape '
                             'endpoint (/metrics, /healthz, /vars) on this '
                             'port (0 = ephemeral; default: off)')
    parser.add_argument('--ledger', nargs='?', const=True, default=None,
                        metavar='PATH',
                        help='arm the durable dispatcher ledger: journal '
                             'token lifecycle to PATH (bare --ledger uses '
                             'the cache dir) so a restarted dispatcher '
                             'resumes mid-epoch')
    parser.add_argument('--state-interval', type=float, default=30.0,
                        help='seconds between state summaries (0 = quiet)')
    parser.add_argument('--json', action='store_true',
                        help='print state summaries as JSON lines')
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    fleet = ServiceFleet(
        workers=args.workers, host=args.host, port=args.port or None,
        cache_dir=args.cache_dir, cache_size_limit=args.cache_size_limit,
        shm_results=not args.no_shm, admission_window=args.admission_window,
        item_deadline_s=args.item_deadline_s, autotune=args.autotune,
        metrics_port=args.metrics_port, ledger=args.ledger)
    url = fleet.start()
    print('petastorm_tpu_torch input service running at {} ({} worker(s); '
          'workers register on port {}). Point readers at '
          'make_reader(..., service_url={!r}); Ctrl-C stops the fleet.'
          .format(url, args.workers, int(url.rsplit(':', 1)[1]) + 1, url), flush=True)
    if fleet.dispatcher.metrics_url is not None:
        print('fleet metrics: {}/metrics (Prometheus text), /healthz, /vars'
              .format(fleet.dispatcher.metrics_url), flush=True)
    try:
        while True:
            time.sleep(args.state_interval or 3600.0)
            if args.state_interval:
                state = fleet.state()
                if args.json:
                    print(json.dumps(state), flush=True)
                else:
                    print('service: {} worker(s), {} client(s), queue depth '
                          '{}, {} in flight, {} busy rejection(s), {} item(s) '
                          're-queued'.format(
                              len(state['workers']), len(state['clients']),
                              state['queue_depth'], state['in_flight'],
                              state['busy_rejections'],
                              state['items_requeued']), flush=True)
    except KeyboardInterrupt:
        print('stopping the fleet...')
    finally:
        fleet.stop()
    return 0
