"""pipecheck configuration of the port: which files play which role in each
invariant (the port of ``petastorm_tpu.analysis.config``).

The rule *mechanisms* (set matching over produced/consumed wire literals,
catalog membership, clock/lock/exception discipline — ``analysis/rules/``)
are generic; this module pins them to the petastorm_tpu_torch data plane:
which basenames are the pipe and ZMQ protocol peers, which modules must
never read the wall clock directly, where the telemetry catalog and the mypy
ratchet manifest live. Matching is by **basename / path suffix**, not import path, so fixture
trees (``tests/data/pipecheck/``) and mutated copies under a temp dir
exercise exactly the shipped configuration.

Override points (CLI flags map onto these): ``mypy_ini_path`` /
``manifest_path`` for the ratchet rule; everything else via
:func:`dataclasses.replace` from test code.

The tables are the JAX package's, with these defined differences:

- ``PROTOCOL_PEER_FILES``: the process pool's pair speaks ``str`` kinds in
  tuples over ``multiprocessing.connection`` pipes, not ZMQ bytes frames;
  the protocol rule reads both kinds of literal for that pair;
- ``LEAKABLE_TYPES`` adds the pool's pipe ``Connection``: the zmq
  ``Context``/``socket`` rows match only the input service here;
- ``JOURNAL_REGISTRIES``' ``import_name`` column names this package's
  journal modules;
- the mypy ratchet is scoped to the analyzed package
  (``rules/ratchet.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

#: files forming the process pool's peer set: every message kind one of
#: them produces must be dispatched on by one of them, and vice versa
#: (docs/static-analysis.md, protocol-conformance); their kinds travel as
#: ``str`` in tuples over pipes (``rules/protocol.py``)
PROTOCOL_PEER_FILES: Tuple[str, ...] = ('process_pool.py',
                                        'process_worker_main.py')

#: the disaggregated input service's peer set (docs/service.md): dispatcher,
#: service worker and client transport speak their own kind literals over
#: TCP — an independent group, set-matched exactly like the in-process pair
SERVICE_PEER_FILES: Tuple[str, ...] = ('dispatcher.py', 'service_worker.py',
                                       'service_client.py')

#: basenames whose ``to_bytes``/``from_bytes`` JSON descriptor key sets must
#: match (shm slot descriptors; service registration/shm-result descriptors)
DESCRIPTOR_FILES: Tuple[str, ...] = ('shm_ring.py', 'wire.py')

#: modules under the injectable-clock discipline: direct ``time.time()`` /
#: ``time.monotonic()`` / ``time.perf_counter()`` calls are findings — retry,
#: backoff, deadline and breaker arithmetic must flow through the injected
#: ``clock``/``sleep`` callables so tests stay deterministic.
#: ``cost_schedule.py`` is here for a sharper reason: the cost-aware
#: schedule must be a pure function of (ledger, policy, seed) —
#: a wall-clock read anywhere in it would make epoch order irreproducible
#: (docs/performance.md "Cost-aware scheduling").
#: the storage ingest engine joins the discipline: hedge-deadline and
#: fetch-duration arithmetic must flow through the injected ``clock`` so
#: the hedging tests stay deterministic (docs/performance.md "Object-store
#: ingest engine")
CLOCK_DISCIPLINED_FILES: Tuple[str, ...] = ('resilience.py',
                                            'cost_schedule.py',
                                            'range_planner.py',
                                            'fetcher.py',
                                            'metadata_cache.py',
                                            'engine.py')

#: directory name marking worker/data-plane process code, where the
#: exception-hygiene bar is highest: a broad except that can swallow needs an
#: explicit reason comment even when it logs
WORKER_DIR: str = 'workers'

#: basenames of data-path modules where ``raise Exception(...)`` /
#: ``raise BaseException(...)`` are findings (use the errors.py taxonomy)
DATAPATH_FILES: Tuple[str, ...] = ('reader_worker.py', 'reader.py',
                                   'cache.py', 'fs_utils.py',
                                   'resilience.py', 'cost_schedule.py',
                                   'range_planner.py', 'fetcher.py',
                                   'metadata_cache.py', 'engine.py')

#: where the telemetry stage/counter catalog lives (path suffix); the rule
#: falls back to the installed ``petastorm_tpu_torch.telemetry.spans`` when the
#: analyzed tree does not contain it
STAGE_CATALOG_SUFFIX: str = 'telemetry/spans.py'

#: where the declared quarantine-reason registry lives (path suffix)
QUARANTINE_REGISTRY_SUFFIX: str = 'resilience.py'

#: where the durable dispatcher ledger's declared record-kind registry
#: lives (path suffix): every ``append_record('x')`` / ``_journal('x')``
#: call site and every ``kind == 'x'`` replay compare must name a kind in
#: its ``LEDGER_RECORD_KINDS`` tuple (protocol-conformance rule,
#: docs/service.md "Failure modes")
LEDGER_FILE_SUFFIX: str = 'ledger.py'

#: where the topology membership journal's declared record-kind registry
#: lives (path suffix): the same two-sided conformance contract as the
#: dispatcher ledger, against ``TOPOLOGY_RECORD_KINDS`` (protocol-
#: conformance rule, docs/robustness.md "Elastic pod-scale sharding")
TOPOLOGY_FILE_SUFFIX: str = 'topology.py'

#: where the cost profiler's declared stage tuple lives (path suffix); its
#: ``COST_STAGES`` entries must be a subset of the spans catalog's ``STAGES``
#: (telemetry-names rule, docs/observability.md "Cost profiler")
COST_MODEL_SUFFIX: str = 'telemetry/cost_model.py'

#: where the autotuner's knob-id catalog lives (path suffix); ``Knob(...)``
#: constructions and ``catalog.knob(...)`` references are checked against its
#: ``KNOB_IDS`` tuple (telemetry-names rule, docs/autotuning.md)
KNOB_CATALOG_SUFFIX: str = 'autotune/knobs.py'

#: mypy option names a ratchet entry's section must set to True
STRICT_FLAGS: Tuple[str, ...] = ('disallow_untyped_defs',
                                 'disallow_incomplete_defs',
                                 'no_implicit_optional',
                                 'warn_return_any')

#: leakable resource table for the resource-lifecycle rule. Each row is
#: ``(constructor, release_methods, releaser_funcs, exempt_kwargs, label,
#: paths_sensitive)``: a call whose terminal name equals ``constructor``
#: acquires the resource; a call of one of ``release_methods`` on the
#: binding (or passing the binding to a function named in
#: ``releaser_funcs``) releases it; a truthy keyword from ``exempt_kwargs``
#: at the construction site waives tracking (``Thread(daemon=True)`` dies
#: with the process); ``paths_sensitive`` rows must ALSO release on
#: exception paths (finally / ``with``), the ``/dev/shm`` leak class.
#: The pseudo-constructors ``mkstemp:fd`` / ``mkstemp:path`` describe the
#: two halves of ``fd, path = tempfile.mkstemp(...)``.
LEAKABLE_TYPES: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...],
                            Tuple[str, ...], str, bool], ...] = (
    ('SharedMemory', ('close', 'unlink'), (), (),
     'shared-memory segment', True),
    ('TemporaryDirectory', ('cleanup',), (), (),
     'temporary directory', True),
    ('Thread', ('join',), (), ('daemon',), 'thread', False),
    ('Context', ('term', 'destroy'), (), (), 'zmq context', True),
    ('Connection', ('close',), (), (), 'pipe connection', True),
    ('socket', ('close',), (), (), 'socket', True),
    ('TokenLedger', ('close',), (), (), 'token ledger', False),
    ('MembershipJournal', ('close', 'abandon'), (), (),
     'membership journal', False),
    ('ShmRing', ('close', 'close_and_unlink', 'unlink'), (), (),
     'shm ring', False),
    ('mkstemp:fd', (), ('fdopen', 'close'), (),
     'mkstemp file descriptor', True),
    ('mkstemp:path', (), ('replace', 'unlink', 'remove', 'rename'), (),
     'mkstemp temp path', True),
)

#: lineage-covered modules (path suffixes, ``/``-anchored) under the
#: determinism discipline: unseeded randomness, unordered iteration feeding
#: an order-sensitive sink, and ``id()``-keyed containers are findings —
#: the static twin of ``compose_global_digest``'s runtime proof
#: (docs/robustness.md "Provable determinism at any topology")
DETERMINISM_MODULES: Tuple[str, ...] = ('reader.py',
                                        'workers/ventilator.py',
                                        'schedule/cost_schedule.py',
                                        'parallel/topology.py',
                                        'parallel/loader.py',
                                        'parallel/inmem_loader.py',
                                        'service/dispatcher.py',
                                        'telemetry/lineage.py')

#: call names whose argument order IS the reproducibility contract: digest
#: folds, journal appends, shard deals, progress notes. Unordered iteration
#: (sets, ``os.listdir``, ``glob``, raw dict views) flowing into one of
#: these without an intervening ``sorted()`` is a determinism finding.
ORDER_SENSITIVE_SINKS: Tuple[str, ...] = ('append_record', '_journal',
                                          'fold_digest', 'deal_assignment',
                                          'reshard_assignments',
                                          'note_join', 'note_leave',
                                          'note_progress', 'note_reshard',
                                          'note_lease')

#: the append-only CRC-framed journals and their closed record registries,
#: for the journal-discipline rule. Each row is ``(file_suffix,
#: registry_name, writer_call_names, kind_label, import_name)``: inside the
#: journal module every ``kind == 'x'`` replay compare, and everywhere any
#: literal first argument to one of ``writer_call_names``, must name an
#: entry of ``registry_name`` (declared in the journal module; resolved
#: from the installed ``import_name``'s source, found without importing
#: it, when the analyzed tree lacks it).
JOURNAL_REGISTRIES: Tuple[Tuple[str, str, Tuple[str, ...], str, str],
                          ...] = (
    ('ledger.py', 'LEDGER_RECORD_KINDS', ('append_record', '_journal'),
     'ledger record kind', 'petastorm_tpu_torch.service.ledger'),
    ('topology.py', 'TOPOLOGY_RECORD_KINDS', ('append_record', '_journal'),
     'topology record kind', 'petastorm_tpu_torch.parallel.topology'),
    ('history.py', 'RUN_RECORD_OWNERS', ('build_run_record',),
     'run-record owner', 'petastorm_tpu_torch.telemetry.history'),
)


@dataclass(frozen=True)
class AnalysisConfig:
    """Resolved configuration for one pipecheck run (defaults above)."""

    protocol_peer_files: Tuple[str, ...] = PROTOCOL_PEER_FILES
    service_peer_files: Tuple[str, ...] = SERVICE_PEER_FILES
    descriptor_files: Tuple[str, ...] = DESCRIPTOR_FILES
    clock_disciplined_files: Tuple[str, ...] = CLOCK_DISCIPLINED_FILES
    worker_dir: str = WORKER_DIR
    datapath_files: Tuple[str, ...] = DATAPATH_FILES
    stage_catalog_suffix: str = STAGE_CATALOG_SUFFIX
    quarantine_registry_suffix: str = QUARANTINE_REGISTRY_SUFFIX
    ledger_file_suffix: str = LEDGER_FILE_SUFFIX
    topology_file_suffix: str = TOPOLOGY_FILE_SUFFIX
    knob_catalog_suffix: str = KNOB_CATALOG_SUFFIX
    cost_model_suffix: str = COST_MODEL_SUFFIX
    strict_flags: Tuple[str, ...] = STRICT_FLAGS
    leakable_types: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...],
                                Tuple[str, ...], str, bool],
                          ...] = LEAKABLE_TYPES
    determinism_modules: Tuple[str, ...] = DETERMINISM_MODULES
    order_sensitive_sinks: Tuple[str, ...] = ORDER_SENSITIVE_SINKS
    journal_registries: Tuple[Tuple[str, str, Tuple[str, ...], str, str],
                              ...] = JOURNAL_REGISTRIES
    #: explicit mypy.ini path; None = walk up from the analyzed roots
    mypy_ini_path: Optional[str] = None
    #: explicit ratchet manifest path; None = the packaged
    #: ``analysis/strict_modules.txt``
    manifest_path: Optional[str] = None


def default_config() -> AnalysisConfig:
    """The shipped configuration (what the CLI and tier-1 self-check use)."""
    return AnalysisConfig()
