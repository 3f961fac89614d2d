"""Deterministic chaos harness for the epoch-survivable control plane: a
copy of ``petastorm_tpu.test_util.chaos`` over the port's fleet, readers and
topology plane.

Where :mod:`~petastorm_tpu_torch.test_util.fault_injection` damages the DATA plane
(opens that fail, hang, or kill a decode worker), this module damages the
CONTROL plane on a seeded schedule: SIGKILL the dispatcher at row N of an
epoch, SIGKILL worker k mid-item, silence a client long enough to be
TTL-collected, or corrupt one frame of the durable dispatcher ledger before
the restart replays it. The point is not that the run survives — it is that
it survives *provably*: the chaos epoch must deliver exactly the baseline's
rows and its lineage order digest must be byte-identical to a same-seed
undisturbed run (``lineage diff`` exit 0), which is what the
``petastorm-tpu-torch-throughput chaos`` verdict enforces.

Trigger state lives in ``state_dir`` as atomically created marker files —
the same ``O_CREAT|O_EXCL`` once-only-global idiom as
:class:`~petastorm_tpu_torch.test_util.fault_injection.FaultSchedule` — so a rule
fires exactly once no matter how many processes or retries observe its
trigger row. Rules without an explicit ``at`` row resolve it from the
schedule seed and the epoch's row horizon, so two runs with the same seed
injure the epoch at the same rows.

Usage::

    schedule = ChaosSchedule(state_dir, [
        ChaosRule('kill_dispatcher'),            # at a seeded mid-epoch row
        ChaosRule('kill_worker', at=120),        # SIGKILL worker 0 at row 120
        ChaosRule('partition_client', pause_s=3.0),
        ChaosRule('corrupt_ledger', after_kind='kill_dispatcher'),
    ], seed=7)
    schedule.resolve(horizon=total_rows)
    report = run_chaos_epoch(reader, fleet, schedule)

CLI: ``petastorm-tpu-torch-throughput chaos <dataset_url>`` — runs the undisturbed
baseline epoch, re-runs it under the schedule against a ledger-armed
:class:`~petastorm_tpu_torch.service.fleet.ServiceFleet`, and exits nonzero unless
rows are exact, ``lineage verify`` passes, and the two manifests diff clean.
``--stale-timeout-s`` (the port's own flag) shortens the fleet's staleness
window, after which a SIGKILLed worker's item is re-queued (default: the
dispatcher's 15 s).

``chaos --hosts N`` switches to the TOPOLOGY plane
(:mod:`~petastorm_tpu_torch.parallel.topology`): N topology-armed hosts run sequentially
in-process over one shared membership journal (simulated multi-host — the
determinism contract makes sequential and concurrent hosts equivalent),
``--kill-host`` abandons a seeded host mid-shard WITHOUT a leave record (a
SIGKILL, to every replay), ``--join-host`` pauses the pod and adds host N,
and in either case the survivors re-deal only the undelivered remainder at
generation 1. The verdict demands rows exact versus an undisturbed same-seed
baseline, the composed global digest (:func:`compose_global_digest`)
byte-identical, zero duplicate deliveries, ``lineage verify`` exit 0 on the
recovery manifests, and ``lineage diff`` attributing the survivor's
divergence to ``topology`` (exit 8).
"""

import json
import logging
import os
import random
import time

logger = logging.getLogger(__name__)

#: the last two are topology-plane injuries fired by the ``--hosts`` engine
#: (:func:`run_host_chaos`), not by row-triggered :class:`ChaosRule` firing
CHAOS_KINDS = ('kill_dispatcher', 'kill_worker', 'partition_client',
               'corrupt_ledger', 'kill_host', 'join_host')

#: chaos runs want dispatcher-crash recovery in seconds: the harness
#: defaults the client response window down to this unless the caller
#: already pinned PETASTORM_TPU_SERVICE_RESPONSE_TIMEOUT_S
_CHAOS_RESPONSE_TIMEOUT_S = '2.0'


class ChaosRule(object):
    """One seeded control-plane injury, fired once at a trigger row.

    :param kind: one of :data:`CHAOS_KINDS` — ``'kill_dispatcher'`` hard-
        stops the in-process dispatcher and starts a fresh incarnation on
        the same port (:meth:`ServiceFleet.crash_dispatcher`);
        ``'kill_worker'`` SIGKILLs worker ``worker_index`` mid-item;
        ``'partition_client'`` silences the consumer for ``pause_s``
        (submits and acks stop flowing — the dispatcher-side view of a
        network partition); ``'corrupt_ledger'`` bit-flips one frame of the
        fleet's durable ledger journal so the NEXT dispatcher restart must
        degrade loudly instead of replaying silently wrong.
        ``'kill_host'`` / ``'join_host'`` are topology-plane kinds executed
        by the ``--hosts`` engine (:func:`run_host_chaos`) rather than by
        row-triggered firing against a fleet.
    :param at: 1-based row count that triggers the rule; None resolves a
        seeded mid-epoch row at :meth:`ChaosSchedule.resolve` time.
    :param worker_index: which fleet worker ``'kill_worker'`` targets.
    :param pause_s: silence duration for ``'partition_client'``.
    :param corrupt_mode: file-damage mode for ``'corrupt_ledger'``
        (:func:`~petastorm_tpu_torch.test_util.fault_injection.corrupt_file`).
    """

    def __init__(self, kind, at=None, worker_index=0, pause_s=2.0,
                 corrupt_mode='flip'):
        if kind not in CHAOS_KINDS:
            raise ValueError('kind must be one of {}, got {!r}'
                             .format(CHAOS_KINDS, kind))
        if at is not None and at < 1:
            raise ValueError('at must be >= 1 or None (seeded)')
        self.kind = kind
        self.at = at
        self.worker_index = worker_index
        self.pause_s = pause_s
        self.corrupt_mode = corrupt_mode

    def as_dict(self):
        return {'kind': self.kind, 'at': self.at,
                'worker_index': self.worker_index, 'pause_s': self.pause_s,
                'corrupt_mode': self.corrupt_mode}


class ChaosSchedule(object):
    """Ordered chaos rules plus once-only trigger state (marker files in
    ``state_dir``, the :class:`FaultSchedule` idiom). ``seed`` makes the
    unresolved trigger rows deterministic: rule i with ``at=None`` lands at
    a mid-epoch row drawn from ``Random(seed * 1000003 + i)`` over the
    middle half of the horizon, so same seed + same horizon = same injury
    rows on every run."""

    def __init__(self, state_dir, rules, seed=0):
        self.state_dir = str(state_dir)
        self.rules = list(rules)
        self.seed = int(seed)
        os.makedirs(self.state_dir, exist_ok=True)

    def resolve(self, horizon):
        """Pin every unresolved rule's trigger row against an epoch of
        ``horizon`` rows (the middle half: injuries land mid-epoch, after
        the pipeline is flowing and before the natural drain)."""
        if horizon < 4:
            raise ValueError('horizon must be >= 4 rows to seed mid-epoch '
                             'trigger rows, got {}'.format(horizon))
        for index, rule in enumerate(self.rules):
            if rule.at is None:
                rng = random.Random(self.seed * 1000003 + index)
                rule.at = rng.randrange(horizon // 4, 3 * horizon // 4)
        return self

    def _claim(self, rule_index):
        """Atomically claim rule ``rule_index``'s single firing slot; False
        when another observer already fired it."""
        marker = os.path.join(self.state_dir,
                              'chaos-{}.fired'.format(rule_index))
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def due(self, row_count):
        """Claim and return the ``(rule_index, rule)`` pairs whose trigger
        row has been reached and whose once-only slot this caller won."""
        fired = []
        for index, rule in enumerate(self.rules):
            if rule.at is None or row_count < rule.at:
                continue
            if self._claim(index):
                fired.append((index, rule))
        return fired

    def fired_count(self):
        """Rules that have fired so far (marker-file census)."""
        return sum(1 for index in range(len(self.rules))
                   if os.path.exists(os.path.join(
                       self.state_dir, 'chaos-{}.fired'.format(index))))


def _fire(rule, fleet):
    """Execute one claimed rule against the running fleet."""
    if rule.kind == 'kill_dispatcher':
        fleet.crash_dispatcher()
    elif rule.kind == 'kill_worker':
        index = min(rule.worker_index, len(fleet.processes) - 1)
        fleet.kill_worker(index)
    elif rule.kind == 'partition_client':
        # consumer-side silence: no submits, no acks, no probes leave this
        # client for pause_s — from the dispatcher it is indistinguishable
        # from a partitioned host, and a pause past the client TTL forces
        # the full collect-then-rejoin choreography
        time.sleep(rule.pause_s)
    elif rule.kind == 'corrupt_ledger':
        from petastorm_tpu_torch.test_util.fault_injection import corrupt_file
        if fleet.ledger_path and os.path.exists(fleet.ledger_path):
            corrupt_file(fleet.ledger_path, rule.corrupt_mode)
        else:
            logger.warning('corrupt_ledger fired but the fleet has no '
                           'ledger journal to damage')
    else:
        logger.warning('%s is a topology-plane kind — it fires from the '
                       '--hosts engine, not against a fleet', rule.kind)


def run_chaos_epoch(reader, fleet, schedule):
    """Consume ``reader`` to exhaustion, firing ``schedule``'s due rules
    after each delivered row. Returns ``{'rows', 'fired'}`` where
    ``fired`` lists ``{'row', **rule}`` in firing order."""
    rows = 0
    fired = []
    for _ in reader:
        rows += 1
        for index, rule in schedule.due(rows):
            logger.info('chaos: firing rule %d (%s) at row %d',
                        index, rule.kind, rows)
            _fire(rule, fleet)
            fired.append(dict(rule.as_dict(), row=rows))
    return {'rows': rows, 'fired': fired}


# ---------------------------------------------------------------------------
# CLI: petastorm-tpu-torch-throughput chaos
# ---------------------------------------------------------------------------

def _run_epoch(dataset_url, service_url, seed, manifest_path, fleet=None,
               schedule=None):
    """One lineage-armed epoch against the fleet; chaos-driven when a
    schedule is given."""
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.telemetry.lineage import LineagePolicy
    policy = LineagePolicy(manifest_path=manifest_path)
    with make_reader(dataset_url, service_url=service_url, num_epochs=1,
                     seed=seed, shuffle_row_groups=True,
                     lineage=policy) as reader:
        if schedule is None:
            rows = sum(1 for _ in reader)
            return {'rows': rows, 'fired': []}
        return run_chaos_epoch(reader, fleet, schedule)


# ---------------------------------------------------------------------------
# Topology plane: --hosts N (simulated multi-host, shared membership journal)
# ---------------------------------------------------------------------------

def _run_host_epoch(dataset_url, policy, seed, manifest_path, stop_after=None):
    """One simulated host's topology-armed, lineage-armed epoch.

    ``stop_after=k`` kills the host at the k-th BATCH boundary via
    :meth:`HostTopology.abandon` (journal closed with no leave record — a
    crash, to every later replay); ``stop_after=0`` kills it before any
    delivery. Batch boundaries matter: with the dummy pool a popped batch IS
    one work item, and ``_note_item_consumed`` (which journals topology
    progress) fires exactly when a batch is popped — breaking mid-batch would
    leave the item unacknowledged and double-deliver it after the reshard.
    """
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.telemetry.lineage import LineagePolicy
    reader = make_reader(dataset_url, reader_pool_type='dummy', num_epochs=1,
                         seed=seed, shuffle_row_groups=True,
                         lineage=LineagePolicy(manifest_path=manifest_path),
                         topology=policy)
    rows = 0
    batches = 0
    killed = False
    info = {'host_id': reader._topology.host_id,
            'assignment': list(reader._topology.assignment),
            'global_rowgroups': reader._topology.num_rowgroups}
    try:
        if stop_after is not None and stop_after <= 0:
            killed = True
            reader._topology.abandon()
        else:
            for batch in reader.iter_columnar():
                rows += batch.num_rows
                batches += 1
                if stop_after is not None and batches >= stop_after:
                    killed = True
                    reader._topology.abandon()
                    break
    finally:
        reader.stop()
        reader.join()
    info.update(rows=rows, batches=batches, killed=killed)
    return info


def run_host_chaos(dataset_url, workdir, hosts, seed, kill_host=False,
                   join_host=False):
    """Prove elastic pod-scale sharding survives a topology mutation.

    Three acts, all sequential in-process (determinism makes the serial
    schedule equivalent to a concurrent pod):

    1. **Baseline** — an undisturbed same-seed pod (``hosts`` hosts for the
       kill/join modes, ONE host in steady mode so ``--hosts N`` alone
       proves the any-topology-invariance of the composed digest).
    2. **Chaos** — the same pod over a fresh shared journal; ``kill_host``
       abandons one seeded host mid-shard (no leave record), ``join_host``
       pauses every host mid-shard so host N can join the re-deal.
    3. **Recovery** — replay the journal, compute the undelivered remainder,
       round-robin it over the survivors (plus the joiner), journal the
       generation-1 reshard, and run each survivor's pinned-assignment
       recovery epoch.

    The verdict (returned dict, ``'ok'`` key) demands phase-1 + recovery
    rows exactly equal the baseline, the composed global digest
    byte-identical with zero duplicate deliveries, ``lineage verify`` exit 0
    on a recovery manifest, and ``lineage diff`` of a survivor's baseline vs
    recovery manifest attributing the divergence to ``topology`` (exit 8).
    """
    if kill_host and join_host:
        raise ValueError('kill_host and join_host are mutually exclusive')
    if hosts < 1:
        raise ValueError('hosts must be >= 1, got {}'.format(hosts))
    from petastorm_tpu_torch.parallel.topology import (
        MembershipJournal, TopologyPolicy, compose_global_digest,
        deal_assignment, replay_topology_journal, reshard_assignments,
        undelivered_items)
    from petastorm_tpu_torch.telemetry.lineage import (EXIT_TOPOLOGY,
                                                 diff_manifests,
                                                 verify_manifest)
    os.makedirs(workdir, exist_ok=True)
    mode = 'kill_host' if kill_host else ('join_host' if join_host
                                          else 'steady')
    rng = random.Random(seed * 1000003 + 1)

    # --- act 1: the undisturbed oracle -----------------------------------
    baseline_hosts = hosts if mode != 'steady' else 1
    baseline_journal = os.path.join(workdir, 'baseline-topology-journal.bin')
    baseline_manifests = []
    baseline_rows = 0
    num_rowgroups = None
    for index in range(baseline_hosts):
        if num_rowgroups is not None and not deal_assignment(
                index, baseline_hosts, num_rowgroups):
            baseline_manifests.append(None)  # empty shard: nothing to read
            continue
        manifest = os.path.join(workdir,
                                'baseline-host{}.jsonl'.format(index))
        result = _run_host_epoch(
            dataset_url,
            TopologyPolicy(journal_path=baseline_journal,
                           process_index=index,
                           process_count=baseline_hosts),
            seed, manifest)
        num_rowgroups = result['global_rowgroups']
        baseline_rows += result['rows']
        baseline_manifests.append(manifest)
    baseline_digest = compose_global_digest(
        [m for m in baseline_manifests if m])
    logger.info('chaos --hosts: baseline (%d host(s)) delivered %d rows, '
                'digest %s', baseline_hosts, baseline_rows,
                baseline_digest['digest'])

    # --- act 2: the injured pod ------------------------------------------
    journal = os.path.join(workdir, 'chaos-topology-journal.bin')
    killed_index = rng.randrange(hosts) if kill_host else None
    phase1_manifests = []
    phase1_rows = 0
    fired = []
    for index in range(hosts):
        if not deal_assignment(index, hosts, num_rowgroups):
            continue
        pieces = len(deal_assignment(index, hosts, num_rowgroups))
        stop_after = None
        if kill_host and index == killed_index:
            # seeded mid-shard batch boundary (middle-half idiom collapses
            # to any interior boundary for small shards)
            stop_after = rng.randrange(1, pieces) if pieces >= 2 else 0
            fired.append({'kind': 'kill_host',
                          'host': 'host-{}'.format(index),
                          'after_batches': stop_after})
        elif join_host:
            # every incumbent pauses mid-shard so the joiner has a
            # remainder to be dealt into
            stop_after = pieces // 2
            fired.append({'kind': 'join_host',
                          'host': 'host-{}'.format(index),
                          'after_batches': stop_after})
        manifest = os.path.join(workdir, 'chaos-host{}.jsonl'.format(index))
        result = _run_host_epoch(
            dataset_url,
            TopologyPolicy(journal_path=journal, process_index=index,
                           process_count=hosts),
            seed, manifest, stop_after=stop_after)
        phase1_rows += result['rows']
        if result['rows']:
            phase1_manifests.append(manifest)

    # --- act 3: replay, re-deal, recover ---------------------------------
    replay = replay_topology_journal(journal)
    undelivered = undelivered_items(num_rowgroups, 0, replay.delivered)
    new_count = hosts + 1 if join_host else hosts
    survivors = ['host-{}'.format(index) for index in range(new_count)
                 if not (kill_host and index == killed_index)]
    recovery_rows = 0
    recovery_pairs = []
    resharded = {}
    if undelivered:
        resharded = reshard_assignments(undelivered, survivors)
        writer = MembershipJournal(journal)
        writer.open()
        writer.note_reshard(1, resharded, mode)
        writer.close()
        for host in survivors:
            assignment = resharded.get(host, ())
            if not assignment:
                continue
            index = int(host.rsplit('-', 1)[1])
            manifest = os.path.join(workdir,
                                    'recovery-host{}.jsonl'.format(index))
            result = _run_host_epoch(
                dataset_url,
                TopologyPolicy(journal_path=journal, process_index=index,
                               process_count=new_count,
                               assignment=assignment, generation=1),
                seed, manifest)
            recovery_rows += result['rows']
            recovery_pairs.append((index, manifest))
        logger.info('chaos --hosts: generation-1 reshard re-dealt %d '
                    'undelivered item(s) over %d survivor(s)',
                    len(undelivered), len(survivors))

    # --- verdict ----------------------------------------------------------
    # re-replay so the verdict reports the journal's FINAL state (the
    # generation-1 reshard record and the recovery epochs included), not
    # the pre-reshard snapshot act 3 dealt from
    final_replay = replay_topology_journal(journal)
    chaos_manifests = phase1_manifests + [m for _, m in recovery_pairs]
    chaos_digest = compose_global_digest(chaos_manifests)
    rows_chaos = phase1_rows + recovery_rows
    rows_exact = rows_chaos == baseline_rows
    digest_exact = (chaos_digest['digest'] == baseline_digest['digest']
                    and not chaos_digest['duplicates'])
    verify = (verify_manifest(recovery_pairs[0][1]) if recovery_pairs
              else verify_manifest(chaos_manifests[0]))
    # the attribution probe: a survivor's recovery stream vs its own
    # baseline must diff to 'topology' (exit 8) — in steady mode the
    # 1-host baseline vs an N-host shard carries the same attribution
    diff = None
    expected_diff_exit = EXIT_TOPOLOGY
    diff_pair = next(((index, manifest) for index, manifest in recovery_pairs
                      if index < len(baseline_manifests)
                      and baseline_manifests[index]), None)
    if diff_pair is not None:
        diff = diff_manifests(baseline_manifests[diff_pair[0]], diff_pair[1])
    elif mode == 'steady' and phase1_manifests:
        diff = diff_manifests(baseline_manifests[0], phase1_manifests[0])
        if hosts == 1:
            expected_diff_exit = 0  # same topology both sides
    verdict = {
        'mode': mode,
        'hosts': hosts,
        'global_rowgroups': num_rowgroups,
        'rows_baseline': baseline_rows,
        'rows_chaos': rows_chaos,
        'rows_exact': rows_exact,
        'fired': fired,
        'digest_baseline': baseline_digest['digest'],
        'digest_chaos': chaos_digest['digest'],
        'digest_exact': digest_exact,
        'duplicates': chaos_digest['duplicates'],
        'undelivered_resharded': len(undelivered),
        'reshard_assignments': {host: list(indices) for host, indices
                                in sorted(resharded.items())},
        'verify_exit_code': verify.get('exit_code'),
        'diff_exit_code': diff.get('exit_code') if diff else None,
        'diff_attribution': diff.get('attribution') if diff else None,
        'journal': {'path': journal, 'generation': final_replay.generation,
                    'frames_dropped': final_replay.frames_dropped,
                    'records': final_replay.records},
        'manifests': {'baseline': [m for m in baseline_manifests if m],
                      'chaos': chaos_manifests},
    }
    ok = rows_exact and digest_exact and verify.get('exit_code') == 0
    if mode != 'steady':
        # an injury must actually have fired and been re-dealt
        ok = ok and bool(fired) and bool(undelivered)
    if diff is not None:
        ok = ok and diff.get('exit_code') == expected_diff_exit
    verdict['ok'] = ok
    return verdict


def _verdict_json(verdict):
    """The verdict as indented JSON; the composed digests (bytes) print as
    hex, where the JAX package's ``--hosts --json`` raises TypeError."""
    return json.dumps(verdict, indent=2, sort_keys=True,
                      default=lambda value: value.hex() if isinstance(value, bytes)
                      else repr(value))


def main(argv=None):
    """``petastorm-tpu-torch-throughput chaos`` entry (module docstring): baseline
    epoch, then the same seed under a chaos schedule against a ledger-armed
    fleet; exit 0 only when rows are exact, the chaos manifest dry-replay
    verifies, and the two manifests diff byte-identical."""
    import argparse
    import tempfile
    parser = argparse.ArgumentParser(
        description='Prove an epoch survives seeded control-plane chaos '
                    '(dispatcher kill, worker kill, client partition, '
                    'ledger corruption) with rows exact and the lineage '
                    'digest unchanged')
    parser.add_argument('dataset_url')
    parser.add_argument('--workers', type=int, default=2,
                        help='decode workers in the chaos fleet')
    parser.add_argument('--seed', type=int, default=1234,
                        help='reader shuffle seed AND chaos-schedule seed')
    parser.add_argument('--workdir', default=None,
                        help='scratch home for manifests, the ledger and '
                             'trigger markers (default: a fresh tempdir)')
    parser.add_argument('--kill-dispatcher-at', type=int, default=None,
                        metavar='ROW', help='pin the dispatcher kill to ROW '
                                            '(default: seeded mid-epoch)')
    parser.add_argument('--kill-worker-at', type=int, default=None,
                        metavar='ROW', help='pin the worker SIGKILL to ROW '
                                            '(default: seeded mid-epoch)')
    parser.add_argument('--partition-s', type=float, default=0.0,
                        help='also silence the client this long mid-epoch '
                             '(0 = no partition rule)')
    parser.add_argument('--corrupt-ledger', action='store_true',
                        help='also bit-flip one ledger frame BEFORE the '
                             'dispatcher kill: the restart must degrade '
                             'loudly (CRC drop counter), never replay '
                             'silently wrong')
    parser.add_argument('--hosts', type=int, default=0, metavar='N',
                        help='topology mode: run N simulated topology-armed '
                             'hosts over a shared membership journal '
                             'instead of a service fleet')
    parser.add_argument('--kill-host', action='store_true',
                        help='with --hosts: abandon a seeded host mid-shard '
                             'with NO leave record; survivors must re-deal '
                             'only its undelivered remainder')
    parser.add_argument('--join-host', action='store_true',
                        help='with --hosts: pause the pod mid-shard and '
                             'deal host N into the generation-1 reshard')
    parser.add_argument('--stale-timeout-s', type=float, default=None,
                        help='the chaos fleets\' staleness window: a SIGKILLed '
                             'worker\'s item re-queues after it (default: the '
                             'dispatcher\'s)')
    parser.add_argument('--json', action='store_true',
                        help='print the verdict as one JSON object')
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.kill_host and args.join_host:
        parser.error('--kill-host and --join-host are mutually exclusive')
    if (args.kill_host or args.join_host) and not args.hosts:
        parser.error('--kill-host/--join-host require --hosts N')
    if args.hosts:
        workdir = args.workdir or tempfile.mkdtemp(
            prefix='petastorm-tpu-chaos-hosts-')
        verdict = run_host_chaos(args.dataset_url, workdir, args.hosts,
                                 args.seed, kill_host=args.kill_host,
                                 join_host=args.join_host)
        if args.json:
            print(_verdict_json(verdict))
        else:
            print('chaos --hosts {}: {} — mode {}, rows {}/{}, digest {}, '
                  'verify exit {}, diff exit {} ({})'.format(
                      args.hosts,
                      'SURVIVED' if verdict['ok'] else 'FAILED',
                      verdict['mode'], verdict['rows_chaos'],
                      verdict['rows_baseline'],
                      'EXACT' if verdict['digest_exact'] else 'DIVERGED',
                      verdict['verify_exit_code'],
                      verdict['diff_exit_code'],
                      verdict['diff_attribution']))
            if not verdict['ok']:
                print(_verdict_json(verdict))
        return 0 if verdict['ok'] else 1
    os.environ.setdefault('PETASTORM_TPU_SERVICE_RESPONSE_TIMEOUT_S',
                          _CHAOS_RESPONSE_TIMEOUT_S)
    from petastorm_tpu_torch.service.fleet import ServiceFleet
    from petastorm_tpu_torch.telemetry.lineage import diff_manifests, verify_manifest
    fleet_kwargs = ({} if args.stale_timeout_s is None
                    else {'stale_timeout_s': args.stale_timeout_s})

    workdir = args.workdir or tempfile.mkdtemp(prefix='petastorm-tpu-chaos-')
    os.makedirs(workdir, exist_ok=True)
    manifest_a = os.path.join(workdir, 'baseline-manifest.jsonl')
    manifest_b = os.path.join(workdir, 'chaos-manifest.jsonl')
    ledger_path = os.path.join(workdir, 'dispatcher-ledger.bin')

    # baseline: an undisturbed same-seed epoch is both the row-exactness
    # oracle and the lineage reference stream
    with ServiceFleet(workers=args.workers,
                      cache_dir=os.path.join(workdir, 'cache-a'), **fleet_kwargs) as fleet:
        baseline = _run_epoch(args.dataset_url, fleet.service_url,
                              args.seed, manifest_a)
    logger.info('chaos: baseline epoch delivered %d rows', baseline['rows'])

    rules = []
    if args.corrupt_ledger:
        # fires on the row BEFORE the dispatcher kill: the damage must be
        # on disk when the replacement replays the journal
        corrupt_at = (max(1, args.kill_dispatcher_at - 1)
                      if args.kill_dispatcher_at else None)
        rules.append(ChaosRule('corrupt_ledger', at=corrupt_at))
    rules.append(ChaosRule('kill_dispatcher', at=args.kill_dispatcher_at))
    rules.append(ChaosRule('kill_worker', at=args.kill_worker_at,
                           worker_index=0))
    if args.partition_s > 0:
        rules.append(ChaosRule('partition_client', pause_s=args.partition_s))
    schedule = ChaosSchedule(os.path.join(workdir, 'chaos-markers'), rules,
                             seed=args.seed)
    schedule.resolve(horizon=baseline['rows'])
    if args.corrupt_ledger and rules[0].at >= rules[1].at:
        rules[0].at = max(1, rules[1].at - 1)

    with ServiceFleet(workers=args.workers,
                      cache_dir=os.path.join(workdir, 'cache-b'),
                      ledger=ledger_path, **fleet_kwargs) as fleet:
        chaos = _run_epoch(args.dataset_url, fleet.service_url, args.seed,
                           manifest_b, fleet=fleet, schedule=schedule)
        ledger_state = fleet.dispatcher.ledger_state()

    verify = verify_manifest(manifest_b)
    diff = diff_manifests(manifest_a, manifest_b)
    rows_exact = chaos['rows'] == baseline['rows']
    verdict = {
        'rows_baseline': baseline['rows'],
        'rows_chaos': chaos['rows'],
        'rows_exact': rows_exact,
        'fired': chaos['fired'],
        'verify_exit_code': verify.get('exit_code'),
        'diff_exit_code': diff.get('exit_code'),
        'ledger': ledger_state,
        'manifests': {'baseline': manifest_a, 'chaos': manifest_b},
    }
    ok = (rows_exact and verify.get('exit_code') == 0
          and diff.get('exit_code') == 0 and len(chaos['fired']) == len(rules))
    if args.corrupt_ledger:
        # loud-degrade proof: the corrupted frame must have been COUNTED
        ok = ok and ledger_state.get('frames_dropped', 0) >= 1
    verdict['ok'] = ok
    if args.json:
        print(_verdict_json(verdict))
    else:
        print('chaos: {} — {} of {} rule(s) fired, rows {}/{}, lineage '
              'verify exit {}, diff exit {}'.format(
                  'SURVIVED' if ok else 'FAILED', len(chaos['fired']),
                  len(rules), chaos['rows'], baseline['rows'],
                  verify.get('exit_code'), diff.get('exit_code')))
        if not ok:
            print(_verdict_json(verdict))
    return 0 if ok else 1


if __name__ == '__main__':
    import sys
    sys.exit(main())
