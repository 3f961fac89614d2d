"""Cost-aware sample scheduling: a copy of
``petastorm_tpu.schedule.cost_schedule``.

It consumes the persisted :class:`~petastorm_tpu_torch.telemetry.cost_model.CostLedger`
to decide when each rowgroup is processed:

- **interleave**: :meth:`CostAwareScheduler.order_items` reorders each
  epoch's ventilation so heavy and light rowgroups alternate (a seeded
  cost-balanced shuffle: the same seed and ledger give the same order on
  every pool; with no ledger the order is the plain seeded shuffle);
- **pre-stage**: each heavy item takes the earliest slot of its interleave
  window, so the heaviest rowgroup of the epoch ventilates first;
- **split**: :meth:`CostAwareScheduler.plan_items` turns a rowgroup whose
  measured cost crosses ``split_threshold`` x median into several sub-range
  work items (``row_range=(start_row, stop_row)`` through
  ``reader_worker.process``), decoded by several workers at once;
- **route**: :meth:`CostAwareScheduler.cost_hint_for` prices a work item for
  the input service (:mod:`~petastorm_tpu_torch.service`): a
  ``service_url`` reader ships the hint with each submit and the
  dispatcher's DRR charges it.

Cold start: with no persisted ledger every cost is uniform, the plan is a
no-op and the read equals an unscheduled reader's, while the reader feeds the
live ledger from the batches' telemetry sidecars; :meth:`CostAwareScheduler.persist`
folds those observations into the sidecar at ``Reader.stop`` so the next run
schedules from data. The plan is frozen at construction, a pure function of
ledger, policy and seed, so the ventilation order never depends on timing:
given the same ledger, items and seed, the order equals the JAX package's item
for item. This module reads no clock.
"""

from __future__ import annotations

import logging
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

from petastorm_tpu_torch.service.wire import MAX_COST_HINT, MIN_COST_HINT
from petastorm_tpu_torch.telemetry.cost_model import (COST_STAGES, CostLedger,
                                                default_ledger_path,
                                                percentile)
from petastorm_tpu_torch.telemetry.tracing import trace_enabled, trace_instant

logger = logging.getLogger(__name__)


#: how many recent epoch orders :meth:`CostAwareScheduler.report` retains
_ORDER_HISTORY = 8


@dataclass(frozen=True)
class SchedulePolicy:
    """Frozen cost-aware scheduling policy.

    ``heavy_skew`` and ``split_threshold`` are in units of the ledger's
    MEDIAN rowgroup cost: a rowgroup costing ``>= heavy_skew x median`` is
    interleave-spread (and pre-staged), one costing ``>= split_threshold x
    median`` is split into up to ``split_max`` sub-range work items (never
    below ``min_split_rows`` rows per part). ``ledger_path`` overrides where
    the persisted ledger sidecar is read from and written to (default: the
    :func:`~petastorm_tpu_torch.telemetry.cost_model.default_ledger_path`
    location next to the disk cache / a local dataset)."""

    interleave: bool = True
    prestage: bool = True
    split: bool = True
    heavy_skew: float = 2.0
    split_threshold: float = 4.0
    split_max: int = 4
    min_split_rows: int = 1
    ledger_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.heavy_skew <= 1.0:
            raise ValueError('heavy_skew must be > 1.0 (a rowgroup at the '
                             'median is not heavy), got {!r}'
                             .format(self.heavy_skew))
        if self.split_threshold < self.heavy_skew:
            raise ValueError('split_threshold must be >= heavy_skew '
                             '(splitting is the stronger intervention), got '
                             '{!r} < {!r}'.format(self.split_threshold,
                                                  self.heavy_skew))
        if self.split_max < 2:
            raise ValueError('split_max must be >= 2, got {!r}'
                             .format(self.split_max))
        if self.min_split_rows < 1:
            raise ValueError('min_split_rows must be >= 1, got {!r}'
                             .format(self.min_split_rows))

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe policy view for reports and the schedule preview."""
        return {'interleave': self.interleave, 'prestage': self.prestage,
                'split': self.split, 'heavy_skew': self.heavy_skew,
                'split_threshold': self.split_threshold,
                'split_max': self.split_max,
                'min_split_rows': self.min_split_rows,
                'ledger_path': self.ledger_path}


def resolve_schedule_policy(value: Any) -> Optional[SchedulePolicy]:
    """Normalize the ``make_reader(cost_schedule=...)`` knob: ``None``/
    ``False`` -> no scheduler (the byte-identical default path), ``True`` ->
    the default :class:`SchedulePolicy`, a policy instance -> itself, a
    string -> default policy with that ``ledger_path``."""
    if value is None or value is False:
        return None
    if value is True:
        return SchedulePolicy()
    if isinstance(value, SchedulePolicy):
        return value
    if isinstance(value, str):
        return SchedulePolicy(ledger_path=value)
    raise TypeError('cost_schedule must be None/False, True, a ledger path, '
                    'or a SchedulePolicy; got {!r}'.format(value))


def load_ledger(dataset_url: str, dataset_token: str,
                cache_location: Optional[str] = None,
                ledger_path: Optional[str] = None
                ) -> Tuple[Optional[CostLedger], Optional[str]]:
    """Locate and load the persisted cost ledger for one reader: returns
    ``(ledger_or_None, resolved_path_or_None)``. A missing, unreadable or
    token-mismatched sidecar yields ``None`` (cold start) — never an error:
    absence of cost knowledge must degrade to the unscheduled order, not
    fail the read."""
    path = ledger_path or default_ledger_path(dataset_url, dataset_token,
                                              cache_location)
    if path is None:
        return None, None
    try:
        ledger = CostLedger.load(path)
    except FileNotFoundError:
        return None, path
    except (OSError, ValueError, KeyError) as exc:
        logger.warning('cost ledger at %s is unreadable (%s); scheduling '
                       'cold (uniform costs)', path, exc)
        return None, path
    if ledger.dataset_token != dataset_token:
        logger.warning('cost ledger at %s was recorded for dataset token %s '
                       '(this read is %s); scheduling cold (uniform costs)',
                       path, ledger.dataset_token, dataset_token)
        return None, path
    return ledger, path


def _ledger_costs(ledger: CostLedger) -> Dict[str, Dict[str, float]]:
    """Per-rowgroup per-stage cost sums out of a ledger, via its JSON view
    (the only public complete iteration surface)."""
    doc = ledger.to_dict()
    costs: Dict[str, Dict[str, float]] = {}
    for key, entry in (doc.get('rowgroups') or {}).items():
        stages = entry.get('stages') or {}
        costs[str(key)] = {
            str(stage): float(cell.get('sum_s', 0.0))
            for stage, cell in stages.items() if stage in COST_STAGES}
    return costs


def _median_cost(totals: Mapping[str, float]) -> float:
    """Median of the POSITIVE rowgroup costs (0.0 when none — the uniform
    cold-start signal)."""
    values = sorted(v for v in totals.values() if v > 0.0)
    if not values:
        return 0.0
    return percentile(values, 0.5)


def _split_parts(normalized: float, num_rows: int, policy: SchedulePolicy,
                 max_parts: Optional[int] = None) -> int:
    """How many sub-ranges a rowgroup of ``normalized`` (median-relative)
    cost and ``num_rows`` rows splits into; < 2 means "do not split".
    ``max_parts`` caps at the consuming pool's worker count: each sub-range
    re-pays the Parquet rowgroup read, so parts beyond the available
    parallelism are pure overhead."""
    if not policy.split or normalized < policy.split_threshold:
        return 1
    by_cost = int(math.ceil(normalized / policy.split_threshold)) + 1
    by_rows = num_rows // max(1, policy.min_split_rows)
    parts = min(policy.split_max, by_cost, by_rows)
    if max_parts is not None:
        parts = min(parts, max_parts)
    return max(1, parts)


def _sub_ranges(num_rows: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous, exhaustive, near-equal ``(start_row, stop_row)`` ranges."""
    bounds = [(i * num_rows) // parts for i in range(parts + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(parts)]


def _interleave_order(entries: List[Tuple[Any, float]], heavy_skew: float,
                      prestage: bool) -> List[Any]:
    """Deterministic cost-balanced interleave of ``(item, normalized_cost)``
    pairs: heavies (cost >= ``heavy_skew``) are spread at evenly spaced
    positions — with ``prestage`` each heavy takes the EARLIEST slot of its
    window, so the heaviest rowgroup of the epoch ventilates first — and the
    lights fill the gaps in their incoming (already seeded-shuffled) order."""
    n = len(entries)
    heavy_positions = [i for i, (_item, cost) in enumerate(entries)
                       if cost >= heavy_skew]
    k = len(heavy_positions)
    if k == 0 or k == n:
        return [item for item, _cost in entries]
    # heaviest first: ties broken by incoming position so the order is a
    # pure function of (ledger, seed)
    heavies = sorted((entries[i] for i in heavy_positions),
                     key=lambda pair: -pair[1])
    heavy_set = set(heavy_positions)
    lights = [entries[i][0] for i in range(n) if i not in heavy_set]
    if prestage:
        slots = [(i * n) // k for i in range(k)]
    else:
        slots = [((2 * i + 1) * n) // (2 * k) for i in range(k)]
    out: List[Any] = [None] * n
    for slot, (item, _cost) in zip(slots, heavies):
        out[slot] = item
    light_iter = iter(lights)
    for j in range(n):
        if out[j] is None:
            out[j] = next(light_iter)
    return out


class CostAwareScheduler(object):
    """One reader's cost-aware schedule: frozen at construction from the
    persisted ledger (module docstring), fed live observations for the NEXT
    run, and consulted by the ventilator (order), the work-item planner
    (splits) and the service client (cost hints).

    Thread model: the plan (``_piece_costs``, splits, locator) is built once
    on the constructing thread before the ventilator starts; afterwards the
    ventilator thread calls :meth:`order_items`, the consumer thread calls
    :meth:`observe`, and the autotune controller may flip
    :meth:`set_interleave` — the small mutable surface is lock-guarded."""

    def __init__(self, dataset_token: str, policy: SchedulePolicy,
                 ledger: Optional[CostLedger] = None,
                 ledger_path: Optional[str] = None) -> None:
        self.dataset_token = dataset_token
        self.policy = policy
        self.ledger_path = policy.ledger_path or ledger_path
        self._lock = threading.Lock()
        self._interleave = policy.interleave
        self._stage_costs: Dict[str, Dict[str, float]] = (
            _ledger_costs(ledger) if ledger is not None else {})
        totals = {key: sum(stages.values())
                  for key, stages in self._stage_costs.items()}
        #: 0.0 median == cold start: every plan below degrades to a no-op
        self._median = _median_cost(totals)
        self._totals = totals
        #: normalized (median-relative) cost per ventilated piece index,
        #: split-adjusted — filled by :meth:`plan_items`
        self._piece_costs: Dict[int, float] = {}
        #: piece index -> (fragment_path, row_group_id) incl. virtual pieces
        self._locator: Dict[int, Tuple[str, Any]] = {}
        self._splits: List[Dict[str, Any]] = []
        #: live per-rowgroup per-stage observations (consumer sidecars)
        self._live: Dict[str, Dict[str, List[float]]] = {}
        self._observed = 0
        self._orders: List[List[int]] = []
        self._epochs_planned = 0
        #: whether the consuming reader re-invokes :meth:`order_items` each
        #: epoch (shuffling readers do; a static-order reader calls it once
        #: at construction) — the ``schedule_interleave`` autotune knob is
        #: only registered when True, else the controller would hill-climb a
        #: toggle nothing ever reads again
        self.live_reorder = False

    # -------------------------------------------------------------- costs

    @staticmethod
    def rowgroup_key(fragment_path: str, row_group_id: Any) -> str:
        """The ledger's rowgroup key for one fragment/rowgroup pair."""
        return CostLedger._rowgroup_key(fragment_path, row_group_id)

    def normalized_cost(self, key: str) -> float:
        """Median-relative cost of one rowgroup: 1.0 when unknown or on a
        cold (empty/uniform) ledger."""
        if self._median <= 0.0:
            return 1.0
        total = self._totals.get(key, 0.0)
        if total <= 0.0:
            return 1.0
        return total / self._median

    def cost_hint_for(self, item_kwargs: Mapping[str, Any]) -> float:
        """The service submit's measured-cost hint for one ventilated work
        item (clamped to ``[MIN_COST_HINT, MAX_COST_HINT]`` so a pathological
        ledger entry cannot monopolize or starve the DRR budget)."""
        piece = item_kwargs.get('piece_index')
        cost = 1.0
        if piece is not None:
            cost = self._piece_costs.get(int(piece), 1.0)
        return max(MIN_COST_HINT, min(MAX_COST_HINT, cost))

    # --------------------------------------------------------------- plan

    def plan_items(self, items: List[Dict[str, Any]],
                   locator: Mapping[int, Tuple[str, Any, int]],
                   allow_split: bool = True,
                   max_parts: Optional[int] = None
                   ) -> Tuple[List[Dict[str, Any]],
                              Dict[int, Tuple[str, Any]]]:
        """Apply the split plan to the reader's work-item list.

        ``locator`` maps each piece index to ``(fragment_path, row_group_id,
        num_rows)``. A rowgroup whose measured cost crosses
        ``split_threshold x median`` is replaced by up to ``split_max``
        sub-range items: the first keeps the original piece index (so its
        trace context and cost-ledger attribution stay anchored), the rest
        get fresh *virtual* piece indexes and every one carries a
        ``row_range=(start_row, stop_row)`` kwarg into
        ``reader_worker.process``. ``max_parts`` caps parts per rowgroup at
        the consuming pool's worker count (sub-ranges re-pay the rowgroup
        read — parts beyond the parallelism are overhead). Returns
        ``(planned_items, virtual_locator)`` where ``virtual_locator`` maps
        the virtual pieces back to their rowgroup for cost attribution. With
        a cold ledger (or ``allow_split=False`` — the NGram path, whose
        windows span rows) the items pass through untouched."""
        self._locator = {piece: (frag, rg_id)
                         for piece, (frag, rg_id, _rows) in locator.items()}
        pieces = sorted({int(item['piece_index']) for item in items})
        # per-piece normalized costs (split-adjusted below)
        for piece in pieces:
            located = locator.get(piece)
            if located is None:
                self._piece_costs[piece] = 1.0
                continue
            key = self.rowgroup_key(located[0], located[1])
            self._piece_costs[piece] = self.normalized_cost(key)
        if self._median <= 0.0 or not allow_split or not self.policy.split:
            return list(items), {}
        next_piece = (pieces[-1] + 1) if pieces else 0
        decisions: Dict[int, Tuple[List[int], List[Tuple[int, int]]]] = {}
        extra_locator: Dict[int, Tuple[str, Any]] = {}
        for piece in pieces:
            located = locator.get(piece)
            if located is None:
                continue
            fragment_path, row_group_id, num_rows = located
            cost = self._piece_costs[piece]
            parts = _split_parts(cost, int(num_rows), self.policy, max_parts)
            if parts < 2:
                continue
            ranges = _sub_ranges(int(num_rows), parts)
            piece_ids = [piece] + list(range(next_piece,
                                             next_piece + parts - 1))
            next_piece += parts - 1
            decisions[piece] = (piece_ids, ranges)
            key = self.rowgroup_key(fragment_path, row_group_id)
            self._splits.append({'piece_index': piece,
                                 'rowgroup': key,
                                 'parts': parts,
                                 'rows': int(num_rows),
                                 'normalized_cost': round(cost, 3)})
            # Sub-pieces keep HEAVY status (cost floored at heavy_skew): they
            # exist because their rowgroup crossed the split threshold, and
            # demoting a part below heavy_skew (e.g. a 4.5x rowgroup in 3
            # parts = 1.5x each) would silently drop it out of the
            # interleave/pre-stage/least-loaded-routing mechanisms that the
            # split was meant to feed.
            part_cost = max(cost / parts, self.policy.heavy_skew)
            for sub_piece in piece_ids:
                self._piece_costs[sub_piece] = part_cost
                self._locator[sub_piece] = (fragment_path, row_group_id)
                if sub_piece != piece:
                    extra_locator[sub_piece] = (fragment_path, row_group_id)
        if not decisions:
            return list(items), {}
        planned: List[Dict[str, Any]] = []
        for item in items:
            decision = decisions.get(int(item['piece_index']))
            if decision is None:
                planned.append(item)
                continue
            piece_ids, ranges = decision
            for sub_piece, row_range in zip(piece_ids, ranges):
                sub_item = dict(item)
                sub_item['piece_index'] = sub_piece
                sub_item['row_range'] = row_range
                planned.append(sub_item)
        return planned, extra_locator

    # -------------------------------------------------------------- order

    def order_items(self, items: List[Dict[str, Any]],
                    random_state: Any = None) -> List[Dict[str, Any]]:
        """One epoch's ventilation order: the seeded shuffle (when the
        reader shuffles rowgroups — ``random_state`` is the ventilator's RNG,
        consumed exactly as the plain path consumes it) followed by the
        deterministic cost-balanced interleave. Same seed + same ledger =>
        same order on every pool; cold ledger or ``interleave`` off => the
        shuffle alone, byte-identical to an unscheduled reader."""
        ordered = list(items)
        if random_state is not None:
            random_state.shuffle(ordered)
        with self._lock:
            interleave = self._interleave and self._median > 0.0
        if interleave and len(ordered) > 1:
            entries = [(item,
                        self._piece_costs.get(int(item['piece_index']), 1.0))
                       for item in ordered]
            ordered = _interleave_order(entries, self.policy.heavy_skew,
                                        self.policy.prestage)
        order_ids = [int(item['piece_index']) for item in ordered]
        with self._lock:
            self._epochs_planned += 1
            self._orders.append(order_ids)
            del self._orders[:-_ORDER_HISTORY]
            epoch = self._epochs_planned
        if trace_enabled():
            trace_instant('schedule_plan',
                          args={'epoch': epoch,
                                'items': len(ordered),
                                'interleaved': bool(interleave),
                                'splits': len(self._splits)})
        return ordered

    # ---------------------------------------------------- live observation

    def set_interleave(self, value: bool) -> bool:
        """Runtime toggle of the interleave half (the autotune
        ``schedule_interleave`` knob): takes effect at
        the next epoch reorder; split decisions are frozen at construction
        (they shaped the work-item list). Returns the applied value."""
        value = bool(value)
        with self._lock:
            self._interleave = value
        return value

    @property
    def interleave(self) -> bool:
        """Whether the cost-balanced interleave is currently applied."""
        with self._lock:
            return self._interleave

    @property
    def split_count(self) -> int:
        """How many rowgroups the plan split (frozen at construction)."""
        return len(self._splits)

    def plan_fingerprint(self) -> Dict[str, Any]:
        """The frozen plan as a JSON-safe reproduction record: everything a
        dry replay needs to re-derive this scheduler's epoch orders without
        the ledger file. A cost-ledger delta between two runs shows up as a
        difference here. A scheduled reader's :meth:`Reader.state_dict`
        carries it under ``schedule``."""
        with self._lock:
            interleave = self._interleave
        return {'cold_start': self._median <= 0.0,
                'interleave': interleave,
                'prestage': self.policy.prestage,
                'heavy_skew': self.policy.heavy_skew,
                'policy': self.policy.as_dict(),
                'piece_costs': {str(piece): round(cost, 6)
                                for piece, cost
                                in sorted(self._piece_costs.items())},
                'splits': [dict(row) for row in self._splits]}

    def piece_locator(self) -> Dict[int, Tuple[str, Any]]:
        """``{piece_index: (fragment_path, row_group_id)}`` covering every
        planned piece INCLUDING the virtual sub-range pieces — the one map
        the reader's cost-ledger attribution should use (a hand-merged copy
        would silently go stale when the plan changes)."""
        return dict(self._locator)

    def observe(self, piece_index: int,
                stage_times: Mapping[str, Mapping[str, Any]]) -> None:
        """Fold one consumed batch's telemetry sidecar (``{stage:
        histogram_snapshot}``) into the live ledger: the cold-start feed.
        Only ``COST_STAGES`` contribute; attribution rides the piece index
        through the plan's locator (virtual split pieces fold into their
        parent rowgroup). Never reorders the CURRENT run — determinism —
        but :meth:`persist` hands the knowledge to the next one."""
        located = self._locator.get(int(piece_index))
        if located is None:
            return
        key = self.rowgroup_key(located[0], located[1])
        observed = False
        with self._lock:
            for stage in COST_STAGES:
                cell = stage_times.get(stage)
                if not cell:
                    continue
                seconds = float(cell.get('sum', 0.0))
                count = int(cell.get('count', 0))
                if seconds <= 0.0 and count <= 0:
                    continue
                live = self._live.setdefault(key, {})
                # [count, sum_s, max_s] — max is the largest SINGLE span
                # (the sidecar histogram's own max), never the run total:
                # CostLedger.merge keeps max(max_s), so an inflated value
                # would poison the sidecar forever
                acc = live.setdefault(stage, [0.0, 0.0, 0.0])
                acc[0] += count
                acc[1] += seconds
                acc[2] = max(acc[2], float(cell.get('max', 0.0)))
                observed = True
            if observed:
                self._observed += 1

    def live_ledger(self) -> CostLedger:
        """The run's live observations (so far) as a :class:`CostLedger`
        (additive — merge it with the persisted one). Does not drain;
        :meth:`persist` does."""
        with self._lock:
            live = {key: {stage: list(acc) for stage, acc in stages.items()}
                    for key, stages in self._live.items()}
        return self._ledger_of(live)

    def _ledger_of(self, live: Dict[str, Dict[str, List[float]]]
                   ) -> CostLedger:
        ledger = CostLedger(self.dataset_token)
        for key, stages in live.items():
            entry = ledger._entry(key)
            for stage, (count, seconds, max_s) in stages.items():
                entry['stages'][stage] = {'count': int(count),
                                          'sum_s': float(seconds),
                                          'max_s': float(max_s)}
        return ledger

    def persist(self, path: Optional[str] = None) -> Optional[str]:
        """Merge the live observations into the persisted sidecar (additive,
        token-guarded) and save atomically; returns the path written, or
        None when there is nothing to write or nowhere to write it. DRAINS
        the observations it takes — ``Reader.stop`` may run more than once
        (``stop()`` + context-manager ``__exit__``), and a second persist
        must not double-merge the same run into the sidecar. Best-effort: a
        failed save logs and drops the batch (a read must never fail over
        its cost bookkeeping)."""
        path = path or self.ledger_path
        with self._lock:
            observed = self._observed
            if path is None or not observed:
                return None
            live, self._live = self._live, {}
            self._observed = 0
        ledger = self._ledger_of(live)
        try:
            previous, _resolved = load_ledger('', self.dataset_token,
                                              ledger_path=path)
            if previous is not None:
                ledger.merge(previous)
            ledger.save(path)
        except OSError as exc:
            logger.warning('could not persist cost ledger to %s: %s',
                           path, exc)
            return None
        return path

    # -------------------------------------------------------------- report

    def cost_skew(self) -> Optional[float]:
        """p95-over-median skew of the ledger's per-rowgroup costs (the JAX
        package's run records carry it); None on a cold start (no ledger,
        nothing to skew)."""
        totals = sorted(self._totals.values())
        if not totals or self._median <= 0.0:
            return None
        p95 = totals[min(len(totals) - 1,
                         int(round(0.95 * (len(totals) - 1))))]
        return p95 / self._median

    def report(self) -> Dict[str, Any]:
        """JSON-safe schedule view for ``Reader.diagnostics['schedule']``:
        the policy, ledger coverage, split decisions, heavy count, recent
        epoch orders (piece indexes) and the live-observation tally."""
        with self._lock:
            orders = [list(order) for order in self._orders]
            observed = self._observed
            interleave = self._interleave
        heavy = sorted(key for key, total in self._totals.items()
                       if self._median > 0.0
                       and total / self._median >= self.policy.heavy_skew)
        return {'enabled': True,
                'policy': self.policy.as_dict(),
                'interleave': interleave,
                'cold_start': self._median <= 0.0,
                'ledger_rowgroups': len(self._totals),
                'median_cost_s': round(self._median, 6),
                'heavy_rowgroups': heavy,
                'splits': [dict(row) for row in self._splits],
                'epoch_orders': orders,
                'live_observations': observed,
                'ledger_path': self.ledger_path}


def plan_preview(ledger: CostLedger,
                 policy: Optional[SchedulePolicy] = None) -> Dict[str, Any]:
    """The ``petastorm-tpu-throughput costs --json`` ``schedule_preview``
    block: what the cost-aware scheduler WOULD do with this ledger — planned
    interleave order (rowgroup keys, deterministic FIFO base so operators can
    diff previews across runs) and split decisions — without running an
    epoch. Splitting is previewed from cost alone (the planner additionally
    caps parts by the rowgroup's row count, which a ledger does not
    record)."""
    policy = policy or SchedulePolicy()
    stage_costs = _ledger_costs(ledger)
    totals = {key: sum(stages.values()) for key, stages in stage_costs.items()}
    median = _median_cost(totals)
    keys = sorted(totals)
    if median <= 0.0:
        return {'policy': policy.as_dict(), 'rowgroups': len(keys),
                'median_cost_s': 0.0, 'cold_start': True,
                'interleave_order': keys, 'heavy': [], 'splits': []}
    normalized = {key: (totals[key] / median if totals[key] > 0.0 else 1.0)
                  for key in keys}
    entries = [(key, normalized[key]) for key in keys]
    order = _interleave_order(entries, policy.heavy_skew, policy.prestage) \
        if policy.interleave and len(entries) > 1 else keys
    heavy = [key for key in keys if normalized[key] >= policy.heavy_skew]
    splits = []
    for key in keys:
        parts = _split_parts(normalized[key], 10 ** 9, policy)
        if parts >= 2:
            splits.append({'rowgroup': key, 'parts': parts,
                           'normalized_cost': round(normalized[key], 3),
                           'cost_s': round(totals[key], 6)})
    return {'policy': policy.as_dict(), 'rowgroups': len(keys),
            'median_cost_s': round(median, 6), 'cold_start': False,
            'interleave_order': order, 'heavy': heavy, 'splits': splits}
