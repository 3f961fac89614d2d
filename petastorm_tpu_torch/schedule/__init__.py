"""Cost-aware sample scheduling (a copy of ``petastorm_tpu.schedule``):
consume the persisted per-rowgroup
:class:`~petastorm_tpu_torch.telemetry.cost_model.CostLedger` to interleave
heavy and light rowgroups deterministically, split oversized rowgroups into
sub-range work items and pre-stage predicted-slow items. Armed with
``make_reader(cost_schedule=...)``; off by default."""

from petastorm_tpu_torch.schedule.cost_schedule import (MAX_COST_HINT, MIN_COST_HINT,
                                                        CostAwareScheduler, SchedulePolicy,
                                                        load_ledger, plan_preview,
                                                        resolve_schedule_policy)

__all__ = ['CostAwareScheduler', 'SchedulePolicy', 'load_ledger',
           'plan_preview', 'resolve_schedule_policy', 'MIN_COST_HINT',
           'MAX_COST_HINT']
