"""clock-discipline: no direct wall-clock reads in clock-injected modules.

The resilience layer's contract is that every time-dependent decision
— backoff budgets, breaker cooldowns, deadlines — flows through an
*injectable* clock (``clock: Callable[[], float] = time.monotonic``), which
is what makes breaker transitions and retry schedules deterministic under
test. A direct ``time.time()`` / ``time.monotonic()`` / ``time.perf_counter()``
**call** inside such a module silently escapes the injected clock: tests
with a fake clock pass while production behavior differs.

References are fine — ``clock=time.monotonic`` as a default argument *is*
the discipline; only call sites are findings. The module set is configured
in :mod:`petastorm_tpu_torch.analysis.config` (``CLOCK_DISCIPLINED_FILES``,
default: ``resilience.py``).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule)

#: the ``time`` module functions that read a clock
_CLOCK_ATTRS = frozenset({'time', 'monotonic', 'perf_counter',
                          'time_ns', 'monotonic_ns', 'perf_counter_ns'})


class ClockDisciplineRule(Rule):
    """Flag direct clock calls in clock-disciplined modules (module doc)."""

    name = 'clock-discipline'
    description = ('no direct time.time()/time.monotonic()/'
                   'time.perf_counter() calls in injectable-clock modules '
                   '(resilience.py) — pass the clock in')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        if module.name not in ctx.config.clock_disciplined_files:
            return []
        from_time_imports: Set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.module == 'time':
                for alias in node.names:
                    if alias.name in _CLOCK_ATTRS:
                        from_time_imports.add(alias.asname or alias.name)
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            called = None
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == 'time'
                    and func.attr in _CLOCK_ATTRS):
                called = 'time.' + func.attr
            elif isinstance(func, ast.Name) and func.id in from_time_imports:
                called = func.id
            if called is not None:
                findings.append(Finding(
                    self.name, module.display, node.lineno,
                    'direct {}() call in a clock-disciplined module — route '
                    'it through the injected clock/sleep callable so tests '
                    'stay deterministic'.format(called)))
        return findings
