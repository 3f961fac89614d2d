"""lock-discipline: no blocking calls while holding a lock.

The data plane's locks (``_state_lock`` in the process pool, the registry
shard locks, the loader accounting lock) guard *bookkeeping*, and the
comments around them promise short critical sections. A blocking call inside
``with lock:`` — a sleep, a socket receive, a thread join — turns every
other participant's fast path into that call's wait, and under the consumer/
ventilator thread split it is one step from deadlock.

Detection: a ``with`` item whose context expression's terminal name is
lock-ish (``lock``, ``*_lock``, ``*lock``) opens a critical section; inside
its body (not descending into nested ``def``/``lambda``) these calls are
findings:

- ``time.sleep(...)`` / bare ``sleep(...)``
- socket receives: ``.recv(...)``, ``.recv_multipart(...)``,
  ``.recv_string(...)``, ``.recv_pyobj(...)``, ``.recv_json(...)``,
  ``.accept(...)``
- thread/process joins: ``.join()`` with no arguments, a numeric-literal
  timeout, or a ``timeout=`` keyword (the argument heuristic is what keeps
  ``', '.join(parts)`` and ``os.path.join(a, b)`` out)
- ``subprocess.run/call/check_call/check_output(...)`` and ``input()``

**Interprocedural:** the same check now follows the call
graph — a call inside the critical section that resolves (confidently —
same module, ``self.method``, or project-unique name) to a function whose
transitive closure reaches a blocking call is flagged too, with the chain
spelled out (``_helper() -> _drain() -> time.sleep()``). A blocking call
two helpers deep inside a ``with lock:`` body is no longer invisible.

``Condition.wait`` is deliberately NOT flagged: condition variables must be
waited on with their lock held — that is their protocol, not a violation.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from petastorm_tpu_torch.analysis.callgraph import (blocking_call, get_callgraph,
                                                    terminal_name)
from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule,
                                               walk_skipping_functions)

_blocking_call = blocking_call
_terminal_name = terminal_name


def is_lockish(node: ast.expr) -> bool:
    """True when a ``with`` context expression names a lock (by the repo's
    naming convention: ``lock``, ``_lock``, ``state_lock``, ...)."""
    name = _terminal_name(node)
    if name is None:
        return False
    lowered = name.lower()
    return lowered == 'lock' or lowered.endswith('lock')


def _lock_names(node: ast.AST) -> List[str]:
    return [_terminal_name(item.context_expr) or 'lock'
            for item in getattr(node, 'items', [])
            if is_lockish(item.context_expr)]


class LockDisciplineRule(Rule):
    """Flag blocking calls inside ``with lock:`` bodies (module doc)."""

    name = 'lock-discipline'
    description = ('no sleep / blocking recv / join inside a "with lock:" '
                   'body — directly or through any resolvable helper chain; '
                   'critical sections must stay bookkeeping-short')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_names = _lock_names(node)
            if not lock_names:
                continue
            for inner in walk_skipping_functions(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                blocked = _blocking_call(inner)
                if blocked is not None:
                    findings.append(Finding(
                        self.name, module.display, inner.lineno,
                        'blocking call {} while holding {!r} — move it '
                        'outside the critical section (snapshot under the '
                        'lock, block outside)'.format(
                            blocked, lock_names[0])))
        return findings

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        """The interprocedural pass: calls under a lock that resolve to a
        transitively-blocking function."""
        graph = get_callgraph(ctx)
        findings: List[Finding] = []
        for info in graph.functions.values():
            for node in walk_skipping_functions(info.body()):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                lock_names = _lock_names(node)
                if not lock_names:
                    continue
                for inner in walk_skipping_functions(node.body):
                    if not isinstance(inner, ast.Call):
                        continue
                    if _blocking_call(inner) is not None:
                        continue  # direct — already flagged per-module
                    callee = graph.resolve_call(inner, info)
                    if callee is None or callee.key == info.key:
                        continue
                    chain = graph.blocking_chain(callee)
                    if chain is None:
                        continue
                    findings.append(Finding(
                        self.name, info.module.display, inner.lineno,
                        'call while holding {!r} blocks through its helper '
                        'chain: {} — snapshot under the lock, block '
                        'outside'.format(lock_names[0],
                                         ' -> '.join(chain))))
        return findings
