"""exception-hygiene: broad excepts must justify themselves; data-path raises
must use the errors.py taxonomy.

Two sub-checks:

**Broad-except swallows.** A handler catching ``Exception`` /
``BaseException`` / everything (bare ``except:``) is judged by what its body
can do:

- if every path through the body re-raises, it is a translation/cleanup
  handler — fine; this is judged *interprocedurally*: a
  handler whose trailing statement calls a function that (transitively)
  always raises — a ``_fail()`` / ``_reraise_as()`` helper — counts as
  re-raising, via the call graph's raise closure;
- if it can *swallow* (complete without raising), it must either carry a
  trailing comment on the ``except`` line stating the reason (the house
  convention: ``except Exception:  # noqa: BLE001 - <why>``), or — outside
  worker modules — at least log (``logger.*`` / ``warnings.warn`` /
  ``traceback.print_exc``);
- inside worker/data-plane process modules (``workers/``) logging alone is
  not enough: a worker loop that eats an exception keeps publishing results
  from unknown state, so the reason must be written at the site.

**Raise taxonomy.** In the data-path modules (``config.DATAPATH_FILES`` and
everything under ``workers/``), ``raise Exception(...)`` /
``raise BaseException(...)`` are findings: generic raises carry zero
machine-readable structure, while the :mod:`petastorm_tpu_torch.errors` taxonomy
is what the retry classifier, quarantine ledger and doctor key on.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Sequence

from petastorm_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                    get_callgraph)
from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule,
                                               walk_skipping_functions)

_BROAD_NAMES = frozenset({'Exception', 'BaseException'})

#: bare tool markers that justify nothing by themselves — a reason must
#: follow (``# noqa: BLE001 - <why>``), or the comment must be actual prose
_MARKER_RE = re.compile(
    r'^(noqa(:\s*[A-Z0-9, ]+)?|type:\s*ignore(\[[^\]]*\])?'
    r'|pragma:\s*no\s*cover)\s*', re.IGNORECASE)
_LOG_ATTRS = frozenset({'debug', 'info', 'warning', 'error', 'exception',
                        'critical', 'log', 'warn', 'print_exc'})
_GENERIC_RAISES = frozenset({'Exception', 'BaseException'})


def _exception_names(type_node: ast.expr) -> List[str]:
    """Exception class names a handler catches (``Name``/``Attribute``
    terminals; tuples flattened)."""
    if isinstance(type_node, ast.Tuple):
        out: List[str] = []
        for element in type_node.elts:
            out.extend(_exception_names(element))
        return out
    if isinstance(type_node, ast.Name):
        return [type_node.id]
    if isinstance(type_node, ast.Attribute):
        return [type_node.attr]
    return []


def is_broad_handler(handler: ast.ExceptHandler) -> bool:
    """True for ``except:``, ``except Exception``, ``except BaseException``
    (including inside a tuple)."""
    if handler.type is None:
        return True
    return any(name in _BROAD_NAMES
               for name in _exception_names(handler.type))


def always_raises(stmts: Sequence[ast.stmt]) -> bool:
    """Conservatively true when every path through ``stmts`` ends in a
    ``raise`` — i.e. the handler translates/annotates, never swallows."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Raise):
        return True
    if isinstance(last, ast.If):
        return (bool(last.orelse) and always_raises(last.body)
                and always_raises(last.orelse))
    if isinstance(last, ast.With):
        return always_raises(last.body)
    return False


def comment_states_reason(comment: Optional[str]) -> bool:
    """True when a trailing comment actually *states a reason*: after
    stripping bare tool markers (``noqa``/``type: ignore``/``pragma: no
    cover``), at least two words of prose remain. ``# TODO`` or a lone
    ``# noqa: BLE001`` justify nothing."""
    if not comment:
        return False
    text = comment.lstrip('#').strip()
    text = _MARKER_RE.sub('', text).lstrip('-—:').strip()
    return len(text.split()) >= 2


def body_logs(stmts: Sequence[ast.stmt]) -> bool:
    """True when the handler body contains a logging/warning call."""
    for node in walk_skipping_functions(stmts):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _LOG_ATTRS):
            return True
    return False


class ExceptionHygieneRule(Rule):
    """Broad-except and raise-taxonomy checks (module doc)."""

    name = 'exception-hygiene'
    description = ('broad excepts that can swallow need a reason comment '
                   '(workers/) or at least logging (elsewhere); data-path '
                   'raises must use the errors.py taxonomy, not bare '
                   'Exception')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        in_workers = ('/' + ctx.config.worker_dir + '/') in module.posix()
        if in_workers or module.name in ctx.config.datapath_files:
            findings.extend(self._check_raises(module))
        return findings

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        """The broad-except pass runs here so the raise closure can accept
        handlers that delegate to an always-raising helper."""
        graph = get_callgraph(ctx)
        findings: List[Finding] = []
        for module in ctx.modules:
            in_workers = ('/' + ctx.config.worker_dir
                          + '/') in module.posix()
            enclosing = self._handler_owners(graph, module)
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if not is_broad_handler(node):
                    continue
                if (comment_states_reason(module.comments.get(node.lineno))
                        and node.lineno not in module.suppressions):
                    # reason documented at the site (house style); a bare
                    # marker or `# TODO` is not a reason, and a pipecheck
                    # directive instead flows through the framework's
                    # suppression accounting, so opt-outs stay countable
                    continue
                caller = enclosing.get(id(node)) or FunctionInfo(
                    module=module, node=module.tree, name='<module>',
                    qualname='<module>', class_name=None)
                if graph.stmts_always_raise(node.body, caller):
                    continue  # translation handler, never swallows
                if in_workers:
                    findings.append(Finding(
                        self.name, module.display, node.lineno,
                        'broad except can swallow in a worker module: '
                        'narrow the type, re-raise, or state the reason in '
                        'a trailing comment on this line'))
                elif not body_logs(node.body):
                    findings.append(Finding(
                        self.name, module.display, node.lineno,
                        'broad except swallows without logging or '
                        're-raise: narrow the type, log-and-continue, or '
                        'add a reason comment'))
        return findings

    @staticmethod
    def _handler_owners(graph: CallGraph, module: SourceModule
                        ) -> dict:
        """Map each except-handler (by ``id``) to its innermost enclosing
        function — the resolution scope for the raise closure (smallest
        line span wins, so a handler in a nested def resolves there)."""
        owners: dict = {}
        spans: dict = {}
        for info in graph.functions.values():
            if info.module is not module:
                continue
            start = int(getattr(info.node, 'lineno', 0))
            end = int(getattr(info.node, 'end_lineno', start) or start)
            span = end - start
            for inner in ast.walk(info.node):  # type: ignore[arg-type]
                if not isinstance(inner, ast.ExceptHandler):
                    continue
                key = id(inner)
                if key not in owners or span < spans[key]:
                    owners[key] = info
                    spans[key] = span
        return owners

    def _check_raises(self, module: SourceModule) -> List[Finding]:
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            raised = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                raised = exc.func.id
            elif isinstance(exc, ast.Name):
                raised = exc.id
            if raised in _GENERIC_RAISES:
                findings.append(Finding(
                    self.name, module.display, node.lineno,
                    'data-path code raises bare {} — raise a '
                    'petastorm_tpu_torch.errors type (or a specific builtin) so '
                    'the retry classifier and quarantine ledger can key on '
                    'it'.format(raised)))
        return findings
