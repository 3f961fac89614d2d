"""journal-discipline: one rule for every append-only CRC-framed journal.

The tree now carries three durable frame journals — the dispatcher token
ledger (``service/ledger.py``), the topology membership journal
(``parallel/topology.py``) and the run historian (``telemetry/history.py``)
— and each is a wire protocol with the FUTURE: the process replaying a
journal may be a newer build than the one that wrote it. This rule checks
them all, data-driven over config ``JOURNAL_REGISTRIES``, and adds the two
write/read disciplines the chaos harness assumes:

- **closed record registry**: every literal record kind journaled through a
  writer call (``append_record('x')`` / ``_journal('x')`` /
  ``build_run_record('x')``) anywhere in the tree, and every ``kind ==
  'x'`` replay compare inside the journal module itself, must name an entry
  of the journal's declared registry tuple. Modules are routed to exactly
  one journal: a file matching a journal's own suffix checks against that
  journal's registry, everything else against the ledger's (callers of the
  other journals must go through their typed ``note_*`` wrappers). When the analyzed tree
  lacks the journal module (fixture trees), the registry is resolved from
  the installed module's source.
- **flush per append**: inside a journal module, any function that writes a
  frame (``.write(...)`` in a module that declares ``_FRAME_HEADER``) must
  also flush (``.flush()`` / ``os.fsync``) before returning — an appended
  frame that sits in userspace buffers is a frame the crash-replay contract
  silently never had.
- **counted drops on CRC mismatch**: in a journal module, an ``if`` branch
  testing a CRC condition that bails (``continue``/``break``/``return``)
  must account the drop (a ``drop``-named counter update or call) — a bare
  ``continue`` silently reads *past* corruption, which is exactly the
  "never guess" failure the chaos harness exists to prevent.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule, const_str,
                                               extract_string_tuple, parse_installed,
                                               walk_skipping_functions)


class _JournalSpec:
    """Normalized view over one ``JOURNAL_REGISTRIES`` config row."""

    def __init__(self, row: Tuple[str, str, Tuple[str, ...], str,
                                  str]) -> None:
        (self.suffix, self.registry_name, self.writer_calls,
         self.kind_label, self.import_name) = row

    def matches(self, module: SourceModule) -> bool:
        posix = module.posix()
        return posix.endswith('/' + self.suffix) or posix == self.suffix


def _journal_specs(ctx: AnalysisContext) -> List[_JournalSpec]:
    return [_JournalSpec(row) for row in ctx.config.journal_registries]


def _installed_registry(import_name: str,
                        registry_name: str) -> Optional[List[str]]:
    """Fallback registry parsed from the installed journal module's source
    (read, not imported), so fixture trees still validate against the
    shipped kind set."""
    installed = parse_installed(import_name)
    if installed is None:
        return None
    return extract_string_tuple(installed[0], registry_name)


class JournalDisciplineRule(Rule):
    """Registry / flush / drop-accounting checks for the frame journals
    (module doc)."""

    name = 'journal-discipline'
    description = ('append-only frame journals: record kinds must be '
                   'declared in the closed registry, every append must '
                   'flush, and CRC-mismatch drops must be counted — never '
                   'silently skipped')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        state = ctx.rule_state(self.name)
        specs = _journal_specs(ctx)
        owner = next((s for s in specs if s.matches(module)), None)
        if owner is not None:
            declared = extract_string_tuple(module.tree,
                                            owner.registry_name)
            if declared is not None:
                state.setdefault('declared', {})[owner.suffix] = declared
            self._collect_kind_compares(module, state, owner)
            self._collect_writer_literals(module, state, owner)
            findings.extend(self._check_flush_per_append(module))
            findings.extend(self._check_drop_accounting(module))
        else:
            # non-journal modules: writer-call literals route to the journal
            # whose writer name they use — build_run_record() to the
            # historian, append_record()/_journal() to the ledger (the
            # membership journal is only ever written through its typed
            # note_* wrappers)
            for spec in specs:
                if spec.suffix == 'topology.py':
                    continue
                self._collect_writer_literals(module, state, spec)
        return findings

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        state = ctx.rule_state(self.name)
        declared_map: Dict[str, List[str]] = state.get('declared', {})
        findings: List[Finding] = []
        for spec in _journal_specs(ctx):
            uses = state.get('uses:' + spec.suffix) or []
            if not uses:
                continue
            declared = declared_map.get(spec.suffix)
            if declared is None:
                declared = _installed_registry(spec.import_name,
                                               spec.registry_name)
            if declared is None:
                ctx.notes.append(
                    'journal-discipline: no {} registry found for {} — '
                    'kind conformance not checked'.format(
                        spec.registry_name, spec.suffix))
                continue
            for value, path, line in uses:
                if value not in declared:
                    findings.append(Finding(
                        self.name, path, line,
                        '{} {!r} is not declared in {} ({}) — a replayer '
                        'built from this registry will silently skip the '
                        'record and resume from wrong state'.format(
                            spec.kind_label, value, spec.registry_name,
                            tuple(declared))))
        return findings

    # ------------------------------------------------------------ registry

    def _collect_kind_compares(self, module: SourceModule,
                               state: Dict[str, object],
                               spec: _JournalSpec) -> None:
        uses = state.setdefault('uses:' + spec.suffix, [])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not all(isinstance(op, (ast.Eq, ast.NotEq))
                       for op in node.ops):
                continue
            sides = [node.left] + list(node.comparators)
            if not any(isinstance(side, ast.Name) and side.id == 'kind'
                       for side in sides):
                continue
            for side in sides:
                value = const_str(side)
                if value is not None:
                    uses.append((value, module.display,  # type: ignore[attr-defined]
                                 side.lineno))

    def _collect_writer_literals(self, module: SourceModule,
                                 state: Dict[str, object],
                                 spec: _JournalSpec) -> None:
        uses = state.setdefault('uses:' + spec.suffix, [])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            func_name: Optional[str] = None
            if isinstance(func, ast.Attribute):
                func_name = func.attr
            elif isinstance(func, ast.Name):
                func_name = func.id
            if func_name not in spec.writer_calls:
                continue
            if not node.args:
                continue
            value = const_str(node.args[0])
            if value is not None:
                uses.append((value, module.display,  # type: ignore[attr-defined]
                             node.args[0].lineno))

    # ----------------------------------------------------- write discipline

    @staticmethod
    def _declares_frame_header(module: SourceModule) -> bool:
        for node in module.tree.body:
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if (isinstance(target, ast.Name)
                            and target.id == '_FRAME_HEADER'):
                        return True
        return False

    def _check_flush_per_append(self,
                                module: SourceModule) -> List[Finding]:
        if not self._declares_frame_header(module):
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            writes: List[int] = []
            flushes = False
            for inner in walk_skipping_functions(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                if isinstance(inner.func, ast.Attribute):
                    if inner.func.attr == 'write':
                        writes.append(inner.lineno)
                    if inner.func.attr in ('flush', 'fsync'):
                        flushes = True
                elif (isinstance(inner.func, ast.Name)
                      and inner.func.id == 'fsync'):
                    flushes = True
            if writes and not flushes:
                findings.append(Finding(
                    self.name, module.display, writes[0],
                    'journal frame written in {}() without a flush/fsync '
                    'on the same path — a crash replays a journal this '
                    'append never durably joined'.format(node.name)))
        return findings

    # ------------------------------------------------------ drop accounting

    @staticmethod
    def _mentions(node: ast.AST, needle: str) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and needle in sub.id.lower():
                return True
            if isinstance(sub, ast.Attribute) and needle in sub.attr.lower():
                return True
        return False

    def _check_drop_accounting(self, module: SourceModule) -> List[Finding]:
        if not self._declares_frame_header(module):
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.If):
                continue
            if not self._mentions(node.test, 'crc'):
                continue
            bails = [inner for inner in walk_skipping_functions(node.body)
                     if isinstance(inner, (ast.Continue, ast.Break,
                                           ast.Return))]
            if not bails:
                continue
            accounted = any(self._mentions(inner, 'drop')
                            for inner in node.body)
            if not accounted:
                findings.append(Finding(
                    self.name, module.display, node.lineno,
                    'CRC-mismatch branch bails without counting the drop — '
                    'a bare continue/break reads past corruption silently; '
                    'increment the dropped-frame counter before bailing'))
        return findings
