"""pipecheck core: the AST analysis framework under the rule families (the
port of ``petastorm_tpu.analysis.core``).

This module is deliberately dependency-free (stdlib ``ast`` + ``tokenize``
only) and never *imports* the code it analyzes — every check is static, so
``pipecheck`` can run in environments where the data plane's optional
dependencies (zmq, pyarrow, torch) are absent, and a module with an import-time
bug can still be analyzed.

Building blocks:

- :class:`Finding` — one rule violation: ``(rule, path, line, message)``.
- :class:`SourceModule` — one parsed source file: text, AST, the per-line
  comment map (via ``tokenize``, so ``#`` inside string literals never counts),
  and the parsed :class:`Suppression` directives.
- :class:`Rule` — base class; rules implement :meth:`Rule.check_module` (per
  file) and optionally :meth:`Rule.finalize` (cross-file set matching, run
  after every file has been visited — the protocol-conformance shape).
- :func:`run_analysis` — collect files, parse, run rules, apply suppressions,
  return a :class:`Report`.

Suppression syntax (docs/static-analysis.md): a trailing comment

    # pipecheck: disable=<rule>[,<rule>...] -- <reason>

suppresses findings of the named rules **on that physical line** (for a
``try/except`` handler, the ``except`` line). The reason is mandatory: a
suppression without one is itself reported under the ``suppression-hygiene``
rule — an undocumented opt-out is exactly the silent drift this tool exists
to prevent. ``disable=all`` suppresses every rule on the line.
"""

from __future__ import annotations

import ast
import importlib.util
import io
import json
import re
import time
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: rule id for files the parser rejects (not suppressible — a file that cannot
#: be parsed cannot carry a suppression comment for its own syntax error)
PARSE_ERROR_RULE = 'parse-error'
#: rule id for malformed suppression directives (missing reason, unknown form)
SUPPRESSION_RULE = 'suppression-hygiene'

_SUPPRESSION_RE = re.compile(
    r'#\s*pipecheck:\s*disable=([A-Za-z0-9_,-]+)\s*(?:--\s*(\S.*))?')


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        """Human one-liner: ``path:line: [rule] message``."""
        return '{}:{}: [{}] {}'.format(self.path, self.line, self.rule,
                                       self.message)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe form for ``--json`` output."""
        return {'rule': self.rule, 'path': self.path, 'line': self.line,
                'message': self.message}


@dataclass
class Suppression:
    """A parsed ``# pipecheck: disable=...`` directive on one line."""

    line: int
    rules: Tuple[str, ...]
    reason: str


class SourceModule:
    """One parsed source file: raw text, AST, per-line comments, suppressions.

    ``display`` is the path rules report findings under (repo-relative when
    the file lives under the analyzed root, absolute otherwise); ``name`` is
    the basename, which codebase-specific rules use for role matching (a file
    named ``process_worker_main.py`` plays the worker-producer role wherever
    it lives — that is what lets fixture trees exercise the cross-file
    rules)."""

    def __init__(self, path: Path, display: str, text: str,
                 tree: ast.Module) -> None:
        self.path = path
        self.display = display
        self.text = text
        self.tree = tree
        self.name = path.name
        #: physical line -> full comment text (tokenize-accurate)
        self.comments: Dict[int, str] = {}
        #: physical line -> parsed suppression directive
        self.suppressions: Dict[int, Suppression] = {}
        self._index_comments()

    def posix(self) -> str:
        """The absolute path with ``/`` separators (for suffix matching)."""
        return self.path.as_posix()

    def _index_comments(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # ast.parse accepted the file, so this is a tokenizer corner case;
            # losing comments only costs suppression support for this file.
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            self.comments[tok.start[0]] = tok.string
            match = _SUPPRESSION_RE.search(tok.string)
            if match is not None:
                rules = tuple(r.strip() for r in match.group(1).split(',')
                              if r.strip())
                self.suppressions[tok.start[0]] = Suppression(
                    line=tok.start[0], rules=rules,
                    reason=(match.group(2) or '').strip())


class AnalysisContext:
    """Shared state for one :func:`run_analysis` pass.

    ``modules`` is every parsed file; ``state`` gives cross-file rules a
    private scratch dict (keyed by rule name) populated during
    :meth:`Rule.check_module` and consumed in :meth:`Rule.finalize`."""

    def __init__(self, config: Any, roots: Sequence[Path]) -> None:
        self.config = config
        self.roots: List[Path] = list(roots)
        self.modules: List[SourceModule] = []
        self.state: Dict[str, Any] = {}
        #: rule-appended caveats surfaced in Report.notes ("rule X did not
        #: run because ...") — a skipped check must never look like a passed
        #: one
        self.notes: List[str] = []

    def rule_state(self, rule_name: str) -> Dict[str, Any]:
        """The per-rule cross-file scratch dict (created on first use)."""
        return self.state.setdefault(rule_name, {})

    def find_module(self, posix_suffix: str) -> Optional[SourceModule]:
        """First analyzed module whose absolute posix path ends with
        ``posix_suffix`` (e.g. ``'telemetry/spans.py'``)."""
        for module in self.modules:
            if module.posix().endswith(posix_suffix):
                return module
        return None


class Rule:
    """Base class for pipecheck rules.

    Subclasses set ``name`` (the id used in findings and suppression
    comments) and ``description`` (one line for ``--list-rules`` and the
    docs), and override :meth:`check_module`; rules that need the whole file
    set (protocol conformance) accumulate into
    ``ctx.rule_state(self.name)`` and emit from :meth:`finalize`."""

    name = ''
    description = ''

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        """Per-file pass; yield :class:`Finding` objects."""
        return ()

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        """Cross-file pass, run once after every module was visited."""
        return ()


@dataclass
class Report:
    """The outcome of one analysis pass."""

    findings: List[Finding]
    suppressed: int
    files: int
    rules: List[str]
    notes: List[str] = field(default_factory=list)
    #: wall seconds each rule spent (check_module + finalize), for the
    #: ``--json`` CLI output and the smoke's timing line
    rule_seconds: Dict[str, float] = field(default_factory=dict)
    #: functions indexed by the shared call graph this pass (0 when no
    #: graph-backed rule ran)
    callgraph_functions: int = 0

    @property
    def clean(self) -> bool:
        """True when no finding survived suppression."""
        return not self.findings

    def by_rule(self) -> Dict[str, int]:
        """``{rule: finding_count}`` for summaries (doctor, smoke)."""
        counts: Dict[str, int] = {}
        for finding in self.findings:
            counts[finding.rule] = counts.get(finding.rule, 0) + 1
        return counts

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe form (the ``--json`` CLI output)."""
        return {'clean': self.clean,
                'finding_count': len(self.findings),
                'suppressed': self.suppressed,
                'files': self.files,
                'rules': list(self.rules),
                'by_rule': self.by_rule(),
                'rule_seconds': {rule: round(seconds, 4) for rule, seconds
                                 in sorted(self.rule_seconds.items())},
                'callgraph_functions': self.callgraph_functions,
                'findings': [f.as_dict() for f in self.findings],
                'notes': list(self.notes)}

    def to_json(self) -> str:
        """One JSON document (indent=2) of :meth:`as_dict`."""
        return json.dumps(self.as_dict(), indent=2, sort_keys=True)

    def format_human(self) -> str:
        """Flake8-style listing plus a one-line verdict (and any notes)."""
        lines = [finding.format() for finding in self.findings]
        lines.extend('pipecheck: note: ' + note for note in self.notes)
        if self.clean:
            lines.append('pipecheck: clean — {} file(s), {} rule(s), {} '
                         'suppression(s) honored'.format(
                             self.files, len(self.rules), self.suppressed))
        else:
            lines.append('pipecheck: {} finding(s) ({} suppressed) across {} '
                         'file(s)'.format(len(self.findings), self.suppressed,
                                          self.files))
        return '\n'.join(lines)


def iter_python_files(paths: Sequence[Path]) -> Iterator[Path]:
    """Expand files/directories into the ``.py`` files to analyze (sorted;
    ``__pycache__`` and dot-directories *below the analyzed root* skipped —
    the root itself may live under one, e.g. a ``.venv`` site-packages
    install)."""
    seen = set()
    for path in paths:
        if path.is_file():
            candidates: Iterable[Tuple[Path, Tuple[str, ...]]] = [(path, ())]
        else:
            candidates = ((c, c.relative_to(path).parts)
                          for c in sorted(path.rglob('*.py')))
        for candidate, rel_parts in candidates:
            if '__pycache__' in rel_parts or any(
                    part.startswith('.') for part in rel_parts):
                continue
            resolved = candidate.resolve()
            if resolved in seen:
                continue
            seen.add(resolved)
            yield candidate


def load_module(path: Path, root: Optional[Path] = None
                ) -> Tuple[Optional[SourceModule], Optional[Finding]]:
    """Read + parse one file. Returns ``(module, None)`` or, when the file
    cannot be read/parsed, ``(None, parse_error_finding)``."""
    display = _display_path(path, root)
    try:
        text = path.read_text(encoding='utf-8')
        tree = ast.parse(text, filename=str(path))
    except (OSError, SyntaxError, ValueError) as exc:
        line = getattr(exc, 'lineno', None) or 1
        return None, Finding(PARSE_ERROR_RULE, display, int(line),
                             'cannot analyze: {!r}'.format(exc))
    return SourceModule(path, display, text, tree), None


def _display_path(path: Path, root: Optional[Path]) -> str:
    if root is not None:
        base = root if root.is_dir() else root.parent
        try:
            return (Path(base.name) / path.relative_to(base)).as_posix() \
                if base.name else path.relative_to(base).as_posix()
        except ValueError:
            pass
    return path.as_posix()


def run_analysis(paths: Sequence[Path], rules: Sequence[Rule],
                 config: Any) -> Report:
    """Run ``rules`` over every Python file under ``paths``.

    Suppression is applied here, uniformly: a finding whose ``line`` carries a
    ``# pipecheck: disable=`` directive naming its rule (or ``all``) is
    dropped and counted in :attr:`Report.suppressed`; directives without a
    reason surface as :data:`SUPPRESSION_RULE` findings."""
    ctx = AnalysisContext(config, [Path(p) for p in paths])
    raw: List[Finding] = []
    parse_errors: List[Finding] = []
    files = 0
    by_display: Dict[str, SourceModule] = {}
    for file_path in iter_python_files(ctx.roots):
        root = _owning_root(file_path, ctx.roots)
        module, error = load_module(file_path, root)
        files += 1
        if error is not None:
            parse_errors.append(error)
            continue
        assert module is not None
        ctx.modules.append(module)
        by_display[module.display] = module
    rule_seconds: Dict[str, float] = {rule.name: 0.0 for rule in rules}
    for module in ctx.modules:
        for rule in rules:
            started = time.perf_counter()
            raw.extend(rule.check_module(module, ctx))
            rule_seconds[rule.name] += time.perf_counter() - started
    for rule in rules:
        started = time.perf_counter()
        raw.extend(rule.finalize(ctx))
        rule_seconds[rule.name] += time.perf_counter() - started

    findings: List[Finding] = list(parse_errors)
    suppressed = 0
    for finding in raw:
        module = by_display.get(finding.path)
        directive = (module.suppressions.get(finding.line)
                     if module is not None else None)
        if directive is not None and (
                finding.rule in directive.rules or 'all' in directive.rules):
            suppressed += 1
            continue
        findings.append(finding)
    for module in ctx.modules:
        for directive in module.suppressions.values():
            if not directive.reason:
                findings.append(Finding(
                    SUPPRESSION_RULE, module.display, directive.line,
                    'suppression without a reason: append " -- <why this is '
                    'safe>" (docs/static-analysis.md)'))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    # duck-typed so core never imports callgraph (rules own that layer):
    # whatever the graph-backed rules cached under their shared state key
    # reports its function count here
    graph = ctx.state.get('__callgraph__')
    graph_functions = len(getattr(graph, 'functions', ()) or ())
    return Report(findings=findings, suppressed=suppressed, files=files,
                  rules=[rule.name for rule in rules], notes=list(ctx.notes),
                  rule_seconds=rule_seconds,
                  callgraph_functions=graph_functions)


def _owning_root(path: Path, roots: Sequence[Path]) -> Optional[Path]:
    resolved = path.resolve()
    for root in roots:
        base = root.resolve()
        if resolved == base or base in resolved.parents:
            return root
    return None


# --------------------------------------------------------------------------
# Small AST helpers shared by the rule families
# --------------------------------------------------------------------------

def const_str(node: ast.AST) -> Optional[str]:
    """The value of a ``str`` constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def const_bytes(node: ast.AST) -> Optional[bytes]:
    """The value of a ``bytes`` constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, bytes):
        return node.value
    return None


def literal_str_values(node: ast.AST) -> List[Tuple[str, int]]:
    """String literals an argument expression can evaluate to, with lines:
    a plain constant yields one, a conditional expression
    (``'a' if c else 'b'``) yields both branches — the shape
    ``record_stage('cache_hit' if hit else 'cache_miss', ...)`` takes."""
    value = const_str(node)
    if value is not None:
        return [(value, node.lineno)]
    if isinstance(node, ast.IfExp):
        return literal_str_values(node.body) + literal_str_values(node.orelse)
    return []


def extract_string_tuple(tree: ast.Module, name: str) -> Optional[List[str]]:
    """The string elements of a module-level ``NAME = ('a', 'b', ...)``
    assignment (tuple or list; ``AnnAssign`` accepted). None when ``name``
    is not assigned a literal sequence in ``tree``."""
    for node in tree.body:
        target: Optional[ast.expr] = None
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        if not (isinstance(target, ast.Name) and target.id == name):
            continue
        if isinstance(value, (ast.Tuple, ast.List)):
            out = []
            for element in value.elts:
                text = const_str(element)
                if text is None:
                    return None
                out.append(text)
            return out
    return None


def module_bytes_constants(tree: ast.Module) -> Dict[str, bytes]:
    """Module-level ``NAME = b'...'`` bindings, including tuple unpacking
    (``A, B = b'a', b'b'``): the ``MSG_*`` convention of a ZMQ pool's message
    kinds."""
    out: Dict[str, bytes] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                value = const_bytes(node.value)
                if value is not None:
                    out[target.id] = value
            elif (isinstance(target, ast.Tuple)
                  and isinstance(node.value, ast.Tuple)
                  and len(target.elts) == len(node.value.elts)):
                for sub_target, sub_value in zip(target.elts, node.value.elts):
                    if isinstance(sub_target, ast.Name):
                        value = const_bytes(sub_value)
                        if value is not None:
                            out[sub_target.id] = value
    return out


def installed_source(module_name: str) -> Optional[Path]:
    """The source file of the installed module ``module_name``, found
    without importing it or its packages' ``__init__`` (only the top-level
    package is looked up): the catalog and registry fallbacks read a
    module's declarations, never run it. None when it is not installed."""
    top, _, rest = module_name.partition('.')
    try:
        spec = importlib.util.find_spec(top)
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.submodule_search_locations:
        return None
    for location in spec.submodule_search_locations:
        base = Path(location).joinpath(*rest.split('.')) if rest else Path(location)
        for candidate in (base.parent / (base.name + '.py'), base / '__init__.py'):
            if candidate.is_file():
                return candidate
    return None


def parse_installed(module_name: str) -> Optional[Tuple[ast.Module, str]]:
    """``(tree, path)`` of :func:`installed_source`, or None when the module
    is missing or does not parse."""
    path = installed_source(module_name)
    if path is None:
        return None
    try:
        return ast.parse(path.read_text(encoding='utf-8')), str(path)
    except (OSError, SyntaxError, ValueError):
        return None


def walk_skipping_functions(stmts: Sequence[ast.stmt]) -> Iterator[ast.AST]:
    """Yield every node under ``stmts`` without descending into nested
    function/class definitions or lambdas — 'the statements that execute in
    this scope', which is what the lock- and exception-body checks mean."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)
