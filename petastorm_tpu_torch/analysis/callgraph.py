"""pipecheck call graph: the whole-program layer under the v2 rule families.

Pipecheck v1 rules were per-file set matchers; the failure classes that
actually shipped — the ``/dev/shm`` segment leak, blocking calls reached
through a helper inside a ``with lock:`` body, resources handed to an owner
object that never releases them — all cross function (and file) boundaries.
This module builds, once per analysis pass, a project-wide index of every
function/method definition plus three per-function summary layers:

- **call resolution** (:meth:`CallGraph.resolve_call`): a call site resolves
  to its definition by confidence tiers — same-module function, ``self.m()``
  method of the enclosing class, then a *dynamic-dispatch fallback to
  name-match* that only fires when exactly one definition of that name
  exists project-wide (an ambiguous name resolves to nothing rather than to
  a guess; ``obj.close()`` with forty ``close`` definitions is never
  followed).
- **blocking closure** (:meth:`CallGraph.blocking_chain`): does calling this
  function (transitively, through resolvable edges) reach a blocking call —
  ``time.sleep``, a socket ``recv``, a ``join``? Cycle-safe memoized DFS;
  the chain is reported so a finding can say *how* the lock body blocks.
- **raise closure** (:meth:`CallGraph.always_raises_transitively`): does
  every path through this function end in a ``raise`` — directly, or by
  tail-calling a function that does? Lets exception-hygiene accept
  translation handlers that delegate to a ``_fail()`` helper.
- **resource summaries** (:class:`FunctionSummary` via
  :func:`build_summaries`): which leakable resources (config
  ``LEAKABLE_TYPES``) a function acquires, whether each acquisition reaches
  a release on all paths (exception paths included), escapes to a caller
  (returned / stored on ``self`` / handed to another call), or leaks. A
  function that acquires-and-returns is itself an acquisition site for its
  callers (``returns_spec``), which is how a leak through a helper factory
  stays visible.

Binding discipline (the v2 rebinding bugfix): the summary scanner tracks
resources by local-variable binding and **kills the tracked binding on
reassignment or ``del``** — after ``seg = SharedMemory(...)`` followed by
``seg = SharedMemory(...)``, a later ``seg.close()`` releases only the
second object; the first is reported leaked at the rebind site instead of
being silently credited with the close.

Everything here is still stdlib-``ast`` static analysis: the graph is an
approximation (no aliasing, no higher-order flow), tuned so that every
finding built on it points at a concrete call chain a reader can follow.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from petastorm_tpu_torch.analysis.core import (AnalysisContext, SourceModule,
                                               walk_skipping_functions)

#: key under ``AnalysisContext.state`` where the shared graph is cached so
#: every graph-backed rule (and the final Report) sees one build per pass
CALLGRAPH_STATE_KEY = '__callgraph__'

_RECV_ATTRS = frozenset({'recv', 'recv_multipart', 'recv_string',
                         'recv_pyobj', 'recv_json', 'accept'})
_SUBPROCESS_FUNCS = frozenset({'run', 'call', 'check_call', 'check_output'})

#: calls treated as non-raising when deciding whether an exception can fire
#: between an acquire and its release (precision heuristic: these are the
#: bookkeeping builtins that sit between ``acquire()`` and ``close()`` in
#: straight-line code)
_SAFE_CALLS = frozenset({'len', 'max', 'min', 'abs', 'int', 'float', 'str',
                         'bool', 'repr', 'format', 'id', 'hash', 'getattr',
                         'isinstance', 'issubclass', 'tuple', 'list', 'dict',
                         'set', 'frozenset', 'range', 'enumerate', 'zip',
                         'sorted', 'monotonic', 'perf_counter', 'time',
                         'append', 'startswith', 'endswith'})


def terminal_name(node: ast.expr) -> Optional[str]:
    """The rightmost identifier of a ``Name``/``Attribute`` expression
    (``zmq.Context`` -> ``'Context'``), else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _self_attr_name(node: ast.expr) -> Optional[str]:
    """``'x'`` for a plain ``self.x`` expression, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == 'self'):
        return node.attr
    return None


def blocking_call(node: ast.Call) -> Optional[str]:
    """A human-readable description when ``node`` is a *directly* blocking
    call (sleep / socket recv / subprocess / unbounded-or-timed join /
    input). ``Condition.wait`` is deliberately not blocking here: waiting
    with the lock held is the condition-variable protocol."""
    func = node.func
    if isinstance(func, ast.Name):
        if func.id == 'sleep':
            return 'sleep()'
        if func.id == 'input':
            return 'input()'
        return None
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == 'sleep':
        return '{}.sleep()'.format(terminal_name(func.value) or '?')
    if func.attr in _RECV_ATTRS:
        return '.{}()'.format(func.attr)
    if (func.attr in _SUBPROCESS_FUNCS
            and isinstance(func.value, ast.Name)
            and func.value.id == 'subprocess'):
        return 'subprocess.{}()'.format(func.attr)
    if func.attr == 'join':
        if not node.args and not node.keywords:
            return '.join()'
        if any(kw.arg == 'timeout' for kw in node.keywords):
            return '.join(timeout=...)'
        if (len(node.args) == 1 and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, (int, float))):
            return '.join({})'.format(node.args[0].value)
    return None


@dataclass
class FunctionInfo:
    """One function/method definition in the analyzed tree."""

    module: SourceModule
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    name: str
    qualname: str  # 'Class.method' or 'function'
    class_name: Optional[str]

    @property
    def key(self) -> str:
        """Globally unique id: ``<display>::<qualname>``."""
        return '{}::{}'.format(self.module.display, self.qualname)

    @property
    def line(self) -> int:
        return int(getattr(self.node, 'lineno', 1))

    def body(self) -> Sequence[ast.stmt]:
        return list(getattr(self.node, 'body', []))


class CallGraph:
    """Project-wide function index + resolution + transitive closures."""

    def __init__(self) -> None:
        self.functions: Dict[str, FunctionInfo] = {}
        self._module_level: Dict[Tuple[str, str], FunctionInfo] = {}
        self._methods: Dict[Tuple[str, str, str], FunctionInfo] = {}
        self._by_bare_name: Dict[str, List[FunctionInfo]] = {}
        #: (display, class name) -> attribute names some method releases
        #: (``self._x.close()`` / ``del self._x``) — the escape-to-owner check
        self._class_released_attrs: Dict[Tuple[str, str], Set[str]] = {}
        self._blocking_memo: Dict[str, Optional[List[str]]] = {}
        self._raises_memo: Dict[str, bool] = {}

    # ------------------------------------------------------------- building

    @classmethod
    def build(cls, modules: Sequence[SourceModule]) -> 'CallGraph':
        graph = cls()
        for module in modules:
            graph._index_module(module)
        return graph

    def _index_module(self, module: SourceModule) -> None:
        release_attr_re = ('close', 'unlink', 'join', 'cleanup', 'term',
                           'destroy', 'stop', 'release', 'shutdown',
                           'close_and_unlink', 'terminate', 'abandon')

        def visit(node: ast.AST, class_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = ('{}.{}'.format(class_name, child.name)
                            if class_name else child.name)
                    info = FunctionInfo(module=module, node=child,
                                        name=child.name, qualname=qual,
                                        class_name=class_name)
                    if info.key not in self.functions:
                        self.functions[info.key] = info
                        self._by_bare_name.setdefault(child.name,
                                                      []).append(info)
                        if class_name is None:
                            self._module_level.setdefault(
                                (module.display, child.name), info)
                        else:
                            self._methods.setdefault(
                                (module.display, class_name, child.name),
                                info)
                            self._note_released_attrs(
                                module, class_name, child, release_attr_re)
                    # nested defs are indexed too (closures can block/raise)
                    visit(child, class_name)
                else:
                    visit(child, class_name)

        visit(module.tree, None)

    def _note_released_attrs(self, module: SourceModule, class_name: str,
                             func: ast.AST,
                             release_attrs: Tuple[str, ...]) -> None:
        released = self._class_released_attrs.setdefault(
            (module.display, class_name), set())
        # local aliases of self-attributes: `thread = self._thread` and
        # `for sock in (self._a, self._b):` — a release call on the alias
        # releases every attribute it may name
        aliases: Dict[str, Set[str]] = {}
        for node in ast.walk(func):
            if isinstance(node, ast.Assign):
                attr = _self_attr_name(node.value)
                if attr is not None:
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            aliases.setdefault(target.id, set()).add(attr)
            elif (isinstance(node, (ast.For, ast.AsyncFor))
                    and isinstance(node.target, ast.Name)
                    and isinstance(node.iter, (ast.Tuple, ast.List))):
                for element in node.iter.elts:
                    attr = _self_attr_name(element)
                    if attr is not None:
                        aliases.setdefault(node.target.id, set()).add(attr)
        for node in ast.walk(func):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in release_attrs):
                attr = _self_attr_name(node.func.value)
                if attr is not None:
                    released.add(attr)
                elif isinstance(node.func.value, ast.Name):
                    released.update(aliases.get(node.func.value.id, ()))
            if isinstance(node, ast.Delete):
                for target in node.targets:
                    if (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == 'self'):
                        released.add(target.attr)
            # handing the attribute to another call (e.g. a shutdown helper,
            # `_drain(self._ring)`) also counts as the owner taking care of it
            if isinstance(node, ast.Call):
                for arg in node.args:
                    if (isinstance(arg, ast.Attribute)
                            and isinstance(arg.value, ast.Name)
                            and arg.value.id == 'self'
                            and isinstance(node.func, (ast.Name,
                                                       ast.Attribute))
                            and (terminal_name(node.func) or '')
                            not in ('append', 'add', 'put', 'register')):
                        released.add(arg.attr)

    # ----------------------------------------------------------- resolution

    def owner_releases(self, module: SourceModule, class_name: str,
                       attr: str) -> bool:
        """True when some method of ``class_name`` (in ``module``) releases
        ``self.<attr>`` — close/join/stop/del or hands it to a helper."""
        return attr in self._class_released_attrs.get(
            (module.display, class_name), set())

    def resolve_call(self, call: ast.Call,
                     caller: FunctionInfo) -> Optional[FunctionInfo]:
        """The unique definition a call site reaches, or None.

        Tiers: same-module function for ``f()``; the enclosing class's
        method for ``self.m()``; then the dynamic-dispatch fallback — a bare
        or attribute name that has exactly ONE definition project-wide.
        Ambiguity resolves to None (never guess)."""
        func = call.func
        display = caller.module.display
        if isinstance(func, ast.Name):
            info = self._module_level.get((display, func.id))
            if info is not None:
                return info
            return self._unique_by_name(func.id, methods=False)
        if isinstance(func, ast.Attribute):
            if (isinstance(func.value, ast.Name) and func.value.id == 'self'
                    and caller.class_name is not None):
                info = self._methods.get(
                    (display, caller.class_name, func.attr))
                if info is not None:
                    return info
                return self._unique_by_name(func.attr, methods=True)
            return self._unique_by_name(func.attr, methods=True)
        return None

    def _unique_by_name(self, name: str,
                        methods: bool) -> Optional[FunctionInfo]:
        candidates = [info for info in self._by_bare_name.get(name, [])
                      if (info.class_name is not None) == methods]
        if len(candidates) == 1:
            return candidates[0]
        # name-match fallback across both namespaces when still unique
        everything = self._by_bare_name.get(name, [])
        if len(everything) == 1:
            return everything[0]
        return None

    # --------------------------------------------------- transitive closure

    def blocking_chain(self, info: FunctionInfo) -> Optional[List[str]]:
        """The call chain (``['helper()', 'time.sleep()']``) through which
        calling ``info`` reaches a blocking call, or None. Memoized,
        cycle-safe (a cycle with no blocking call resolves to None)."""
        return self._blocking_dfs(info, visiting=set())

    def _blocking_dfs(self, info: FunctionInfo,
                      visiting: Set[str]) -> Optional[List[str]]:
        if info.key in self._blocking_memo:
            return self._blocking_memo[info.key]
        if info.key in visiting:
            return None
        visiting.add(info.key)
        result: Optional[List[str]] = None
        for node in walk_skipping_functions(info.body()):
            if not isinstance(node, ast.Call):
                continue
            direct = blocking_call(node)
            if direct is not None:
                result = ['{}()'.format(info.qualname), direct]
                break
            callee = self.resolve_call(node, info)
            if callee is None or callee.key == info.key:
                continue
            sub = self._blocking_dfs(callee, visiting)
            if sub is not None:
                result = ['{}()'.format(info.qualname)] + sub
                break
        visiting.discard(info.key)
        self._blocking_memo[info.key] = result
        return result

    def always_raises_transitively(self, info: FunctionInfo) -> bool:
        """True when every path through ``info`` ends in a ``raise`` —
        directly, or by tail-calling a function that does."""
        return self._raises_dfs(info, visiting=set())

    def _raises_dfs(self, info: FunctionInfo, visiting: Set[str]) -> bool:
        if info.key in self._raises_memo:
            return self._raises_memo[info.key]
        if info.key in visiting:
            return False
        visiting.add(info.key)
        result = self._stmts_always_raise(list(info.body()), info, visiting)
        visiting.discard(info.key)
        self._raises_memo[info.key] = result
        return result

    def stmts_always_raise(self, stmts: Sequence[ast.stmt],
                           caller: FunctionInfo) -> bool:
        """Interprocedural ``always_raises`` over a statement list (e.g. an
        except-handler body): every path ends in a raise, where a trailing
        call to an always-raising function counts as raising."""
        return self._stmts_always_raise(stmts, caller, visiting=set())

    def _stmts_always_raise(self, stmts: Sequence[ast.stmt],
                            caller: FunctionInfo,
                            visiting: Set[str]) -> bool:
        if not stmts:
            return False
        last = stmts[-1]
        if isinstance(last, ast.Raise):
            return True
        if isinstance(last, ast.If):
            return (bool(last.orelse)
                    and self._stmts_always_raise(last.body, caller, visiting)
                    and self._stmts_always_raise(last.orelse, caller,
                                                 visiting))
        if isinstance(last, ast.With):
            return self._stmts_always_raise(last.body, caller, visiting)
        if isinstance(last, ast.Expr) and isinstance(last.value, ast.Call):
            callee = self.resolve_call(last.value, caller)
            if callee is not None:
                return self._raises_dfs(callee, visiting)
        return False


def get_callgraph(ctx: AnalysisContext) -> CallGraph:
    """The per-pass shared graph (built lazily on first rule access)."""
    graph = ctx.state.get(CALLGRAPH_STATE_KEY)
    if not isinstance(graph, CallGraph):
        graph = CallGraph.build(ctx.modules)
        ctx.state[CALLGRAPH_STATE_KEY] = graph
    return graph


# ---------------------------------------------------------------------------
# Resource lifecycle summaries
# ---------------------------------------------------------------------------

@dataclass
class Tracked:
    """One tracked acquisition inside one function."""

    binding: Optional[str]  # local variable name; None = value discarded
    spec_index: int  # index into config.leakable_types
    line: int
    released: bool = False
    release_in_finally: bool = False
    escaped: bool = False
    escaped_self_attr: Optional[str] = None
    returned: bool = False
    exempt: bool = False  # e.g. Thread(daemon=True)
    risk_line: Optional[int] = None  # first may-raise call before release
    killed_line: Optional[int] = None  # rebound / del'd before release


@dataclass
class FunctionSummary:
    """Per-function resource-lifecycle facts for the lifecycle rule."""

    info: FunctionInfo
    tracked: List[Tracked] = field(default_factory=list)
    #: spec index when the function acquires a resource and returns it —
    #: its call sites become acquisition sites for the caller
    returns_spec: Optional[int] = None


class _LeakSpecView:
    """Normalized view over one ``LEAKABLE_TYPES`` config row."""

    def __init__(self, row: Tuple[str, Tuple[str, ...], Tuple[str, ...],
                                  Tuple[str, ...], str, bool]) -> None:
        (self.constructor, self.releases, self.releaser_funcs,
         self.exempt_kwargs, self.label, self.paths_sensitive) = row


def _leak_specs(config: object) -> List[_LeakSpecView]:
    rows = getattr(config, 'leakable_types', ())
    return [_LeakSpecView(row) for row in rows]


_BROAD_EXC_NAMES = frozenset({'Exception', 'BaseException'})


def _broad_handler(handler: ast.ExceptHandler) -> bool:
    """``except:`` / ``except Exception`` / ``except BaseException`` — a
    handler wide enough that a release inside it covers (approximately)
    every exception path; a narrow ``except OSError:`` cleanup does NOT,
    which is exactly the leak class the paths-sensitive check exists for."""
    if handler.type is None:
        return True
    names = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    return any(terminal_name(name) in _BROAD_EXC_NAMES
               for name in names if isinstance(name, ast.expr))


def _iter_statements(body: Sequence[ast.stmt], in_finally: bool = False,
                     in_broad_handler: bool = False
                     ) -> Iterator[Tuple[ast.stmt, bool, bool]]:
    """Yield every statement in source order with two position flags:
    ``in_finally`` (a ``finally:`` block — a release here covers every
    path) and ``in_broad_handler`` (a *broad* except handler — a release
    here covers the exception paths but NOT the normal one). Never descends
    into nested function/class definitions."""
    for stmt in body:
        yield stmt, in_finally, in_broad_handler
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for fname, value in ast.iter_fields(stmt):
            if not isinstance(value, list):
                continue
            stmt_children = [item for item in value
                             if isinstance(item, ast.stmt)]
            if stmt_children:
                yield from _iter_statements(
                    stmt_children,
                    in_finally or (isinstance(stmt, ast.Try)
                                   and fname == 'finalbody'),
                    in_broad_handler)
            else:
                for item in value:
                    if isinstance(item, ast.ExceptHandler):
                        yield from _iter_statements(
                            item.body, in_finally,
                            in_broad_handler or _broad_handler(item))


def _name_used_in(node: ast.AST, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name:
            return True
    return False


def _match_constructor(call: ast.Call,
                       specs: List[_LeakSpecView]) -> Optional[int]:
    name = terminal_name(call.func)
    if name is None:
        return None
    for index, spec in enumerate(specs):
        if spec.constructor == name:
            return index
    return None


def _exempt_by_kwargs(call: ast.Call, spec: _LeakSpecView) -> bool:
    for kw in call.keywords:
        if (kw.arg in spec.exempt_kwargs
                and isinstance(kw.value, ast.Constant)
                and bool(kw.value.value)):
            return True
    return False


class _FunctionScanner:
    """Scan one function body, producing its :class:`FunctionSummary`.

    The scan is a linear, source-order walk: acquisitions open a tracked
    binding, releases/escapes close it, and an assignment or ``del`` of a
    tracked name *kills* the binding — later events on that name belong to
    the new object, never the old one (the rebinding bugfix)."""

    def __init__(self, info: FunctionInfo, specs: List[_LeakSpecView],
                 summaries: Dict[str, FunctionSummary],
                 graph: CallGraph) -> None:
        self.info = info
        self.specs = specs
        self.summaries = summaries
        self.graph = graph
        self.summary = FunctionSummary(info=info)
        self.active: Dict[str, Tracked] = {}
        # local aliases of tracked bindings: `s = sock` and the teardown
        # idiom `for sock in (a, b, c): sock.close()` — a release method on
        # the alias releases every binding it may name
        self.aliases: Dict[str, Set[str]] = {}

    # -- helpers ----------------------------------------------------------

    def _acquisition_spec(self, call: ast.Call) -> Optional[int]:
        direct = _match_constructor(call, self.specs)
        if direct is not None:
            return direct
        callee = self.graph.resolve_call(call, self.info)
        if callee is not None:
            callee_summary = self.summaries.get(callee.key)
            if callee_summary is not None:
                return callee_summary.returns_spec
        return None

    def _spec(self, tracked: Tracked) -> _LeakSpecView:
        return self.specs[tracked.spec_index]

    @staticmethod
    def _mark_release(tracked: Tracked, in_finally: bool,
                      in_broad: bool) -> None:
        """Record a release by position: a ``finally`` covers every path;
        a broad except handler covers the exception paths but NOT the
        normal one (deleting the straight-line release while keeping the
        cleanup handler is still a leak); anywhere else is the normal
        path."""
        if in_finally:
            tracked.released = True
            tracked.release_in_finally = True
        elif in_broad:
            tracked.release_in_finally = True
        else:
            tracked.released = True

    def _kill(self, name: str, line: int) -> None:
        tracked = self.active.pop(name, None)
        if tracked is None:
            return
        if not (tracked.released or tracked.escaped or tracked.exempt):
            tracked.killed_line = line
        self.summary.tracked.append(tracked)

    def _finish(self) -> FunctionSummary:
        for tracked in self.active.values():
            self.summary.tracked.append(tracked)
        self.active = {}
        for tracked in self.summary.tracked:
            if tracked.returned and self.summary.returns_spec is None:
                self.summary.returns_spec = tracked.spec_index
        return self.summary

    # -- the scan ---------------------------------------------------------

    def scan(self) -> FunctionSummary:
        for stmt, in_finally, in_broad in _iter_statements(
                self.info.body()):
            self._scan_statement(stmt, in_finally, in_broad)
        return self._finish()

    def _scan_statement(self, stmt: ast.stmt, in_finally: bool,
                        in_broad: bool = False) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._scan_with(stmt)
            return
        if isinstance(stmt, (ast.Return,)):
            if stmt.value is not None:
                self._scan_uses(stmt.value, in_finally, in_broad,
                                returning=True)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                if isinstance(target, ast.Name):
                    self._kill(target.id, stmt.lineno)
            return
        if isinstance(stmt, ast.Assign):
            self._scan_uses(stmt.value, in_finally, in_broad)
            for target in stmt.targets:
                self._scan_assign_target(target, stmt.value, stmt.lineno)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_uses(stmt.value, in_finally, in_broad)
            self._scan_assign_target(stmt.target, stmt.value, stmt.lineno)
            return
        if isinstance(stmt, ast.Expr):
            self._scan_uses(stmt.value, in_finally, in_broad)
            self._scan_discarded(stmt.value)
            return
        if (isinstance(stmt, (ast.For, ast.AsyncFor))
                and isinstance(stmt.target, ast.Name)
                and isinstance(stmt.iter, (ast.Tuple, ast.List))):
            names = {element.id for element in stmt.iter.elts
                     if isinstance(element, ast.Name)}
            if names & set(self.active):
                self.aliases.setdefault(stmt.target.id, set()).update(names)
                return
        # compound statements: only their own header expressions here
        # (bodies arrive as separate statements from _iter_statements)
        for fname, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                self._scan_uses(value, in_finally, in_broad)

    def _scan_with(self, stmt: ast.stmt) -> None:
        items = list(getattr(stmt, 'items', []))
        for item in items:
            expr = item.context_expr
            # `with x:` / `with closing(x):` releases x on every path
            inner = expr
            if (isinstance(inner, ast.Call)
                    and terminal_name(inner.func) == 'closing'
                    and inner.args):
                inner = inner.args[0]
            if isinstance(inner, ast.Name) and inner.id in self.active:
                tracked = self.active[inner.id]
                tracked.released = True
                tracked.release_in_finally = True
                continue
            if isinstance(expr, ast.Call):
                # `with SharedMemory(...) as x:` — context-managed from
                # birth; nothing to track
                if _match_constructor(expr, self.specs) is not None:
                    continue
                self._scan_uses(expr, in_finally=False)

    def _scan_assign_target(self, target: ast.expr, value: ast.expr,
                            line: int) -> None:
        spec_index: Optional[int] = None
        acquisition_call: Optional[ast.Call] = None
        if isinstance(value, ast.Call):
            spec_index = self._acquisition_spec(value)
            acquisition_call = value
        if isinstance(target, ast.Name):
            if isinstance(value, ast.Name) and value.id in self.active:
                # plain alias (`thread = self._thread` shape, local form):
                # a release through the alias credits the original binding
                self.aliases.setdefault(target.id, set()).add(value.id)
                return
            # reassignment kills the old binding first (bugfix: a later
            # `x.close()` must never be credited to the replaced object)
            self._kill(target.id, line)
            if spec_index is not None and acquisition_call is not None:
                tracked = Tracked(binding=target.id, spec_index=spec_index,
                                  line=line)
                if _exempt_by_kwargs(acquisition_call,
                                     self.specs[spec_index]):
                    tracked.exempt = True
                self.active[target.id] = tracked
            return
        if (isinstance(target, ast.Tuple) and isinstance(value, ast.Call)
                and terminal_name(value.func) == 'mkstemp'
                and len(target.elts) == 2):
            # fd, path = tempfile.mkstemp(...) — track both halves
            for part_index, part in enumerate(target.elts):
                if not isinstance(part, ast.Name):
                    continue
                part_spec = self._mkstemp_spec(part_index)
                if part_spec is None:
                    continue
                self._kill(part.id, line)
                self.active[part.id] = Tracked(binding=part.id,
                                               spec_index=part_spec,
                                               line=line)
            return
        if spec_index is not None:
            # stored somewhere non-local at birth: self attribute means the
            # owner check applies; anything else is an escape
            tracked = Tracked(binding=None, spec_index=spec_index, line=line)
            if (acquisition_call is not None
                    and _exempt_by_kwargs(acquisition_call,
                                          self.specs[spec_index])):
                tracked.exempt = True
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == 'self'):
                tracked.escaped = True
                tracked.escaped_self_attr = target.attr
            else:
                tracked.escaped = True
            self.summary.tracked.append(tracked)

    def _mkstemp_spec(self, part_index: int) -> Optional[int]:
        wanted = 'mkstemp:fd' if part_index == 0 else 'mkstemp:path'
        for index, spec in enumerate(self.specs):
            if spec.constructor == wanted:
                return index
        return None

    def _scan_discarded(self, value: ast.expr) -> None:
        """An expression statement that constructs a leakable and drops it
        (possibly via a method chain: ``Thread(...).start()``)."""
        call = value
        while (isinstance(call, ast.Call)
               and isinstance(call.func, ast.Attribute)
               and isinstance(call.func.value, ast.Call)):
            call = call.func.value
        if not isinstance(call, ast.Call):
            return
        spec_index = _match_constructor(call, self.specs)
        if spec_index is None:
            return
        spec = self.specs[spec_index]
        tracked = Tracked(binding=None, spec_index=spec_index,
                          line=call.lineno)
        if _exempt_by_kwargs(call, spec):
            tracked.exempt = True
        # Thread(...).join() and friends: the chained method may itself be
        # the release
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in spec.releases):
            tracked.released = True
        self.summary.tracked.append(tracked)

    def _scan_uses(self, expr: ast.expr, in_finally: bool,
                   in_broad: bool = False,
                   returning: bool = False) -> None:
        """Classify every use of a tracked binding inside ``expr``:
        release method call, release-by-arg, or escape; any other call is a
        may-raise risk for the still-open bindings."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._scan_call(node, in_finally, in_broad)
        if returning:
            for name, tracked in list(self.active.items()):
                if _name_used_in(expr, name):
                    tracked.escaped = True
                    tracked.returned = True
            # `return SharedMemory(...)` — a fresh acquisition escapes to
            # the caller: this function is a factory
            if isinstance(expr, ast.Call):
                spec_index = self._acquisition_spec(expr)
                if spec_index is not None:
                    tracked = Tracked(binding=None, spec_index=spec_index,
                                      line=expr.lineno, escaped=True,
                                      returned=True)
                    self.summary.tracked.append(tracked)

    def _scan_call(self, call: ast.Call, in_finally: bool,
                   in_broad: bool = False) -> None:
        func = call.func
        handled_names: Set[str] = set()
        if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                          ast.Name):
            receivers = [func.value.id]
            receivers.extend(self.aliases.get(func.value.id, ()))
            for receiver in receivers:
                tracked = self.active.get(receiver)
                if tracked is not None and func.attr in self._spec(
                        tracked).releases:
                    self._mark_release(tracked, in_finally, in_broad)
                    handled_names.add(receiver)
        func_name = terminal_name(func) if isinstance(
            func, (ast.Name, ast.Attribute)) else None
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            # only the binding itself as a whole argument is an ownership
            # handoff — `f(seg)` escapes, `f(seg.buf)` / `f(seg._name)` are
            # mere uses of the still-owned object; a binding placed in a
            # container literal (`Popen([exe, path])`) also escapes
            for literal in ast.walk(arg):
                if isinstance(literal, (ast.List, ast.Tuple, ast.Set)):
                    for element in literal.elts:
                        if (isinstance(element, ast.Name)
                                and element.id in self.active
                                and element.id not in handled_names):
                            self.active[element.id].escaped = True
                            handled_names.add(element.id)
            sub = arg.value if isinstance(arg, ast.Starred) else arg
            if not isinstance(sub, ast.Name):
                continue
            tracked = self.active.get(sub.id)
            if tracked is None or sub.id in handled_names:
                continue
            spec = self._spec(tracked)
            if func_name is not None and func_name in spec.releaser_funcs:
                self._mark_release(tracked, in_finally, in_broad)
            else:
                tracked.escaped = True
            handled_names.add(sub.id)
        # every other call is a potential raise between acquire and release
        if func_name in _SAFE_CALLS:
            return
        for tracked in self.active.values():
            if (tracked.binding is not None
                    and tracked.binding not in handled_names
                    and not tracked.released and not tracked.escaped
                    and tracked.risk_line is None
                    and call.lineno > tracked.line):
                tracked.risk_line = call.lineno


def build_summaries(ctx: AnalysisContext,
                    graph: CallGraph) -> Dict[str, FunctionSummary]:
    """Acquire/release/escape summaries for every function in the graph.

    Two passes plus a small fixpoint: factories (acquire-and-return) found
    in pass N make their call sites acquisitions in pass N+1, so a leak
    through a helper function converges after a couple of rounds."""
    specs = _leak_specs(ctx.config)
    summaries: Dict[str, FunctionSummary] = {}
    for _ in range(3):
        changed = False
        for info in graph.functions.values():
            scanner = _FunctionScanner(info, specs, summaries, graph)
            summary = scanner.scan()
            previous = summaries.get(info.key)
            if (previous is None
                    or previous.returns_spec != summary.returns_spec
                    or len(previous.tracked) != len(summary.tracked)):
                changed = True
            summaries[info.key] = summary
        if not changed:
            break
    return summaries
