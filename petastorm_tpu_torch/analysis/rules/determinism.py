"""determinism: lineage-covered modules must not depend on unordered state.

``compose_global_digest`` *proves* at runtime that same seed + any topology
gives one byte-identical sample order; this rule is its static twin. In the
lineage-covered modules (config ``DETERMINISM_MODULES`` — reader,
ventilator, cost schedule, topology, loaders, service dispatcher, lineage
itself) three nondeterminism sources are findings:

- **unseeded randomness**: any ``random.*`` / ``np.random.*`` module-level
  call (``random.shuffle``, ``np.random.permutation``) — randomness must
  flow through a seeded ``Random``/``RandomState``/``default_rng`` instance
  so the draw stream is part of the lineage identity;
- **unordered iteration into order-sensitive sinks**: a ``set`` (literal,
  ``set()``/``frozenset()`` call, set comprehension, or a local bound to
  one), ``os.listdir``/``glob``/``scandir``/``iterdir`` results, or raw
  dict views (``.keys()``/``.values()``/``.items()``) feeding a sink from
  config ``ORDER_SENSITIVE_SINKS`` (digest folds, journal appends, shard
  deals) without an intervening ``sorted()``. ``sorted()`` at any wrap
  point launders the iteration; dict views are flagged only directly inside
  a sink argument (insertion order is deterministic per-process but not a
  cross-host contract), while set/listdir/glob iteration is also flagged
  when a ``for`` loop over it drives sink calls in its body;
- **``id()``-keyed containers**: ``id(x)`` as a dict key, subscript index
  or sort key — identity hashes differ across processes and runs, so any
  order or grouping built on them diverges host-to-host.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Optional, Sequence, Set

from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule,
                                               walk_skipping_functions)

#: ``random.<x>`` calls that construct/seed an explicit generator (allowed)
_SEEDED_RANDOM_FACTORIES = frozenset({'Random', 'SystemRandom'})
#: ``np.random.<x>`` constructors of seeded generators (allowed)
_SEEDED_NP_FACTORIES = frozenset({'RandomState', 'default_rng', 'Generator',
                                  'SeedSequence', 'PCG64', 'Philox'})
_NP_NAMES = frozenset({'np', 'numpy'})
#: calls returning filesystem-order (or otherwise unordered) iterables
_FS_ORDER_CALLS = frozenset({'listdir', 'glob', 'iglob', 'scandir',
                             'iterdir', 'walk', 'rglob'})
_DICT_VIEW_ATTRS = frozenset({'keys', 'values', 'items'})
_SET_CALLS = frozenset({'set', 'frozenset'})


def _is_determinism_module(module: SourceModule,
                           suffixes: Sequence[str]) -> bool:
    posix = module.posix()
    return any(posix.endswith('/' + suffix) or posix == suffix
               for suffix in suffixes)


def _unseeded_random(node: ast.Call) -> Optional[str]:
    """A description when ``node`` is a module-level (unseeded) random
    call, e.g. ``random.shuffle`` or ``np.random.permutation``."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    if (isinstance(func.value, ast.Name) and func.value.id == 'random'
            and func.attr not in _SEEDED_RANDOM_FACTORIES):
        return 'random.{}()'.format(func.attr)
    if (isinstance(func.value, ast.Attribute)
            and func.value.attr == 'random'
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id in _NP_NAMES
            and func.attr not in _SEEDED_NP_FACTORIES):
        return '{}.random.{}()'.format(func.value.value.id, func.attr)
    return None


def _walk_outside_sorted(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node`` skipping subtrees wrapped in ``sorted(...)`` — a
    ``sorted()`` at any wrap point launders unordered iteration."""
    stack: List[ast.AST] = [node]
    while stack:
        current = stack.pop()
        if (isinstance(current, ast.Call)
                and isinstance(current.func, ast.Name)
                and current.func.id == 'sorted'):
            continue
        yield current
        stack.extend(ast.iter_child_nodes(current))


class _UnorderedSources:
    """Per-module index of expressions/bindings with unordered iteration
    order: strong (sets, listdir/glob — order differs run-to-run) and weak
    (dict views — deterministic per-process, not a cross-host contract)."""

    def __init__(self, tree: ast.Module) -> None:
        self.set_bindings: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if (isinstance(target, ast.Name)
                            and self.is_strong(node.value)):
                        self.set_bindings.add(target.id)

    def is_strong(self, node: ast.AST) -> bool:
        """Set-valued or filesystem-order expression (flagged anywhere)."""
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _SET_CALLS):
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _FS_ORDER_CALLS):
                return True
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _FS_ORDER_CALLS):
                return True
        if isinstance(node, ast.Name) and node.id in self.set_bindings:
            return True
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            # set algebra on a known set binding stays a set
            return (self.is_strong(node.left)
                    or self.is_strong(node.right))
        return False

    @staticmethod
    def is_weak(node: ast.AST) -> bool:
        """Raw dict-view call (flagged only directly in sink args)."""
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DICT_VIEW_ATTRS
                and not node.args)

    def describe(self, node: ast.AST) -> str:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return 'a set'
        if isinstance(node, ast.Call):
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name in _SET_CALLS:
                return '{}()'.format(name)
            if name in _FS_ORDER_CALLS:
                return '{}() (filesystem order)'.format(name)
            if name in _DICT_VIEW_ATTRS:
                return '.{}() (raw dict view)'.format(name)
        if isinstance(node, ast.Name):
            return 'set-valued local {!r}'.format(node.id)
        return 'an unordered iterable'


class DeterminismRule(Rule):
    """Unseeded randomness / unordered-iteration / id()-keys (module doc)."""

    name = 'determinism'
    description = ('lineage-covered modules must not feed unseeded '
                   'randomness, unsorted set/listdir/dict-view iteration or '
                   'id()-keys into order-sensitive sinks (digests, '
                   'journals, shard deals)')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        if not _is_determinism_module(module,
                                      ctx.config.determinism_modules):
            return []
        findings: List[Finding] = []
        sinks = frozenset(ctx.config.order_sensitive_sinks)
        sources = _UnorderedSources(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                findings.extend(self._check_random(module, node))
                findings.extend(self._check_sink_args(module, node, sinks,
                                                      sources))
            if isinstance(node, (ast.For, ast.AsyncFor)):
                findings.extend(self._check_loop(module, node, sinks,
                                                 sources))
        findings.extend(self._check_id_keys(module))
        return findings

    def _check_random(self, module: SourceModule,
                      node: ast.Call) -> List[Finding]:
        described = _unseeded_random(node)
        if described is None:
            return []
        return [Finding(
            self.name, module.display, node.lineno,
            'unseeded {} in a lineage-covered module — draw through a '
            'seeded Random/RandomState/default_rng instance so the stream '
            'is part of the run identity'.format(described))]

    def _is_sink(self, node: ast.Call, sinks: frozenset) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name) and func.id in sinks:
            return func.id
        if isinstance(func, ast.Attribute) and func.attr in sinks:
            return func.attr
        return None

    def _check_sink_args(self, module: SourceModule, node: ast.Call,
                         sinks: frozenset,
                         sources: _UnorderedSources) -> List[Finding]:
        sink = self._is_sink(node, sinks)
        if sink is None:
            return []
        findings: List[Finding] = []
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            offender = self._unordered_in_arg(arg, sources)
            if offender is None:
                continue
            findings.append(Finding(
                self.name, module.display, offender.lineno,
                '{} iterates into order-sensitive sink {}() without '
                'sorted() — iteration order is not a reproducibility '
                'contract; wrap it in sorted(...)'.format(
                    sources.describe(offender), sink)))
        return findings

    def _unordered_in_arg(self, arg: ast.expr,
                          sources: _UnorderedSources) -> Optional[ast.AST]:
        """The first unordered expression *iterated* inside a sink argument
        (comprehension iters, starred unpacking, or the argument itself),
        ignoring anything laundered through ``sorted()``."""
        for node in _walk_outside_sorted(arg):
            if isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                 ast.SetComp, ast.DictComp)):
                for generator in node.generators:
                    candidate = generator.iter
                    if any(isinstance(sub, ast.Call)
                           and isinstance(sub.func, ast.Name)
                           and sub.func.id == 'sorted'
                           for sub in [candidate]):
                        continue
                    if (sources.is_strong(candidate)
                            or sources.is_weak(candidate)):
                        return candidate
            if isinstance(node, ast.Starred):
                if sources.is_strong(node.value):
                    return node.value
        # the argument itself passed through whole (e.g. `fold(set_of_ids)`)
        stripped = arg
        if sources.is_strong(stripped) or sources.is_weak(stripped):
            return stripped
        return None

    def _check_loop(self, module: SourceModule, node: ast.AST,
                    sinks: frozenset,
                    sources: _UnorderedSources) -> List[Finding]:
        iter_expr = getattr(node, 'iter', None)
        if iter_expr is None or not sources.is_strong(iter_expr):
            return []
        if (isinstance(iter_expr, ast.Call)
                and isinstance(iter_expr.func, ast.Name)
                and iter_expr.func.id == 'sorted'):
            return []
        body = getattr(node, 'body', [])
        for inner in walk_skipping_functions(body):
            if (isinstance(inner, ast.Call)
                    and self._is_sink(inner, sinks) is not None):
                return [Finding(
                    self.name, module.display, int(getattr(node, 'lineno',
                                                           1)),
                    'loop over {} drives order-sensitive sink {}() in its '
                    'body — iterate sorted(...) so every host folds/deals '
                    'in one order'.format(
                        sources.describe(iter_expr),
                        self._is_sink(inner, sinks)))]
        return []

    def _check_id_keys(self, module: SourceModule) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            spots: List[ast.expr] = []
            if isinstance(node, ast.Subscript):
                spots.append(node.slice)
            elif isinstance(node, ast.Dict):
                spots.extend(k for k in node.keys if k is not None)
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == 'key':
                        spots.append(kw.value)
            for spot in spots:
                if self._mentions_id_call(spot):
                    findings.append(Finding(
                        self.name, module.display, spot.lineno,
                        'id() used as a key — identity hashes differ '
                        'across processes and runs, so any order or '
                        'grouping keyed on them diverges host-to-host; '
                        'key on a stable field instead'))
        return findings

    @staticmethod
    def _mentions_id_call(node: ast.expr) -> bool:
        if isinstance(node, ast.Name) and node.id == 'id':
            return True
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                    and sub.func.id == 'id'):
                return True
        return False
