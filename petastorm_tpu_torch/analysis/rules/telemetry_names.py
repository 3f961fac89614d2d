"""telemetry-names: every metric name used must exist in the spans catalog.

The telemetry subsystem (docs/observability.md) intentionally creates metrics
on first use — ``registry.observe('decodee', ...)`` raises nothing, it mints
a fresh histogram that no dashboard, no ``attribute_bottleneck`` knob-map
entry, and no doc row knows about. This rule closes that hole statically:

- ``stage_span('x')`` / ``record_stage('x', ...)`` → ``x`` must be in
  ``STAGES`` (``telemetry/spans.py``) or the port's own ``PORT_STAGES``
  beside it (accepted wherever ``STAGES`` is);
- ``<registry>.observe('x', ...)`` → ``x`` in ``STAGES`` or
  ``SIZE_HISTOGRAMS``;
- ``<registry>.inc('x')`` → ``x`` in ``COUNTERS`` or the port's own
  ``PORT_COUNTERS`` beside it;
- ``<registry>.gauge('x')`` → ``x`` in ``GAUGES`` (the SLO / service gauge
  surface — docs/observability.md "Efficiency SLOs");
- ``COST_STAGES`` declared in ``telemetry/cost_model.py`` → every entry in
  ``STAGES`` (a drifted entry would make the cost profiler silently ingest
  nothing for it);
- ``trace_instant('x', ...)`` → ``x`` in ``TRACE_INSTANTS`` (the
  flight-recorder anomaly catalog — docs/observability.md "Flight recorder");
- ``trace_complete('x', ...)`` → ``x`` in ``STAGES`` (a traced span IS a
  stage span, just on the timeline instead of a histogram);
- ``Knob('x', ...)`` / ``<catalog>.knob('x')`` → ``x`` in ``KNOB_IDS``
  (``autotune/knobs.py`` — the autotuner's knob-id catalog,
  docs/autotuning.md): a typo'd knob id names a knob nobody turns.

Conditional names (``'cache_hit' if hit else 'cache_miss'``) check both
branches; non-literal names are skipped (they are register-time plumbing, not
call sites). The catalog is read from the analyzed tree's
``telemetry/spans.py`` when present (so a mutated copy is judged against its
own catalog), else from the installed ``petastorm_tpu_torch.telemetry.spans``
(and ``petastorm_tpu_torch.autotune.knobs`` for the knob ids).
"""

from __future__ import annotations

import ast
from typing import Callable, Iterable, List, Optional, Tuple, TypeVar

from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule, extract_string_tuple,
                                               literal_str_values, parse_installed)

#: call forms checked against STAGES (observe_traced is the loader's
#: histogram+timeline dual-emission helper)
_NAME_FUNCS = ('stage_span', 'record_stage', 'trace_complete',
               'observe_traced')
#: call form checked against TRACE_INSTANTS (flight-recorder anomaly markers)
_INSTANT_FUNCS = ('trace_instant',)
#: call forms checked against KNOB_IDS: Knob construction and catalog lookup
_KNOB_CTOR = 'Knob'
_KNOB_ACCESSOR = 'knob'


class _Catalog:
    """The declared telemetry names, split by metric family."""

    def __init__(self, stages: Tuple[str, ...], counters: Tuple[str, ...],
                 size_histograms: Tuple[str, ...],
                 trace_instants: Tuple[str, ...], origin: str,
                 gauges: Tuple[str, ...] = ()) -> None:
        self.stages = frozenset(stages)
        self.counters = frozenset(counters)
        self.size_histograms = frozenset(size_histograms)
        self.trace_instants = frozenset(trace_instants)
        self.gauges = frozenset(gauges)
        self.origin = origin


class _KnobCatalog:
    """The declared autotuner knob ids (``KNOB_IDS`` in autotune/knobs.py)."""

    def __init__(self, knob_ids: Tuple[str, ...], origin: str) -> None:
        self.knob_ids = frozenset(knob_ids)
        self.origin = origin


def _catalog_from_tree(tree: ast.Module, origin: str) -> Optional[_Catalog]:
    stages = extract_string_tuple(tree, 'STAGES')
    if stages is None:
        return None
    counters = extract_string_tuple(tree, 'COUNTERS') or []
    # and the port's own counters wherever COUNTERS are
    counters += extract_string_tuple(tree, 'PORT_COUNTERS') or []
    size_histograms = extract_string_tuple(tree, 'SIZE_HISTOGRAMS') or []
    trace_instants = extract_string_tuple(tree, 'TRACE_INSTANTS') or []
    gauges = extract_string_tuple(tree, 'GAUGES') or []
    # the port's own stages are accepted wherever STAGES are
    stages += extract_string_tuple(tree, 'PORT_STAGES') or []
    return _Catalog(tuple(stages), tuple(counters), tuple(size_histograms),
                    tuple(trace_instants), origin, gauges=tuple(gauges))


_CatalogT = TypeVar('_CatalogT')


def _resolve_catalog(ctx: AnalysisContext, state_key: str, suffix: str,
                     installed_module: str,
                     from_tree: Callable[[ast.Module, str],
                                         Optional[_CatalogT]]
                     ) -> Optional[_CatalogT]:
    """The ONE resolution dance every declared-name catalog uses: analyzed
    tree first (a mutated copy is judged against its own declarations), then
    the installed package source (read, not imported), cached in the rule
    state."""
    state = ctx.rule_state(TelemetryNamesRule.name)
    cached = state.get(state_key)
    if cached is not None:
        return cached  # type: ignore[return-value]
    catalog: Optional[_CatalogT] = None
    module = ctx.find_module(suffix)
    if module is not None:
        catalog = from_tree(module.tree, module.display)
    if catalog is None:
        installed = parse_installed(installed_module)
        if installed is not None:
            catalog = from_tree(*installed)
    if catalog is not None:
        state[state_key] = catalog
    return catalog


def load_catalog(ctx: AnalysisContext) -> Optional[_Catalog]:
    """Resolve the stage/counter catalog (analyzed tree first, then the
    installed package source)."""
    return _resolve_catalog(ctx, 'catalog', ctx.config.stage_catalog_suffix,
                            'petastorm_tpu_torch.telemetry.spans',
                            _catalog_from_tree)


def _knob_catalog_from_tree(tree: ast.Module,
                            origin: str) -> Optional[_KnobCatalog]:
    knob_ids = extract_string_tuple(tree, 'KNOB_IDS')
    if knob_ids is None:
        return None
    return _KnobCatalog(tuple(knob_ids), origin)


def load_knob_catalog(ctx: AnalysisContext) -> Optional[_KnobCatalog]:
    """Resolve the autotuner knob-id catalog — same resolution order as the
    stage catalog, so a mutated copy is judged against its own ids."""
    return _resolve_catalog(ctx, 'knob_catalog',
                            ctx.config.knob_catalog_suffix,
                            'petastorm_tpu_torch.autotune.knobs',
                            _knob_catalog_from_tree)


class TelemetryNamesRule(Rule):
    """Flag telemetry names missing from the spans.py catalog (module doc)."""

    name = 'telemetry-names'
    description = ('stage_span/record_stage/observe/inc/gauge/trace_complete/'
                   'trace_instant names must exist in the telemetry catalog '
                   '(STAGES and PORT_STAGES / COUNTERS and PORT_COUNTERS / '
                   'SIZE_HISTOGRAMS / '
                   'GAUGES / TRACE_INSTANTS in telemetry/spans.py); '
                   'Knob()/catalog.knob() ids must exist in KNOB_IDS '
                   '(autotune/knobs.py); the cost profiler\'s COST_STAGES '
                   '(telemetry/cost_model.py) must be a subset of STAGES')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        if module.posix().endswith(ctx.config.stage_catalog_suffix):
            return []  # the catalog itself
        catalog = load_catalog(ctx)
        if catalog is None:
            return []
        knob_catalog = load_knob_catalog(ctx)
        is_knob_catalog_module = module.posix().endswith(
            ctx.config.knob_catalog_suffix)
        findings: List[Finding] = []
        if module.posix().endswith(ctx.config.cost_model_suffix):
            # the cost profiler's declared stage tuple must name real stages
            # — a drifted entry would silently profile nothing
            declared = extract_string_tuple(module.tree, 'COST_STAGES')
            for value in declared or ():
                if value not in catalog.stages:
                    findings.append(Finding(
                        self.name, module.display, 1,
                        'cost-model stage {!r} (COST_STAGES) is not declared '
                        'in STAGES (catalog: {}) — the profiler would '
                        'silently ingest no spans for it'.format(
                            value, catalog.origin)))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            func = node.func
            func_name: Optional[str] = None
            attr_name: Optional[str] = None
            if isinstance(func, ast.Name):
                func_name = func.id
            elif isinstance(func, ast.Attribute):
                attr_name = func.attr
            names: List[Tuple[str, int]] = []
            allowed: Optional[frozenset] = None
            family = ''
            origin = catalog.origin
            if func_name in _NAME_FUNCS or attr_name in _NAME_FUNCS:
                names = literal_str_values(node.args[0])
                allowed = catalog.stages
                family = 'STAGES'
            elif func_name in _INSTANT_FUNCS or attr_name in _INSTANT_FUNCS:
                names = literal_str_values(node.args[0])
                allowed = catalog.trace_instants
                family = 'TRACE_INSTANTS'
            elif attr_name == 'observe':
                names = literal_str_values(node.args[0])
                allowed = catalog.stages | catalog.size_histograms
                family = 'STAGES or SIZE_HISTOGRAMS'
            elif attr_name == 'inc':
                names = literal_str_values(node.args[0])
                allowed = catalog.counters
                family = 'COUNTERS'
            elif attr_name == 'gauge':
                # <registry>.gauge('x') — the SLO/service gauge surface
                # (docs/observability.md "Efficiency SLOs")
                names = literal_str_values(node.args[0])
                allowed = catalog.gauges
                family = 'GAUGES'
            elif ((func_name == _KNOB_CTOR or attr_name == _KNOB_CTOR
                   or attr_name == _KNOB_ACCESSOR)
                  and knob_catalog is not None and not is_knob_catalog_module):
                # Knob('x', ...) construction / catalog.knob('x') lookup
                # (first positional literal; kwarg-only constructions are
                # register-time plumbing and skipped like any non-literal).
                # The catalog module itself is exempt so KNOB_IDS can be
                # grown alongside the Knob builders that first use an id.
                names = literal_str_values(node.args[0])
                allowed = knob_catalog.knob_ids
                family = 'KNOB_IDS'
                origin = knob_catalog.origin
            if not names or allowed is None:
                continue
            for value, line in names:
                if value not in allowed:
                    findings.append(Finding(
                        self.name, module.display, line,
                        'telemetry name {!r} is not declared in {} '
                        '(catalog: {}) — it would mint an orphan metric no '
                        'dashboard or bottleneck map knows'.format(
                            value, family, origin)))
        return findings
