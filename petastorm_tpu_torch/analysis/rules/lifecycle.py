"""resource-lifecycle: every acquired leakable resource reaches its release.

The runtime failure class this pins down statically is the one that has
shipped twice: a ``/dev/shm`` segment created and then orphaned when an
exception fired between ``SharedMemory(create=True)`` and ``close()``
and worker rings left undrained at teardown. The
rule walks the call-graph resource summaries (:mod:`..callgraph`,
config ``LEAKABLE_TYPES``) and reports, per acquisition:

- **never released** — no release, no escape: the object is simply dropped
  (``Thread`` without ``join`` and without ``daemon=True``, a socket bound
  to a local and forgotten);
- **leaks on exception paths** — released on the straight-line path only,
  while a may-raise call sits between the acquire and the release; for
  ``paths_sensitive`` resource types the release must be in a ``finally``
  or the acquisition context-managed (``with`` / ``closing``);
- **rebound before release** — the binding was reassigned or ``del``'d
  while still owning a live resource (the old
  object can never be released again through that name);
- **escapes to an owner that never releases it** — ``self._x = acquire()``
  is fine *only if* some method of the class releases ``self._x``
  (close/join/stop/del or handing it to a helper) — escape-to-owner.

Escapes to a caller (returned), into a container, or as an argument to a
non-releasing call transfer ownership and end tracking — the receiving
scope is analyzed on its own terms (a function that acquires-and-returns
makes each of its call sites an acquisition, so a leak through a helper
factory is still caught at the caller).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from petastorm_tpu_torch.analysis.callgraph import (CallGraph, FunctionSummary,
                                                    Tracked, _LeakSpecView,
                                                    _leak_specs, build_summaries,
                                                    get_callgraph)
from petastorm_tpu_torch.analysis.core import AnalysisContext, Finding, Rule


class ResourceLifecycleRule(Rule):
    """Leakable-resource acquire/release/escape discipline (module doc)."""

    name = 'resource-lifecycle'
    description = ('acquired leakable resources (shm segments, sockets, '
                   'threads, journals, temp dirs) must reach their release '
                   'on all paths or escape to an owner that releases them')

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        graph = get_callgraph(ctx)
        summaries = build_summaries(ctx, graph)
        specs = _leak_specs(ctx.config)
        findings: List[Finding] = []
        for summary in summaries.values():
            info = summary.info
            display = info.module.display
            for tracked in summary.tracked:
                spec = specs[tracked.spec_index]
                finding = self._judge(tracked, spec, summary, graph)
                if finding is not None:
                    findings.append(Finding(self.name, display,
                                            tracked.line, finding))
        return findings

    def _judge(self, tracked: Tracked, spec: _LeakSpecView,
               summary: FunctionSummary,
               graph: CallGraph) -> Optional[str]:
        """The finding message for one acquisition, or None when clean."""
        label = spec.label
        release_words = ', '.join(
            tuple('.{}()'.format(r) for r in spec.releases)
            + tuple('{}(...)'.format(r) for r in spec.releaser_funcs))
        if tracked.exempt:
            return None
        if tracked.killed_line is not None:
            return ('{} acquired here is rebound/deleted at line {} before '
                    'being released — the original object leaks; release it '
                    '({}) before reusing the name'.format(
                        label, tracked.killed_line, release_words))
        if tracked.escaped_self_attr is not None:
            info = summary.info
            if info.class_name is not None and not graph.owner_releases(
                    info.module, info.class_name, tracked.escaped_self_attr):
                return ('{} escapes to self.{} but no method of {} releases '
                        'it ({}) — the owner must take over the lifecycle '
                        'it was handed'.format(
                            label, tracked.escaped_self_attr,
                            info.class_name, release_words))
            return None
        if tracked.escaped:
            return None
        if not tracked.released and tracked.release_in_finally:
            return ('{} is released only on the error path (inside an '
                    'except handler) — the normal path leaks it; release '
                    'it ({}) on the straight-line path too'.format(
                        label, release_words))
        if not tracked.released:
            return ('{} acquired here is never released ({}) and never '
                    'escapes — it leaks on every path'.format(
                        label, release_words))
        if (spec.paths_sensitive
                and not tracked.release_in_finally
                and tracked.risk_line is not None):
            return ('{} is released only on the normal path — the call at '
                    'line {} can raise between the acquire and the release, '
                    'leaking it; move the release into a finally/with'.format(
                        label, tracked.risk_line))
        return None
