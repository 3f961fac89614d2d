"""protocol-conformance: producer/consumer set matching over the wire literals
(the port of ``petastorm_tpu.analysis.rules.protocol``).

The cross-process data plane speaks in string/bytes literals that no type
checker relates to each other: the process pool's pipe message kinds
(``process_worker_main.py`` sends ``('result_shm', token, descriptor)``,
``process_pool.py`` dispatches on ``kind == 'result_shm'``), the input
service's ZMQ kind frames (``b'w_result'``), shm descriptor
JSON keys (``ShmSlotDescriptor.to_bytes``/``from_bytes``), the results-channel
sidecar keys (``ArrowIpcSerializer.serialize`` writes ``meta_extra``,
``deserialize`` reads them back), and quarantine ``reason`` values. A typo or
a one-sided addition compiles, imports, and fails only at runtime on the slow
path — the exact drift class this rule pins down statically:

- **message kinds**: every bytes literal produced as a kind (first or second
  element of a ``send_multipart`` list, or a plain ``send``) by one of the
  protocol peer files must be *dispatched on* (compared against a kind
  expression: ``kind``, ``frames[0]``/``frames[1]``, ``...recv()``) by a peer,
  and vice versa. In the pool pair (config ``PROTOCOL_PEER_FILES``) the
  kinds are ``str`` too: the first ``str`` element of a tuple literal handed
  to ``send``/``_send`` (``channel.send(('ready',))``, ``self._send(worker,
  ('work', ...))``) is produced, and a ``str`` literal compared with ``kind``
  or ``message[0]``/``msg[0]`` is consumed. A ``str`` kind and a bytes kind
  of one name are different
  kinds, as they are on the wire. Cross-checks fire only when at least two peer files are in
  the analyzed set, so a lone fixture file is never half-judged. Two
  independent peer groups are matched: the in-process pool pair
  (``process_pool.py``/``process_worker_main.py``) and the input service's
  trio (``dispatcher.py``/``service_worker.py``/``service_client.py`` —
  docs/service.md), each against its own kind set.
- **shm descriptor keys**: the JSON keys ``to_bytes`` writes must equal the
  keys ``from_bytes`` reads (file: ``shm_ring.py``).
- **sidecar keys**: the ``meta_extra`` keys ``serialize`` writes must each be
  read by ``deserialize`` (file: ``serializers.py``; the codec's own
  ``num_rows``/``columns`` are allowed extra reads).
- **quarantine reasons**: every ``QuarantineRecord(..., reason='x')`` literal
  must appear in the ``QUARANTINE_REASONS`` registry in ``resilience.py``.

The journal record-kind registries (dispatcher ledger, topology membership
journal, run historian) are the ``journal-discipline`` rule's: one
data-driven check over config ``JOURNAL_REGISTRIES``.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple, Union

from petastorm_tpu_torch.analysis.callgraph import terminal_name
from petastorm_tpu_torch.analysis.core import (AnalysisContext, Finding, Rule,
                                               SourceModule, const_bytes, const_str,
                                               extract_string_tuple,
                                               module_bytes_constants, parse_installed)

#: extra keys ``deserialize`` may read that ``serialize`` does not write via
#: ``meta_extra`` — they are written by the shared columnar codec
#: (``encode_columnar``), not the sidecar dict
_CODEC_META_KEYS = frozenset({'num_rows', 'columns'})

#: names whose subscripts ``[0]``/``[1]`` count as kind expressions
_FRAME_NAMES = frozenset({'frames', 'parts'})

#: calls that put a pipe message (a tuple whose first element is its ``str``
#: kind) on the pool pair's pipes
_PIPE_SEND_CALLS = frozenset({'send', '_send'})

#: names whose subscript ``[0]`` is a pipe message's kind
_PIPE_MESSAGE_NAMES = frozenset({'message', 'msg'})


def _unwrap_bytes_call(node: ast.expr) -> ast.expr:
    """Strip a ``bytes(...)``/``memoryview(...)`` wrapper so
    ``bytes(frames[1]) == b'ready'`` matches like ``frames[1] == b'ready'``."""
    while (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
           and node.func.id in ('bytes', 'memoryview') and len(node.args) == 1):
        node = node.args[0]
    return node


def _is_kind_expr(node: ast.expr) -> bool:
    """True when ``node`` reads a message kind: the ``kind`` variable, the
    first/second frame of a multipart receive, or a direct ``recv()``."""
    node = _unwrap_bytes_call(node)
    if isinstance(node, ast.Name):
        return node.id == 'kind'
    if isinstance(node, ast.Subscript):
        base = node.value
        index = node.slice
        if isinstance(base, ast.Name) and base.id in _FRAME_NAMES:
            return (isinstance(index, ast.Constant)
                    and index.value in (0, 1))
        return False
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr == 'recv'
    return False


def _is_pipe_kind_expr(node: ast.expr) -> bool:
    """True when ``node`` reads a pipe message's kind: ``kind`` or
    ``<name>[0]`` for a name in ``_PIPE_MESSAGE_NAMES``."""
    if isinstance(node, ast.Name):
        return node.id == 'kind'
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id in _PIPE_MESSAGE_NAMES
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == 0)


#: a message kind: ZMQ frames carry bytes, the pool's pipes str
Kind = Union[bytes, str]


class _PeerExtraction:
    """Produced/consumed kind literals of one protocol peer file."""

    def __init__(self) -> None:
        self.produced: Dict[Kind, Tuple[str, int]] = {}
        self.consumed: Dict[Kind, Tuple[str, int]] = {}


def extract_wire_kinds(module: SourceModule,
                       pipe: bool = False) -> _PeerExtraction:
    """Collect the message kinds ``module`` produces and dispatches on.

    Produced: bytes literals in the first two elements of a
    ``send_multipart([...])`` list (ROUTER sends put the routing identity
    first, the kind second), resolving a list-valued local name
    (``ready_msg = [b'ready', ...]``) and a ``[...] + frames`` concatenation;
    plus the sole argument of a plain ``send(b'...')``. Consumed: bytes
    literals (or module-level bytes constants, the ``MSG_*`` convention)
    compared with ``==``/``!=`` against a kind expression.

    With ``pipe`` (the pool pair), the pipe's ``str`` kinds are collected as
    well: produced as the first element of a tuple literal passed (at any
    position) to a call in ``_PIPE_SEND_CALLS``, consumed as a ``str``
    literal compared with a pipe kind expression."""
    out = _PeerExtraction()
    constants = module_bytes_constants(module.tree)
    list_assigns: Dict[str, ast.List] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    list_assigns[target.id] = node.value

    def resolve_bytes(node: ast.expr) -> Optional[bytes]:
        value = const_bytes(node)
        if value is not None:
            return value
        if isinstance(node, ast.Name):
            return constants.get(node.id)
        return None

    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if pipe and terminal_name(node.func) in _PIPE_SEND_CALLS:
            for arg in node.args:
                if isinstance(arg, ast.Tuple) and arg.elts:
                    text = const_str(arg.elts[0])
                    if text is not None:
                        out.produced.setdefault(text, (module.display, arg.lineno))
        func = node.func
        if not isinstance(func, ast.Attribute):
            continue
        if func.attr == 'send' and node.args:
            value = resolve_bytes(node.args[0])
            if value is not None:
                out.produced.setdefault(value,
                                        (module.display, node.lineno))
        if func.attr == 'send_multipart' and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
                arg = arg.left
            if isinstance(arg, ast.Name):
                arg = list_assigns.get(arg.id, arg)
            if isinstance(arg, ast.List):
                for element in arg.elts[:2]:
                    value = resolve_bytes(element)
                    if value is not None:
                        out.produced.setdefault(
                            value, (module.display, element.lineno))
                        break

    readers: List[Tuple[Any, Any]] = [(_is_kind_expr, resolve_bytes)]
    if pipe:
        readers.append((_is_pipe_kind_expr, const_str))
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Compare):
            continue
        if not all(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            continue
        sides = [node.left] + list(node.comparators)
        for is_kind, resolve in readers:
            if not any(is_kind(side) for side in sides):
                continue
            for side in sides:
                value = resolve(side)
                if value is not None:
                    out.consumed.setdefault(value, (module.display, node.lineno))
    return out


def _function_defs(tree: ast.Module, name: str) -> List[ast.FunctionDef]:
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef) and node.name == name]


def _dict_keys_written(func: ast.FunctionDef, var_names: Set[str]
                       ) -> Dict[str, int]:
    """str keys of dict literals assigned to ``var_names`` inside ``func``
    (plain and annotated assignments), plus keys of ``var['k'] = ...``
    subscript stores on those names."""
    out: Dict[str, int] = {}
    for node in ast.walk(func):
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = list(node.targets), node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for target in targets:
            if (isinstance(target, ast.Name) and target.id in var_names
                    and isinstance(value, ast.Dict)):
                for key in value.keys:
                    text = const_str(key) if key is not None else None
                    if text is not None:
                        out.setdefault(text, key.lineno)  # type: ignore[union-attr]
            if (isinstance(target, ast.Subscript)
                    and isinstance(target.value, ast.Name)
                    and target.value.id in var_names):
                text = const_str(target.slice)
                if text is not None:
                    out.setdefault(text, target.lineno)
    return out


def _dict_keys_read(func: ast.FunctionDef, var_names: Set[str]
                    ) -> Dict[str, int]:
    """str keys read from ``var_names`` inside ``func``: ``var['k']`` loads
    and ``var.get('k', ...)`` calls."""
    out: Dict[str, int] = {}
    for node in ast.walk(func):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id in var_names):
            text = const_str(node.slice)
            if text is not None:
                out.setdefault(text, node.lineno)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == 'get'
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in var_names and node.args):
            text = const_str(node.args[0])
            if text is not None:
                out.setdefault(text, node.lineno)
    return out


class ProtocolConformanceRule(Rule):
    """Cross-file producer/consumer matching of wire literals (module doc)."""

    name = 'protocol-conformance'
    description = ('pipe and ZMQ message kinds, shm descriptor keys, sidecar '
                   'keys and quarantine reasons must match between producer '
                   'and consumer sites')

    def check_module(self, module: SourceModule,
                     ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        state = ctx.rule_state(self.name)
        if module.name in ctx.config.protocol_peer_files:
            state.setdefault('peers', {})[module.display] = \
                extract_wire_kinds(module, pipe=True)
        if module.name in ctx.config.service_peer_files:
            # the input service's own peer group (dispatcher <-> service
            # worker <-> client transport) — matched independently of the
            # in-process pool pair, same mechanism
            state.setdefault('service_peers', {})[module.display] = \
                extract_wire_kinds(module)
        if module.name in ctx.config.descriptor_files:
            findings.extend(self._check_descriptor_keys(module))
        if module.name == 'serializers.py':
            findings.extend(self._check_sidecar_keys(module))
        findings.extend(
            self._collect_quarantine_reasons(module, state,
                                             ctx.config.quarantine_registry_suffix))
        return findings

    # ------------------------------------------------------- message kinds

    def finalize(self, ctx: AnalysisContext) -> Iterable[Finding]:
        state = ctx.rule_state(self.name)
        findings: List[Finding] = []
        for group_key in ('peers', 'service_peers'):
            findings.extend(self._match_peer_group(state.get(group_key, {})))
        findings.extend(self._check_quarantine_registry(ctx, state))
        return findings

    def _match_peer_group(self,
                          peers: Dict[str, _PeerExtraction]) -> List[Finding]:
        """Set-match one peer group's produced vs dispatched-on kinds
        (cross-checks fire only with >= 2 peer files in the analyzed set)."""
        findings: List[Finding] = []
        if len(peers) < 2:
            return findings
        produced: Dict[Kind, Tuple[str, int]] = {}
        consumed: Dict[Kind, Tuple[str, int]] = {}
        for extraction in peers.values():
            for kind, site in extraction.produced.items():
                produced.setdefault(kind, site)
            for kind, site in extraction.consumed.items():
                consumed.setdefault(kind, site)
        for kind in sorted(set(produced) - set(consumed), key=repr):
            path, line = produced[kind]
            findings.append(Finding(
                self.name, path, line,
                'message kind {!r} is sent but no protocol peer '
                'dispatches on it — a consumer will drop or misroute it '
                '(peers: {})'.format(kind, ', '.join(sorted(peers)))))
        for kind in sorted(set(consumed) - set(produced), key=repr):
            path, line = consumed[kind]
            findings.append(Finding(
                self.name, path, line,
                'message kind {!r} is dispatched on but never sent by '
                'any protocol peer — dead dispatch arm or a renamed '
                'producer (peers: {})'.format(kind,
                                              ', '.join(sorted(peers)))))
        return findings

    # --------------------------------------------------- descriptor/sidecar

    def _check_descriptor_keys(self, module: SourceModule) -> List[Finding]:
        writers = _function_defs(module.tree, 'to_bytes')
        readers = _function_defs(module.tree, 'from_bytes')
        if not writers or not readers:
            return []
        written: Dict[str, int] = {}
        read: Dict[str, int] = {}
        for func in writers:
            written.update(_dict_keys_written(func, {'spec'}))
        for func in readers:
            read.update(_dict_keys_read(func, {'spec'}))
        findings = []
        for key in sorted(set(written) - set(read)):
            findings.append(Finding(
                self.name, module.display, written[key],
                'shm descriptor key {!r} is written by to_bytes but never '
                'read by from_bytes'.format(key)))
        for key in sorted(set(read) - set(written)):
            findings.append(Finding(
                self.name, module.display, read[key],
                'shm descriptor key {!r} is read by from_bytes but never '
                'written by to_bytes'.format(key)))
        return findings

    def _check_sidecar_keys(self, module: SourceModule) -> List[Finding]:
        writers = _function_defs(module.tree, 'serialize')
        readers = _function_defs(module.tree, 'deserialize')
        if not writers or not readers:
            return []
        written: Dict[str, int] = {}
        read: Dict[str, int] = {}
        for func in writers:
            written.update(_dict_keys_written(func, {'meta_extra'}))
        for func in readers:
            read.update(_dict_keys_read(func, {'meta'}))
        if not written:
            return []
        findings = []
        for key in sorted(set(written) - set(read)):
            findings.append(Finding(
                self.name, module.display, written[key],
                'sidecar key {!r} is written into meta_extra by serialize '
                'but never read back by deserialize — it silently vanishes '
                'on the consumer side'.format(key)))
        for key in sorted(set(read) - set(written) - _CODEC_META_KEYS):
            findings.append(Finding(
                self.name, module.display, read[key],
                'deserialize reads sidecar key {!r} that serialize never '
                'writes — it is always absent'.format(key)))
        return findings

    # -------------------------------------------------- quarantine reasons

    def _collect_quarantine_reasons(self, module: SourceModule,
                                    state: Dict[str, object],
                                    registry_suffix: str) -> List[Finding]:
        if module.posix().endswith(registry_suffix):
            declared = extract_string_tuple(module.tree, 'QUARANTINE_REASONS')
            if declared is not None:
                state['declared_reasons'] = (declared, module.display)
            return []
        uses = state.setdefault('reason_uses', [])
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            func_name = func.id if isinstance(func, ast.Name) else (
                func.attr if isinstance(func, ast.Attribute) else None)
            if func_name != 'QuarantineRecord':
                continue
            for keyword in node.keywords:
                if keyword.arg != 'reason':
                    continue
                value = const_str(keyword.value)
                if value is not None:
                    uses.append((value, module.display,  # type: ignore[attr-defined]
                                 keyword.value.lineno))
        return []

    def _check_quarantine_registry(self, ctx: AnalysisContext,
                                   state: Dict[str, object]) -> List[Finding]:
        declared_entry = state.get('declared_reasons')
        uses = state.get('reason_uses') or []
        if declared_entry is None:
            declared = self._installed_quarantine_reasons(ctx)
            if declared is None:
                return []
        else:
            declared = declared_entry[0]  # type: ignore[index]
        findings = []
        for value, path, line in uses:  # type: ignore[union-attr]
            if value not in declared:
                findings.append(Finding(
                    self.name, path, line,
                    'quarantine reason {!r} is not declared in '
                    'QUARANTINE_REASONS ({}) — dashboards and ledger '
                    'consumers will not recognize it'.format(
                        value, tuple(declared))))
        return findings

    @staticmethod
    def _installed_quarantine_reasons(ctx: AnalysisContext
                                      ) -> Optional[List[str]]:
        """Fallback registry from the installed resilience module's source
        (read, not imported), so fixture trees without a ``resilience.py``
        still validate against the shipped reason set."""
        installed = parse_installed('petastorm_tpu_torch.resilience')
        if installed is None:
            return None
        return extract_string_tuple(installed[0], 'QUARANTINE_REASONS')
