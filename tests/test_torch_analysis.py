"""The port's static data-plane analyzer (``petastorm_tpu_torch.analysis``)
held against the JAX package's (``petastorm_tpu.analysis``):

- **fixture parity**: for every case of ``tests/test_pipecheck.py``'s BAD,
  GOOD and suppression lists, both analyzers report the same findings
  (rule, path, line, message, with the port's package name mapped to the
  JAX one), the same suppression count and the same notes;
- **self-application**: the port's analyzer over ``petastorm_tpu_torch/`` is
  clean, counts every ``.py`` file and honours every directive, each with
  its reason;
- **cross-application**: over ``petastorm_tpu/``, given the JAX manifest,
  it reproduces the JAX analyzer's report;
- **the pipe protocol**: it extracts the port's pool pair's ``str`` kinds,
  the same names the JAX rule extracts from the JAX pair as bytes, and flags
  a renamed kind that the JAX analyzer misses on the same copy;
- the CLI (``python -m petastorm_tpu_torch.analysis``, the throughput CLI's
  ``pipecheck``), the doctor's block, and the import boundary: the analyzer
  loads neither torch nor zmq and nothing of JAX, even when every catalog
  and registry comes from its fallbacks.

The seeded mutations of the port's own modules are in
``test_torch_analysis_mutations.py``."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from petastorm_tpu.analysis import run_pipecheck as jax_run_pipecheck
from petastorm_tpu.analysis.core import load_module as jax_load_module
from petastorm_tpu.analysis.rules.protocol import extract_wire_kinds as jax_extract_wire_kinds
from petastorm_tpu_torch.analysis import run_pipecheck
from petastorm_tpu_torch.analysis.cli import main as pipecheck_main, package_root
from petastorm_tpu_torch.analysis.config import JOURNAL_REGISTRIES
from petastorm_tpu_torch.analysis.core import installed_source, load_module
from petastorm_tpu_torch.analysis.rules import ALL_RULES
from petastorm_tpu_torch.analysis.rules.protocol import extract_wire_kinds

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'petastorm_tpu_torch'
JAX_PKG = REPO / 'petastorm_tpu'
FIXTURES = REPO / 'tests' / 'data' / 'pipecheck'
JAX_MANIFEST = JAX_PKG / 'analysis' / 'strict_modules.txt'
MYPY_INI = REPO / 'mypy.ini'
DIRECTIVE = re.compile(r'#\s*pipecheck:\s*disable=([A-Za-z0-9_,-]+)\s*(?:--\s*(\S.*))?')
#: the pool pair of each package
POOL_PAIR = ('workers/process_pool.py', 'workers/process_worker_main.py')


def _fixture_cases():
    """The BAD, GOOD and suppression cases of ``tests/test_pipecheck.py``,
    read from its source (its module lists and the suppression test's
    parametrize list) as ``(list, path, rules)``."""
    tree = ast.parse((REPO / 'tests' / 'test_pipecheck.py').read_text())
    cases = []
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ('BAD_FIXTURES', 'GOOD_FIXTURES')):
            kind = node.targets[0].id.split('_')[0]
            cases.extend((kind, case[0], case[1]) for case in ast.literal_eval(node.value))
        if (isinstance(node, ast.FunctionDef)
                and node.name == 'test_suppression_comment_is_honored_and_counted'):
            cases.extend(('SUPPRESSED', path, rules)
                         for path, rules in ast.literal_eval(node.decorator_list[0].args[1]))
    return cases


FIXTURE_CASES = _fixture_cases()


def _py_files(root):
    """The ``.py`` files the analyzers walk under ``root``."""
    out = []
    for directory, dirs, names in os.walk(root):
        dirs[:] = [d for d in dirs if d != '__pycache__' and not d.startswith('.')]
        out.extend(Path(directory) / name for name in names if name.endswith('.py'))
    return sorted(out)


def _directives(root):
    return [match for path in _py_files(root)
            for match in DIRECTIVE.findall(path.read_text())]


def _as_jax(findings):
    return [(f.rule, f.path, f.line, f.message.replace('petastorm_tpu_torch', 'petastorm_tpu'))
            for f in findings]


@pytest.fixture(scope='module')
def port_report():
    """The port's analyzer over the port: the shared whole-tree report."""
    return run_pipecheck()


# ------------------------------------------------------------ fixture parity


def test_fixture_cases_cover_every_fixture_file():
    assert len(FIXTURE_CASES) == 65
    covered = set()
    for _, path, _ in FIXTURE_CASES:
        target = FIXTURES / path
        covered.update(_py_files(target) if target.is_dir() else [target])
    assert covered == set(_py_files(FIXTURES))
    assert len(covered) == 74


@pytest.mark.parametrize('kind,path,rules', FIXTURE_CASES,
                         ids=['{}:{}'.format(kind, path) for kind, path, _ in FIXTURE_CASES])
def test_fixture_parity(kind, path, rules):
    target = str(FIXTURES / path)
    jax_report = jax_run_pipecheck(paths=[target], rules=rules)
    report = run_pipecheck(paths=[target], rules=rules)
    assert _as_jax(report.findings) == [(f.rule, f.path, f.line, f.message)
                                        for f in jax_report.findings]
    assert (report.suppressed, report.files, report.notes, report.rules) == \
        (jax_report.suppressed, jax_report.files, jax_report.notes, jax_report.rules)
    # the case's own expectation holds as well
    if kind == 'BAD':
        assert report.findings
    else:
        assert report.clean
        assert report.suppressed == (1 if kind == 'SUPPRESSED' else 0)


# ---------------------------------------------------------- self-application


def test_self_application_is_clean(port_report):
    assert report_summary(port_report) == {
        'clean': True, 'findings': [], 'by_rule': {}, 'notes': [],
        'rules': [cls.name for cls in ALL_RULES]}
    assert port_report.files == len(_py_files(PORT)) >= 136
    directives = _directives(PORT)
    # the telemetry-names directives (the loader's ``deliver``; the model
    # graphs' ``graph_capture`` and three counters) quiet the JAX package's
    # analyzer, whose catalog lacks the port's own stages and counters; the
    # port's rule accepts them, so here they suppress nothing
    assert [rule for rule, _ in directives].count('telemetry-names') == 5
    assert port_report.suppressed == len(directives) - 5 == 2
    assert all(reason.strip() for _rule, reason in directives)
    # the whole-program graph of the port, larger than before the analyzer
    # joined it (1,665 functions over 120 files)
    assert port_report.callgraph_functions > 1665


def report_summary(report):
    return {'clean': report.clean, 'findings': [f.format() for f in report.findings],
            'by_rule': report.by_rule(), 'notes': report.notes, 'rules': report.rules}


def test_every_jax_module_has_its_port():
    """``comm -23`` of the two packages' ``.py`` lists is empty."""
    jax_files = {path.relative_to(JAX_PKG) for path in _py_files(JAX_PKG)}
    port_files = {path.relative_to(PORT) for path in _py_files(PORT)}
    assert jax_files - port_files == set()
    assert {p for p in port_files if p.parts[0] == 'analysis'} == \
        {p for p in jax_files if p.parts[0] == 'analysis'}
    assert (PORT / 'analysis' / 'strict_modules.txt').is_file()


# --------------------------------------------------------- cross-application


def test_cross_application_reproduces_the_jax_report():
    report = run_pipecheck(paths=[str(JAX_PKG)], mypy_ini=str(MYPY_INI),
                           manifest=str(JAX_MANIFEST))
    jax_report = jax_run_pipecheck(paths=[str(JAX_PKG)])
    assert report_summary(report) == report_summary(jax_report)
    assert (report.files, report.suppressed, report.callgraph_functions) == \
        (jax_report.files, jax_report.suppressed, jax_report.callgraph_functions)
    assert report.files == 130 and report.suppressed == 1 and report.clean


# ---------------------------------------------------------- the pipe protocol


def _kinds(extraction):
    def text(kind):
        return kind.decode() if isinstance(kind, bytes) else kind
    return (sorted(text(k) for k in extraction.produced),
            sorted(text(k) for k in extraction.consumed))


def test_pipe_kinds_of_the_port_equal_the_jax_pair_kinds():
    for rel in POOL_PAIR:
        jax_module, _ = jax_load_module(JAX_PKG / rel)
        module, _ = load_module(PORT / rel)
        port = extract_wire_kinds(module, pipe=True)
        # the port's kinds are str, the JAX pair's bytes: the same names
        assert all(isinstance(kind, str) for kind in list(port.produced) + list(port.consumed))
        assert _kinds(port) == _kinds(jax_extract_wire_kinds(jax_module)), rel
    pool, worker = (_kinds(extract_wire_kinds(load_module(PORT / rel)[0], pipe=True))
                    for rel in POOL_PAIR)
    assert pool == (['release', 'stop', 'work'],
                    ['done', 'error', 'heartbeat', 'ready', 'result', 'result_shm', 'started'])
    assert worker == (pool[1], pool[0])
    # the JAX rule reads nothing of the port's pair: the fault this repairs
    for rel in POOL_PAIR:
        assert _kinds(jax_extract_wire_kinds(jax_load_module(PORT / rel)[0])) == ([], [])


def test_pipe_kind_rename_is_flagged_by_the_port_and_missed_by_jax(tmp_path):
    worker = (PORT / POOL_PAIR[1]).read_text()
    anchor = "channel.send(('result_shm', current['token'], descriptor.to_bytes()))"
    assert anchor in worker
    (tmp_path / 'process_worker_main.py').write_text(
        worker.replace(anchor, anchor.replace("'result_shm'", "'result_v2'")))
    shutil.copy(PORT / POOL_PAIR[0], tmp_path / 'process_pool.py')
    report = run_pipecheck(paths=[str(tmp_path)], rules=['protocol-conformance'])
    messages = [f.format() for f in report.findings]
    assert len(messages) == 2, messages
    assert "'result_v2' is sent but no protocol peer dispatches" in messages[0] + messages[1]
    assert "'result_shm' is dispatched on but never sent" in messages[0] + messages[1]
    # the JAX analyzer over the same mutated copy: nothing, which is why the
    # port needs its own rule
    assert jax_run_pipecheck(paths=[str(tmp_path)], rules=['protocol-conformance']).clean
    # the unmutated pair is clean under the port's rule
    shutil.copy(PORT / POOL_PAIR[1], tmp_path / 'process_worker_main.py')
    assert run_pipecheck(paths=[str(tmp_path)], rules=['protocol-conformance']).clean


@pytest.mark.parametrize('mutation,needles', [
    # the pool stops dispatching on a kind the worker sends
    (('process_pool.py', "if kind == 'heartbeat':", "if kind == 'heart_beat':"),
     ["'heartbeat' is sent", "'heart_beat' is dispatched on"]),
    # the pool sends a kind through its _send helper that the worker ignores
    (('process_pool.py', "self._send(worker, ('stop',))", "self._send(worker, ('halt',))"),
     ["'halt' is sent", "'stop' is dispatched on"]),
    # the worker dispatches on message[0] under a name nobody sends
    (('process_worker_main.py', "if message[0] == 'release':", "if message[0] == 'relaese':"),
     ["'relaese' is dispatched on"]),
])
def test_pipe_kind_drift_in_either_file(tmp_path, mutation, needles):
    name, old, new = mutation
    for rel in POOL_PAIR:
        shutil.copy(PORT / rel, tmp_path / os.path.basename(rel))
    text = (tmp_path / name).read_text()
    assert old in text, old
    (tmp_path / name).write_text(text.replace(old, new))
    report = run_pipecheck(paths=[str(tmp_path)], rules=['protocol-conformance'])
    text = '\n'.join(f.format() for f in report.findings)
    for needle in needles:
        assert needle in text, text


def test_bytes_and_str_kinds_of_one_name_do_not_match(tmp_path):
    """A ZMQ-style bytes producer and a pipe-style str consumer disagree, as
    they would on the wire."""
    (tmp_path / 'process_worker_main.py').write_text(
        "def loop(channel, socket):\n"
        "    socket.send(b'ready')\n")
    (tmp_path / 'process_pool.py').write_text(
        "def dispatch(message):\n"
        "    if message[0] == 'ready':\n"
        "        return True\n")
    report = run_pipecheck(paths=[str(tmp_path)], rules=['protocol-conformance'])
    text = '\n'.join(f.format() for f in report.findings)
    assert "b'ready' is sent" in text and "'ready' is dispatched on" in text


# ------------------------------------------------------------------- the CLI


def test_cli_exit_codes_json_and_rule_list(capsys):
    bad = str(FIXTURES / 'telemetry' / 'bad_stage.py')
    assert pipecheck_main([bad, '--rules', 'telemetry-names', '--json']) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc['clean'] is False and doc['by_rule'] == {'telemetry-names': 2}
    assert set(doc['rule_seconds']) == {'telemetry-names'}
    assert doc['callgraph_functions'] == 0
    assert 'petastorm_tpu_torch/telemetry/spans.py' in doc['findings'][0]['message']
    assert pipecheck_main([str(FIXTURES / 'protocol' / 'good_kinds')]) == 0
    assert 'pipecheck: clean' in capsys.readouterr().out
    assert pipecheck_main(['--list-rules']) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listed] == [cls.name for cls in ALL_RULES]
    assert pipecheck_main(['--rules', 'no-such-rule']) == 2
    assert 'unknown rule' in capsys.readouterr().err


def test_cli_default_target_is_the_port():
    assert package_root() == PORT
    # found from the analysis package's own file: the CLI imports no torch
    code = ('import sys; from petastorm_tpu_torch.analysis.cli import package_root; '
            'print(package_root()); print("torch" in sys.modules)')
    result = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                            text=True, timeout=60, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.split() == [str(PORT), 'False']


def _git(repo, *argv):
    subprocess.run(['git', '-C', str(repo)] + list(argv), check=True, capture_output=True,
                   env=dict(os.environ, GIT_AUTHOR_NAME='t', GIT_AUTHOR_EMAIL='t@t',
                            GIT_COMMITTER_NAME='t', GIT_COMMITTER_EMAIL='t@t'))


def test_cli_diff_base(tmp_path, capsys):
    src = (FIXTURES / 'exceptions' / 'bad_swallow.py').read_text()
    _git(tmp_path, 'init', '-q')
    (tmp_path / 'old_bad.py').write_text(src)
    _git(tmp_path, 'add', '.')
    _git(tmp_path, 'commit', '-q', '-m', 'seed')
    (tmp_path / 'new_bad.py').write_text(src)
    _git(tmp_path, 'add', 'new_bad.py')
    full = run_pipecheck(paths=[str(tmp_path)], rules=['exception-hygiene'])
    assert len(full.findings) == 2
    assert pipecheck_main([str(tmp_path), '--rules', 'exception-hygiene',
                           '--diff-base', 'HEAD', '--json']) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc['finding_count'] == 1
    assert all('new_bad.py' in f['path'] for f in doc['findings'])
    assert any('--diff-base HEAD' in note for note in doc['notes'])
    assert pipecheck_main([str(tmp_path), '--diff-base', 'no-such-ref']) == 2
    assert '--diff-base' in capsys.readouterr().err


def test_throughput_cli_pipecheck(capsys):
    from petastorm_tpu_torch.benchmark.cli import main as throughput_main
    assert throughput_main(['pipecheck', str(FIXTURES / 'protocol' / 'good_kinds')]) == 0
    assert 'pipecheck: clean' in capsys.readouterr().out
    assert throughput_main(['pipecheck', str(FIXTURES / 'protocol' / 'bad_kinds'),
                            '--rules', 'protocol-conformance']) == 1
    assert "b'result_v2'" in capsys.readouterr().out


# ---------------------------------------------------------------- the doctor


def test_doctor_pipecheck_block(monkeypatch, port_report):
    import petastorm_tpu_torch.analysis as analysis
    from petastorm_tpu_torch.tools import doctor
    monkeypatch.setattr(analysis, 'run_pipecheck', lambda: port_report)
    block = doctor.check_pipecheck()
    assert block == {'status': 'ok', 'findings': 0, 'suppressed': 2,
                     'files': port_report.files,
                     'callgraph_functions': port_report.callgraph_functions,
                     'by_rule': {}, 'first': None}
    assert doctor.pipecheck_line(block) == (
        '  pipecheck: clean: {} files, {} call-graph function(s), 2 suppression(s) honored '
        '(docs/static-analysis.md)'.format(port_report.files, port_report.callgraph_functions))
    dirty = run_pipecheck(paths=[str(FIXTURES / 'telemetry' / 'bad_stage.py')],
                          rules=['telemetry-names'])
    monkeypatch.setattr(analysis, 'run_pipecheck', lambda: dirty)
    block = doctor.check_pipecheck()
    assert block['status'] == 'findings' and block['findings'] == 2
    assert block['by_rule'] == {'telemetry-names': 2} and 'decodee' in block['first']
    line = doctor.pipecheck_line(block)
    assert line.startswith('  WARNING: pipecheck found 2 data-plane invariant violation(s) '
                           '(telemetry-names=2); first: ')
    assert doctor.pipecheck_line({'status': 'fail', 'detail': 'boom'}) == \
        '  pipecheck: FAIL (boom): the analyzer itself errored'
    assert doctor.pipecheck_line({}) is None


# -------------------------------------------------------------- the boundary


def test_no_analysis_string_names_a_jax_module():
    """Module names handed to the resolver are strings the import scan of
    ``test_torch_import_boundary.py`` cannot see: none may name the JAX
    package (whole dotted components), and each journal's resolves to the
    port's own file."""
    jax_name = re.compile(r'^petastorm_tpu(\.|$)')
    offenders = []
    for path in _py_files(PORT / 'analysis'):
        tree = ast.parse(path.read_text())
        docstrings = {id(node.value) for node in ast.walk(tree)
                      if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
        offenders.extend((path.name, node.value) for node in ast.walk(tree)
                         if isinstance(node, ast.Constant) and isinstance(node.value, str)
                         and id(node) not in docstrings and jax_name.match(node.value))
    assert offenders == []
    for row in JOURNAL_REGISTRIES:
        source = installed_source(row[4])
        assert source is not None and source == PORT / Path(*row[4].split('.')[1:]).with_suffix(
            '.py'), row


_FALLBACK_TREE = {
    'mod.py': textwrap.dedent('''
        def f(registry, catalog, ledger, history):
            with stage_span('decodee'):
                pass
            catalog.knob('pool_wrokers')
            record = QuarantineRecord(path='x', reason='cosmic-ray')
            ledger.append_record('rebalanced')
            history.build_run_record('conductor')
            return record
        '''),
    'parallel/topology.py': textwrap.dedent('''
        def replay(kind):
            if kind == 'jion':
                return True
            return False
        '''),
}

_BOUNDARY_RUN = textwrap.dedent('''
    import importlib.abc, json, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                                      'petastorm_tpu'):
                raise ImportError('blocked import of ' + name)
            return None

    sys.meta_path.insert(0, Refuse())
    from petastorm_tpu_torch.analysis import run_pipecheck
    report = run_pipecheck(paths=[sys.argv[1]])
    print(json.dumps({'findings': [f.as_dict() for f in report.findings],
                      'notes': report.notes,
                      'loaded': sorted(m for m in sys.modules
                                       if m.split('.')[0] in ('torch', 'zmq', 'pyarrow', 'jax',
                                                              'petastorm_tpu'))}))
''')


def test_fallbacks_resolve_to_the_port_without_torch_zmq_or_jax(tmp_path):
    tree = tmp_path / 'tree'
    for rel, text in _FALLBACK_TREE.items():
        (tree / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree / rel).write_text(text)
    result = subprocess.run([sys.executable, '-c', _BOUNDARY_RUN, str(tree)], cwd=tmp_path,
                            capture_output=True, text=True, timeout=120,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert result.returncode == 0, result.stderr[-3000:]
    doc = json.loads(result.stdout.splitlines()[-1])
    assert doc['loaded'] == []
    # no fallback went unresolved (journal-discipline notes a missing registry)
    assert not any('registry found' in note for note in doc['notes'])
    by_rule = {}
    for finding in doc['findings']:
        by_rule.setdefault(finding['rule'], []).append(finding['message'])
    text = '\n'.join(sum(by_rule.values(), []))
    spans = str(PORT / 'telemetry' / 'spans.py')
    knobs = str(PORT / 'autotune' / 'knobs.py')
    assert "'decodee'" in text and spans in text
    assert "'pool_wrokers'" in text and knobs in text
    assert "'cosmic-ray'" in text and "('error', 'hang')" in text
    assert "'rebalanced'" in text and 'LEDGER_RECORD_KINDS' in text
    assert "'conductor'" in text and 'RUN_RECORD_OWNERS' in text
    assert "'jion'" in text and 'TOPOLOGY_RECORD_KINDS' in text
    assert len(by_rule['telemetry-names']) == 2
    assert len(by_rule['protocol-conformance']) == 1
    assert len(by_rule['journal-discipline']) == 3
    assert 'petastorm_tpu/' not in text.replace('petastorm_tpu_torch/', '')
