"""Seeded mutations of the port's own modules, each the drift one rule of the
port's pipecheck (``petastorm_tpu_torch.analysis``) exists to catch: the
mutation tests of ``tests/test_pipecheck.py`` redone on
``petastorm_tpu_torch/``, anchored on the port's text, each with the
unmutated copy clean where the JAX test holds that too. Then the mypy
ratchet with a temporary ``mypy.ini`` and manifest: scoped to the analyzed
package by whole dotted components, and with the JAX package and manifest
giving the JAX rule's verdict."""

import configparser
import shutil
from pathlib import Path

import pytest

from petastorm_tpu.analysis import run_pipecheck as jax_run_pipecheck
from petastorm_tpu_torch.analysis import run_pipecheck
from petastorm_tpu_torch.analysis.rules.ratchet import (DEFAULT_MANIFEST, pattern_in_scope,
                                                        ratchet_scope, read_manifest,
                                                        root_package)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'petastorm_tpu_torch'
JAX_PKG = REPO / 'petastorm_tpu'
JAX_MANIFEST = JAX_PKG / 'analysis' / 'strict_modules.txt'
STRICT_FLAGS = ('disallow_untyped_defs', 'disallow_incomplete_defs',
                'no_implicit_optional', 'warn_return_any')


def run(paths, rules=None, **kwargs):
    return run_pipecheck(paths=[str(p) for p in paths], rules=rules, **kwargs)


def messages(report):
    return [finding.format() for finding in report.findings]


def _copy_mutated(src, dst, old, new):
    text = src.read_text()
    assert old in text, 'mutation anchor {!r} vanished from {}'.format(old, src)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text.replace(old, new))
    return dst


def test_mutation_typo_stage_name_in_worker_span(tmp_path):
    _copy_mutated(PORT / 'workers' / 'process_worker_main.py',
                  tmp_path / 'process_worker_main.py',
                  "stage_span('serialize')", "stage_span('seralize')")
    report = run([tmp_path], rules=['telemetry-names'])
    assert len(report.findings) == 1, messages(report)
    assert "'seralize'" in report.findings[0].message
    assert str(PORT / 'telemetry' / 'spans.py') in report.findings[0].message


def test_mutation_typo_knob_id_in_builder(tmp_path):
    _copy_mutated(PORT / 'autotune' / 'knobs.py', tmp_path / 'knob_builders.py',
                  "'pool_workers'", "'pool_wrokers'")
    report = run([tmp_path], rules=['telemetry-names'])
    text = '\n'.join(messages(report))
    assert "'pool_wrokers'" in text and 'KNOB_IDS' in text, text
    assert str(PORT / 'autotune' / 'knobs.py') in text


def test_mutation_service_kind_sent_but_not_dispatched(tmp_path):
    """The service trio still speaks ZMQ bytes: the bytes extraction holds it."""
    _copy_mutated(PORT / 'service' / 'service_worker.py', tmp_path / 'service_worker.py',
                  "[b'w_result', current_token[0]", "[b'w_result_v2', current_token[0]")
    for name in ('dispatcher.py', 'service_client.py'):
        shutil.copy(PORT / 'service' / name, tmp_path / name)
    report = run([tmp_path], rules=['protocol-conformance'])
    text = '\n'.join(messages(report))
    assert "b'w_result_v2'" in text and 'no protocol peer dispatches' in text
    assert "b'w_result'" in text and 'never sent' in text
    shutil.copy(PORT / 'service' / 'service_worker.py', tmp_path / 'service_worker.py')
    assert run([tmp_path], rules=['protocol-conformance']).clean


def test_mutation_service_descriptor_key_drift(tmp_path):
    _copy_mutated(PORT / 'service' / 'wire.py', tmp_path / 'wire.py',
                  "'heartbeat_interval_s': self.heartbeat_interval_s",
                  "'hb_interval_s': self.heartbeat_interval_s")
    report = run([tmp_path], rules=['protocol-conformance'])
    text = '\n'.join(messages(report))
    assert "'hb_interval_s'" in text and 'never read' in text
    assert "'heartbeat_interval_s'" in text and 'never written' in text


def test_mutation_sidecar_key_dropped_from_deserialize(tmp_path):
    _copy_mutated(PORT / 'workers' / 'serializers.py', tmp_path / 'serializers.py',
                  "breakers=meta['breakers']", 'breakers=None')
    report = run([tmp_path], rules=['protocol-conformance'])
    text = '\n'.join(messages(report))
    assert "'breakers'" in text and 'never read back' in text, text
    shutil.copy(PORT / 'workers' / 'serializers.py', tmp_path / 'serializers.py')
    assert run([tmp_path], rules=['protocol-conformance']).clean


def test_mutation_wall_clock_call_in_resilience(tmp_path):
    src = PORT / 'resilience.py'
    dst = tmp_path / 'resilience.py'
    dst.write_text(src.read_text() + '\n_BOOTED_AT = time.time()\n')
    report = run([tmp_path], rules=['clock-discipline'])
    assert len(report.findings) == 1, messages(report)
    assert 'time.time' in report.findings[0].message
    shutil.copy(src, dst)
    assert run([tmp_path], rules=['clock-discipline']).clean


def test_mutation_undeclared_quarantine_reason(tmp_path):
    """The port's resilience declares the registry the JAX one does, so a
    construction site under an undeclared reason surfaces."""
    _copy_mutated(PORT / 'reader_worker.py', tmp_path / 'reader_worker.py',
                  "reason='hang'", "reason='hung'")
    report = run([tmp_path], rules=['protocol-conformance'])
    text = '\n'.join(messages(report))
    assert "'hung'" in text and 'QUARANTINE_REASONS' in text, text
    shutil.copy(PORT / 'reader_worker.py', tmp_path / 'reader_worker.py')
    assert run([tmp_path], rules=['protocol-conformance']).clean


def test_mutation_deleted_shm_close_leaks_on_normal_path(tmp_path):
    _copy_mutated(PORT / 'service' / 'service_worker.py', tmp_path / 'service_worker.py',
                  '        name = segment.name\n        segment.close()\n',
                  '        name = segment.name\n')
    report = run([tmp_path], rules=['resource-lifecycle'])
    text = '\n'.join(messages(report))
    assert 'released only on the error path' in text, text
    shutil.copy(PORT / 'service' / 'service_worker.py', tmp_path / 'service_worker.py')
    assert run([tmp_path], rules=['resource-lifecycle']).clean


def test_mutation_dropped_sorted_in_reshard_deal(tmp_path):
    _copy_mutated(PORT / 'parallel' / 'topology.py', tmp_path / 'parallel' / 'topology.py',
                  'in sorted(assignments.items())},', 'in assignments.items()},')
    report = run([tmp_path], rules=['determinism'])
    text = '\n'.join(messages(report))
    assert '.items()' in text and 'sorted' in text, text
    shutil.copy(PORT / 'parallel' / 'topology.py', tmp_path / 'parallel' / 'topology.py')
    assert run([tmp_path], rules=['determinism']).clean


def test_mutation_unregistered_journal_kind(tmp_path):
    _copy_mutated(PORT / 'service' / 'ledger.py', tmp_path / 'ledger.py',
                  "self.append_record('epoch', epoch=self._epoch)",
                  "self.append_record('rebalanced', epoch=self._epoch)")
    report = run([tmp_path], rules=['journal-discipline'])
    text = '\n'.join(messages(report))
    assert "'rebalanced'" in text and 'LEDGER_RECORD_KINDS' in text, text


def test_mutation_blocking_helper_under_ledger_lock(tmp_path):
    dst = _copy_mutated(
        PORT / 'service' / 'ledger.py', tmp_path / 'ledger.py',
        "        snapshot = {'kind': 'epoch', 'epoch': self._epoch,",
        "        time.sleep(0.05)\n"
        "        snapshot = {'kind': 'epoch', 'epoch': self._epoch,")
    report = run([tmp_path], rules=['lock-discipline'])
    text = '\n'.join(messages(report))
    assert '_rotate' in text and 'time.sleep' in text, text
    shutil.copy(PORT / 'service' / 'ledger.py', dst)
    assert run([tmp_path], rules=['lock-discipline']).clean


def test_mutation_generic_raise_in_the_port_worker(tmp_path):
    """The raise taxonomy names the port's own errors module."""
    _copy_mutated(PORT / 'workers' / 'process_worker_main.py',
                  tmp_path / 'workers' / 'process_worker_main.py',
                  "continue  # unknown kind from a newer pool: ignore",
                  "raise Exception('unknown kind')")
    report = run([tmp_path], rules=['exception-hygiene'])
    assert len(report.findings) == 1, messages(report)
    assert 'petastorm_tpu_torch.errors type' in report.findings[0].message


# ------------------------------------------------------------------ ratchet


def _write_strict_ini(path, entries, weaken=None):
    lines = ['[mypy]', 'files = petastorm_tpu_torch', '']
    for entry in entries:
        lines.append('[mypy-{}]'.format(entry))
        for flag in STRICT_FLAGS:
            value = not (weaken and entry == weaken and flag == 'warn_return_any')
            lines.append('{} = {}'.format(flag, value))
        lines.append('')
    path.write_text('\n'.join(lines))


def _write_manifest(path, entries):
    path.write_text('# test manifest\n' + ''.join(e + '\n' for e in entries))
    return path


PORT_ENTRIES = ['petastorm_tpu_torch.analysis.*', 'petastorm_tpu_torch.errors',
                'petastorm_tpu_torch.resilience']


def test_ratchet_shipped_manifest_is_empty_and_the_port_consistent():
    assert DEFAULT_MANIFEST == PORT / 'analysis' / 'strict_modules.txt'
    assert read_manifest(DEFAULT_MANIFEST) == []
    assert DEFAULT_MANIFEST.read_text().startswith('# mypy-strict ratchet manifest')
    # the repo's mypy.ini holds strict sections of the JAX package only:
    # none is in the port's scope, so the port's ratchet is clean against it
    parser = configparser.ConfigParser()
    parser.read(REPO / 'mypy.ini')
    strict = [s[len('mypy-'):] for s in parser.sections() if s.startswith('mypy-')
              and all(parser.getboolean(s, flag, fallback=False) for flag in STRICT_FLAGS)]
    assert strict and not any(pattern_in_scope(s, {'petastorm_tpu_torch'}) for s in strict)
    report = run([PORT / 'errors.py'], rules=['mypy-ratchet'], mypy_ini=str(REPO / 'mypy.ini'))
    assert report.clean and report.notes == [], messages(report)


@pytest.mark.parametrize('pattern,packages,inside', [
    ('petastorm_tpu_torch.errors', {'petastorm_tpu_torch'}, True),
    ('petastorm_tpu_torch.analysis.*', {'petastorm_tpu_torch'}, True),
    ('petastorm_tpu_torch.*', {'petastorm_tpu_torch'}, True),
    ('petastorm_tpu.errors', {'petastorm_tpu_torch'}, False),
    ('petastorm_tpu_torch.errors', {'petastorm_tpu'}, False),
    ('petastorm_tpu_torchx.errors', {'petastorm_tpu_torch'}, False),
    ('petastorm_tpu.analysis.*', {'petastorm_tpu'}, True),
])
def test_ratchet_scope_matches_whole_components(pattern, packages, inside):
    assert pattern_in_scope(pattern, packages) is inside


def test_ratchet_scope_of_the_analyzed_roots(tmp_path):
    assert root_package(PORT) == 'petastorm_tpu_torch'
    assert root_package(PORT / 'workers') == 'petastorm_tpu_torch.workers'
    assert root_package(PORT / 'errors.py') == 'petastorm_tpu_torch'
    assert root_package(JAX_PKG) == 'petastorm_tpu'
    assert root_package(tmp_path) is None
    # a tree that is no package is scoped to the analyzer's own package
    assert ratchet_scope([tmp_path]) == {'petastorm_tpu_torch'}
    assert ratchet_scope([JAX_PKG, tmp_path]) == {'petastorm_tpu'}


def test_mutation_strict_module_dropped_from_mypy_ini(tmp_path):
    ini = tmp_path / 'mypy.ini'
    _write_strict_ini(ini, [e for e in PORT_ENTRIES if e != 'petastorm_tpu_torch.resilience'])
    manifest = _write_manifest(tmp_path / 'strict.txt', PORT_ENTRIES)
    report = run([tmp_path], rules=['mypy-ratchet'], mypy_ini=str(ini), manifest=str(manifest))
    assert len(report.findings) == 1, messages(report)
    assert 'petastorm_tpu_torch.resilience' in report.findings[0].message
    assert 'only grow' in report.findings[0].message


def test_mutation_strict_section_weakened(tmp_path):
    ini = tmp_path / 'mypy.ini'
    _write_strict_ini(ini, PORT_ENTRIES, weaken='petastorm_tpu_torch.errors')
    manifest = _write_manifest(tmp_path / 'strict.txt', PORT_ENTRIES)
    report = run([tmp_path], rules=['mypy-ratchet'], mypy_ini=str(ini), manifest=str(manifest))
    assert len(report.findings) == 1, messages(report)
    assert 'warn_return_any' in report.findings[0].message


def test_ratchet_unlisted_strict_section_must_join_manifest(tmp_path):
    ini = tmp_path / 'mypy.ini'
    # a strict section of the port outside the manifest is a finding; strict
    # sections of the JAX package (and of a name sharing the port's prefix)
    # lie outside the port's scope
    _write_strict_ini(ini, PORT_ENTRIES + ['petastorm_tpu_torch.zzz_new', 'petastorm_tpu.zzz',
                                           'petastorm_tpu_torchx.zzz'])
    manifest = _write_manifest(tmp_path / 'strict.txt', PORT_ENTRIES)
    report = run([tmp_path], rules=['mypy-ratchet'], mypy_ini=str(ini), manifest=str(manifest))
    assert len(report.findings) == 1, messages(report)
    assert "'petastorm_tpu_torch.zzz_new'" in report.findings[0].message
    assert 'strict_modules.txt' in report.findings[0].message


def test_ratchet_manifest_hygiene(tmp_path):
    ini = tmp_path / 'mypy.ini'
    _write_strict_ini(ini, PORT_ENTRIES)
    manifest = _write_manifest(tmp_path / 'strict.txt',
                               list(reversed(PORT_ENTRIES)) + [PORT_ENTRIES[0]])
    report = run([tmp_path], rules=['mypy-ratchet'], mypy_ini=str(ini), manifest=str(manifest))
    text = '\n'.join(messages(report))
    assert 'not sorted' in text and 'duplicate manifest entry' in text, text


@pytest.mark.parametrize('drop', [None, 'petastorm_tpu.resilience'])
def test_ratchet_over_the_jax_package_gives_the_jax_verdict(tmp_path, drop):
    """With the JAX manifest and the package ``petastorm_tpu`` the port's
    rule agrees with the JAX rule, on the repo's mypy.ini and on one that
    lost a promoted section."""
    entries = read_manifest(JAX_MANIFEST)
    ini = REPO / 'mypy.ini'
    if drop is not None:
        assert drop in entries
        ini = tmp_path / 'mypy.ini'
        _write_strict_ini(ini, [e for e in entries if e != drop])
    target = [str(JAX_PKG / 'errors.py')]
    report = run_pipecheck(paths=target, rules=['mypy-ratchet'], mypy_ini=str(ini),
                           manifest=str(JAX_MANIFEST))
    jax_report = jax_run_pipecheck(paths=target, rules=['mypy-ratchet'], mypy_ini=str(ini),
                                   manifest=str(JAX_MANIFEST))
    assert messages(report) == messages(jax_report)
    assert len(report.findings) == (0 if drop is None else 1)
