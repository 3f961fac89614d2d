"""The port's chaos harness (``petastorm_tpu_torch.test_util.chaos``) held
against the JAX package's: rule validation, seeded trigger rows equal to
JAX's for each seed and horizon, once-only firing across observers; one
control-plane chaos epoch over a ledger-armed fleet (dispatcher killed,
worker SIGKILLed, client partitioned, a ledger frame corrupted) with rows
exact and a lineage digest equal to the undisturbed run's; and the CLI's
``chaos --hosts 2 --kill-host`` in a child interpreter exiting 0."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import petastorm_tpu.test_util.chaos as jax_chaos
from petastorm_tpu_torch.benchmark.cli import main as cli_main
from petastorm_tpu_torch.test_util.chaos import (CHAOS_KINDS, ChaosRule, ChaosSchedule,
                                                 run_chaos_epoch)

ROWS = 200
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """200 rows ``idx``/``vec`` in 8 files of one rowgroup, written by the port."""
    import pyarrow as pa
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('ChaosProbe', [
        UnischemaField('idx', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('vec', np.float32, (16,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('chaos') / 'store')
    write_rows(url, schema, [{'idx': i, 'vec': np.full(16, i, np.float32)}
                             for i in range(ROWS)], rows_per_file=25, rowgroup_size_mb=1)
    return url


def test_rule_validation_as_jax():
    assert CHAOS_KINDS == jax_chaos.CHAOS_KINDS
    for module in (sys.modules[ChaosRule.__module__], jax_chaos):
        with pytest.raises(ValueError):
            module.ChaosRule('split_brain')
        with pytest.raises(ValueError):
            module.ChaosRule('kill_worker', at=0)
    assert ChaosRule('kill_worker', at=3, worker_index=1).as_dict() == \
        jax_chaos.ChaosRule('kill_worker', at=3, worker_index=1).as_dict()


@pytest.mark.parametrize('seed,horizon', [(0, 4), (7, 200), (1234, 50000), (99, 61)])
def test_seeded_resolution_equals_jax(tmp_path, seed, horizon):
    def resolved(module, state_dir):
        rules = [module.ChaosRule(kind) for kind in CHAOS_KINDS[:4]] + \
            [module.ChaosRule('kill_worker', at=5)]
        return [rule.at for rule in module.ChaosSchedule(state_dir, rules, seed=seed)
                .resolve(horizon).rules]
    ours = resolved(sys.modules[ChaosRule.__module__], str(tmp_path / 'a'))
    assert ours == resolved(jax_chaos, str(tmp_path / 'b'))
    assert all(horizon // 4 <= at < 3 * horizon // 4 for at in ours[:4])
    with pytest.raises(ValueError):
        ChaosSchedule(str(tmp_path / 'c'), [ChaosRule('kill_worker')]).resolve(3)


def test_rules_fire_exactly_once(tmp_path):
    rules = [ChaosRule('kill_dispatcher', at=3), ChaosRule('kill_worker', at=10)]
    schedule = ChaosSchedule(str(tmp_path), rules, seed=0)
    assert schedule.due(2) == []
    assert [index for index, _ in schedule.due(5)] == [0]
    assert schedule.due(6) == [] and schedule.fired_count() == 1
    # the marker file makes the firing once-only for every observer
    assert ChaosSchedule(str(tmp_path), rules).due(5) == []
    assert [index for index, _ in ChaosSchedule(str(tmp_path), rules).due(10)] == [1]

    class Fleet(object):
        crashes = 0

        def crash_dispatcher(self):
            self.crashes += 1
    fleet = Fleet()
    report = run_chaos_epoch(iter(range(4)), fleet,
                             ChaosSchedule(str(tmp_path / 'run'), rules[:1]))
    assert report['rows'] == 4 and fleet.crashes == 1
    assert report['fired'] == [dict(rules[0].as_dict(), row=3)]


def test_control_plane_chaos_epoch_rows_and_digest_exact(store, tmp_path, capsys,
                                                         monkeypatch):
    """The CLI in this process: a baseline epoch on one fleet, then the same
    seed on a ledger-armed fleet with the dispatcher killed (a ledger frame
    corrupted first), a worker SIGKILLed and the client silenced; the
    staleness and silence windows are shortened to 3 s and 2 s."""
    monkeypatch.setenv('PETASTORM_TPU_SERVICE_RESPONSE_TIMEOUT_S', '2.0')
    code = cli_main(['chaos', store, '--workdir', str(tmp_path), '--seed', '11',
                     '--stale-timeout-s', '3', '--partition-s', '0.5', '--corrupt-ledger',
                     '--json'])
    verdict = json.loads(capsys.readouterr().out)
    assert code == 0, verdict
    assert verdict['rows_baseline'] == verdict['rows_chaos'] == ROWS
    assert sorted(rule['kind'] for rule in verdict['fired']) == [
        'corrupt_ledger', 'kill_dispatcher', 'kill_worker', 'partition_client']
    assert (verdict['verify_exit_code'], verdict['diff_exit_code']) == (0, 0)
    assert verdict['ledger']['frames_dropped'] >= 1


def test_cli_hosts_kill_host_exits_zero_in_a_child(store, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.benchmark.cli', 'chaos',
                          store, '--hosts', '2', '--kill-host', '--workdir', str(tmp_path),
                          '--json'], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    verdict = json.loads(out.stdout)
    assert verdict['mode'] == 'kill_host' and verdict['rows_chaos'] == ROWS
    assert verdict['digest_exact'] and verdict['diff_attribution'] == 'topology'
    assert verdict['digest_chaos'] == verdict['digest_baseline'] and \
        len(verdict['digest_chaos']) == 32
