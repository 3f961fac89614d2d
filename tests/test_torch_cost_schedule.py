"""The cost profiler and the cost-aware scheduler of petastorm_tpu_torch held
against the JAX package: ledgers folded from one trace snapshot are equal
(``to_dict``), a ledger file written by either package loads in the other,
the scheduler's plans and orders equal the JAX scheduler's for skewed,
uniform and empty ledgers and several seeds, a scheduled ``make_reader``
delivers the JAX reader's items and rows in its order (splits on, with a
predicate), and the dataset tokens and sidecar paths are equal. The unit
cases mirror ``tests/test_schedule.py``'s reader and scheduler cases; its
service cases wait for the port's ``service/``. Every comparison is exact."""

import json
import os

import numpy as np
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.dataset_state import derive_dataset_token as jax_derive_dataset_token
from petastorm_tpu.dataset_state import sidecar_path as jax_sidecar_path
from petastorm_tpu.predicates import in_lambda as jax_in_lambda
from petastorm_tpu.schedule import CostAwareScheduler as JaxScheduler
from petastorm_tpu.schedule import SchedulePolicy as JaxPolicy
from petastorm_tpu.schedule import plan_preview as jax_plan_preview
from petastorm_tpu.telemetry.cost_model import CostLedger as JaxLedger
from petastorm_tpu.telemetry.cost_model import format_cost_report as jax_format_cost_report
from petastorm_tpu.telemetry.cost_model import default_ledger_path as jax_default_ledger_path
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.dataset_state import (cache_state_home, derive_dataset_token,
                                               local_state_home, sidecar_path)
from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups, open_dataset, write_rows
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
from petastorm_tpu_torch.schedule import (MAX_COST_HINT, MIN_COST_HINT, CostAwareScheduler,
                                          SchedulePolicy, load_ledger, plan_preview,
                                          resolve_schedule_policy)
from petastorm_tpu_torch.telemetry.cost_model import (CostLedger, default_ledger_path,
                                                      format_cost_report, percentile)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

ROWS = 60
ROWS_PER_FILE = 8

Schema = Unischema('CostScheduleSchema', [
    UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
])


# --------------------------------------------------------------- helpers

def build_ledger(cls, token, costs, stage='decode'):
    """A ledger of ``cls`` with one ``stage`` cell per ``{key: seconds}``."""
    ledger = cls(token)
    for key, seconds in costs.items():
        entry = ledger._entry(key)
        entry['stages'][stage] = {'count': 1, 'sum_s': float(seconds),
                                  'max_s': float(seconds)}
    return ledger


def make_items(n, drop_parts=1):
    return [{'piece_index': piece, 'fragment_path': 'frag.parquet', 'row_group_id': piece,
             'shuffle_row_drop_partition': (drop, drop_parts)}
            for piece in range(n) for drop in range(drop_parts)]


def make_locator(n, rows=10):
    return {piece: ('frag.parquet', piece, rows) for piece in range(n)}


def scheduler_for(costs, policy=None, token='tok'):
    ledger = build_ledger(CostLedger, token, costs) if costs else None
    return CostAwareScheduler(token, policy or SchedulePolicy(), ledger=ledger)


def twin_plans(costs, seed, n, rows, drop_parts=1, policy_kwargs=None, max_parts=4):
    """(port, JAX) results of plan_items + order_items on the same ledger."""
    out = []
    for ledger_cls, sched_cls, policy_cls in ((CostLedger, CostAwareScheduler,
                                               SchedulePolicy),
                                              (JaxLedger, JaxScheduler, JaxPolicy)):
        ledger = build_ledger(ledger_cls, 'tok', costs) if costs is not None else None
        sched = sched_cls('tok', policy_cls(**(policy_kwargs or {})), ledger=ledger)
        items, virtual = sched.plan_items(make_items(n, drop_parts), make_locator(n, rows),
                                          max_parts=max_parts)
        rng = None if seed is None else np.random.RandomState(seed)
        orders = [[(item['piece_index'], item['shuffle_row_drop_partition'],
                    item.get('row_range')) for item in sched.order_items(items, rng)]
                  for _ in range(2)]   # two epochs: the second reorders the first
        out.append({'planned': [(i['piece_index'], i.get('row_range')) for i in items],
                    'virtual': virtual, 'orders': orders,
                    'fingerprint': sched.plan_fingerprint(), 'report': sched.report()})
    return out


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('cost_schedule') / 'store')
    rng = np.random.RandomState(0)
    write_rows('file://' + path, Schema,
               [{'idx': i, 'vec': rng.rand(4).astype(np.float32)} for i in range(ROWS)],
               rows_per_file=ROWS_PER_FILE)
    row_groups = load_row_groups(open_dataset('file://' + path))
    keys = ['{}#{}'.format(rg.fragment_path, rg.row_group_id) for rg in row_groups]
    return {'url': 'file://' + path, 'path': path, 'keys': keys,
            'rows': [rg.row_group_num_rows for rg in row_groups]}


def skewed_costs(keys):
    """Most rowgroups light, one past the split threshold, one heavy."""
    costs = {key: 0.01 for key in keys}
    costs[keys[2]] = 1.0
    costs[keys[5]] = 0.03
    return costs


def save_ledger(store, costs, ledger_cls=CostLedger):
    """``costs`` as a ledger at the store's default sidecar path (the token
    is the same in both packages); returns the path."""
    with make_reader(store['url'], reader_pool_type='dummy') as reader:
        token = reader.dataset_token
    path = default_ledger_path(store['url'], token)
    build_ledger(ledger_cls, token, costs).save(path)
    return path


def read_items(factory, url, rows_field='idx', **kwargs):
    """One epoch's (item_ids, row values, schedule report) in arrival order."""
    ids, rows = [], []
    with factory(url, reader_pool_type='dummy', num_epochs=1, **kwargs) as reader:
        for batch in reader.iter_columnar(include_empty=True):
            ids.append(tuple(int(part) for part in batch.item_id))
            if batch.num_rows:
                rows.extend(np.asarray(batch.columns[rows_field]).tolist())
        report = reader.diagnostics.get('schedule')
    return ids, rows, report


# ---------------------------------------------------------------- ledger

def _trace_snapshot():
    """A flight-recorder snapshot with every span kind the ledger folds (and
    some it must skip)."""
    events = []
    rng = np.random.RandomState(3)
    for piece in range(5):
        for name in ('rowgroup_read', 'decode', 'decode', 'range_fetch', 'transform'):
            args = ({'bytes': 100 + piece, 'ranges': 2, 'hedges_fired': piece % 2,
                     'hedges_won': 0} if name == 'range_fetch' else {})
            events.append({'pid': 1, 'tid': 2, 'ts_us': 0.0, 'ph': 'X', 'name': name,
                           'dur_us': float(rng.randint(1, 5000)), 'ctx': [0, piece, 0],
                           'args': args})
        events.append({'pid': 1, 'tid': 2, 'ts_us': 0.0, 'ph': 'X', 'name': 'decode_field',
                       'dur_us': 250.0 * (piece + 1), 'ctx': [0, piece, 0],
                       'args': {'field': 'vec'}})
    events.append({'ph': 'i', 'name': 'ventilate', 'ctx': [0, 1, 0]})
    events.append({'ph': 'X', 'name': 'decode', 'dur_us': 5.0, 'ctx': None})
    events.append({'ph': 'X', 'name': 'decode', 'dur_us': 5.0, 'ctx': [0, 99, 0]})
    return {'events': events}


def test_ledger_from_one_trace_equals_jax():
    snapshot = _trace_snapshot()
    piece_map = {piece: ('part_{}.parquet'.format(piece // 2), piece % 2)
                 for piece in range(5)}
    port, jax_ledger = CostLedger('tok'), JaxLedger('tok')
    assert port.ingest_trace(snapshot, piece_map) == \
        jax_ledger.ingest_trace(snapshot, piece_map) == 25
    assert port.to_dict() == jax_ledger.to_dict()
    assert port.ranking(3) == jax_ledger.ranking(3)
    assert port.what_if() == jax_ledger.what_if()
    assert format_cost_report(port) == jax_format_cost_report(jax_ledger)
    twice, jax_twice = CostLedger('tok'), JaxLedger('tok')
    twice.merge(port)
    twice.merge(port)
    jax_twice.merge(jax_ledger)
    jax_twice.merge(jax_ledger)
    assert twice.to_dict() == jax_twice.to_dict()
    with pytest.raises(ValueError, match='dataset tokens'):
        twice.merge(CostLedger('other'))


def test_ledger_files_load_across_packages(tmp_path):
    snapshot = _trace_snapshot()
    piece_map = {piece: ('frag.parquet', piece) for piece in range(5)}
    port, jax_ledger = CostLedger('tok'), JaxLedger('tok')
    port.ingest_trace(snapshot, piece_map)
    jax_ledger.ingest_trace(snapshot, piece_map)
    port_path = port.save(str(tmp_path / 'port.json'))
    jax_path = jax_ledger.save(str(tmp_path / 'jax.json'))
    with open(port_path) as f, open(jax_path) as g:
        assert f.read() == g.read()
    assert JaxLedger.load(port_path).to_dict() == port.to_dict()
    assert CostLedger.load(jax_path).to_dict() == jax_ledger.to_dict()
    assert [name for name in os.listdir(str(tmp_path)) if '.tmp.' in name] == []
    with open(port_path, 'w') as f:
        json.dump({'version': 99, 'dataset_token': 'tok'}, f)
    with pytest.raises(ValueError, match='version'):
        CostLedger.load(port_path)


# ------------------------------------------------- plans against the JAX package

@pytest.mark.parametrize('seed', [None, 0, 7, 23])
@pytest.mark.parametrize('ledger', ['skewed', 'uniform', 'empty', 'none', 'heavy_spread'])
def test_plans_and_orders_equal_jax(ledger, seed):
    n = 12
    costs = {
        'skewed': {'frag.parquet#{}'.format(i): (0.9 if i == 2 else 0.3 if i == 7
                                                 else 0.01) for i in range(n)},
        'uniform': {'frag.parquet#{}'.format(i): 0.05 for i in range(n)},
        'empty': {},
        'none': None,
        'heavy_spread': {'frag.parquet#{}'.format(i): (0.2 if i % 3 == 0 else 0.02)
                         for i in range(n)},
    }[ledger]
    for drop_parts in (1, 2):
        port, jax_result = twin_plans(costs, seed, n, rows=10, drop_parts=drop_parts)
        assert port == jax_result
        if ledger == 'skewed':
            assert port['report']['splits'] and port['virtual']
            # a split rowgroup's sub-ranges cover its rows once
            ranges = sorted(r for p, r in port['planned'] if r is not None)
            assert ranges[0][0] == 0 and ranges[-1][1] == 10


@pytest.mark.parametrize('policy_kwargs', [{'split': False}, {'prestage': False},
                                           {'interleave': False},
                                           {'heavy_skew': 3.0, 'split_threshold': 3.0,
                                            'split_max': 3, 'min_split_rows': 3}])
def test_policy_variants_equal_jax(policy_kwargs):
    costs = {'frag.parquet#{}'.format(i): (1.5 if i in (1, 4) else 0.1) for i in range(9)}
    port, jax_result = twin_plans(costs, 5, 9, rows=9, policy_kwargs=policy_kwargs)
    assert port == jax_result


def test_plan_preview_equals_jax():
    for costs in ({}, {'frag#{}'.format(i): (2.0 if i == 0 else 0.02) for i in range(6)},
                  {'frag#{}'.format(i): 0.1 for i in range(4)}):
        port = plan_preview(build_ledger(CostLedger, 'tok', costs))
        assert port == jax_plan_preview(build_ledger(JaxLedger, 'tok', costs))
    skewed = plan_preview(build_ledger(CostLedger, 'tok', {
        'frag#{}'.format(i): (2.0 if i == 0 else 0.02) for i in range(6)}))
    assert not skewed['cold_start'] and skewed['interleave_order'][0] == 'frag#0'
    assert skewed['heavy'] == ['frag#0'] and skewed['splits'][0]['parts'] >= 2
    assert plan_preview(CostLedger('tok'))['cold_start']


# ----------------------------------------------------- tokens and sidecars

def test_dataset_tokens_and_sidecar_paths_equal_jax(store, tmp_path):
    url = store['url']
    configs = [dict(), dict(schema_fields=['idx']),
               dict(cache_type='local-disk', cache_location=str(tmp_path / 'cache'),
                    cache_size_limit=1 << 20)]
    for kwargs in configs:
        with make_reader(url, reader_pool_type='dummy', **kwargs) as reader:
            token = reader.dataset_token
            home = cache_state_home(reader._cache)
        with jax_make_reader(url, reader_pool_type='dummy', **kwargs) as jax_reader:
            assert token == jax_reader.dataset_token
        assert default_ledger_path(url, token, home) == \
            jax_default_ledger_path(url, token, home)
    with make_batch_reader(url, reader_pool_type='dummy') as reader, \
            jax_make_batch_reader(url, reader_pool_type='dummy') as jax_reader:
        assert reader.dataset_token == jax_reader.dataset_token
    specs = [('idx', 'int64', '()', "{'codec': 'scalar'}")]
    for args in ((store['path'], ['idx'], True, False, specs),
                 ([store['path'], 'b'], ['b', 'a'], False, True, specs, ['a'])):
        assert derive_dataset_token(*args) == jax_derive_dataset_token(*args)
    for where, cache in (('file:///d/s', None), ('/d/s', '/c'), ('s3://b/s', None),
                         ('s3://b/s', '/c')):
        assert sidecar_path(where, 'x.json', cache) == jax_sidecar_path(where, 'x.json',
                                                                        cache)
    assert local_state_home('s3://b/s') is None and local_state_home('file:///d') == '/d'
    assert cache_state_home(object()) is None


# --------------------------------------------------- the scheduled reader

def test_scheduled_reader_equals_jax_with_splits_and_predicate(store):
    """A scheduled read ventilates the JAX reader's items in its order (the
    same ledger, seed and dummy pool), splits the heavy rowgroup, and every
    row the plain predicate read gives arrives once."""
    costs = skewed_costs(store['keys'])
    path = save_ledger(store, costs)
    cases = [(dict(shuffle_row_groups=True, seed=29), None),
             (dict(shuffle_row_groups=False), None),
             (dict(shuffle_row_groups=True, seed=3), 'pred')]
    try:
        for kwargs, predicate in cases:
            port_kwargs = dict(kwargs, cost_schedule=True)
            jax_kwargs = dict(kwargs, cost_schedule=True)
            if predicate:
                port_kwargs['predicate'] = in_lambda(['idx'], lambda idx: idx % 3 == 0)
                jax_kwargs['predicate'] = jax_in_lambda(['idx'], lambda idx: idx % 3 == 0)
            # each reader's stop() folds its live costs into the sidecar:
            # both plan from the pristine ledger, each written by its package
            save_ledger(store, costs)
            ids, rows, report = read_items(make_reader, store['url'], **port_kwargs)
            save_ledger(store, costs, JaxLedger)
            jax_ids, jax_rows, jax_report = read_items(jax_make_reader, store['url'],
                                                       **jax_kwargs)
            assert ids == jax_ids and rows == jax_rows
            assert report['splits'] == jax_report['splits'] and report['splits']
            assert report['epoch_orders'] == jax_report['epoch_orders']
            expected = [i for i in range(ROWS) if not predicate or i % 3 == 0]
            assert sorted(rows) == expected
            assert len(ids) == len(store['keys']) + report['splits'][0]['parts'] - 1
    finally:
        os.remove(path)


@pytest.mark.filterwarnings('ignore:This store was written with a Unischema')
def test_scheduled_batch_reader_equals_jax(store):
    """``make_batch_reader(cost_schedule=True)`` plans and orders as the JAX
    batch reader does, sub-range items included."""
    costs = skewed_costs(store['keys'])
    with make_batch_reader(store['url'], reader_pool_type='dummy') as reader:
        token = reader.dataset_token
    path = default_ledger_path(store['url'], token)
    try:
        build_ledger(CostLedger, token, costs).save(path)
        ids, rows, report = read_items(make_batch_reader, store['url'], seed=5,
                                       cost_schedule=True)
        build_ledger(JaxLedger, token, costs).save(path)
        jax_ids, jax_rows, jax_report = read_items(jax_make_batch_reader, store['url'],
                                                   seed=5, cost_schedule=True)
    finally:
        os.remove(path)
    assert ids == jax_ids and rows == jax_rows and sorted(rows) == list(range(ROWS))
    assert report['splits'] == jax_report['splits'] and report['splits']


def test_scheduled_order_identical_across_pools(store):
    """Same seed and ledger: the same ventilation order on the dummy, thread
    and process pools (one worker each, so arrival order is ventilation
    order), and not the plain shuffle."""
    costs = skewed_costs(store['keys'])
    orders = {}
    path = save_ledger(store, costs)
    try:
        for pool in ('dummy', 'thread', 'process'):
            save_ledger(store, costs)   # stop() folds the run's costs in
            ids, rows = [], []
            with make_reader(store['url'], reader_pool_type=pool, workers_count=1,
                             num_epochs=1, shuffle_row_groups=True, seed=29,
                             cost_schedule=True) as reader:
                for batch in reader.iter_columnar(include_empty=True):
                    ids.append(tuple(int(part) for part in batch.item_id))
                    rows.extend(np.asarray(batch.columns['idx']).tolist())
                assert reader.diagnostics['schedule']['splits'], pool
            orders[pool] = ids
            assert sorted(rows) == list(range(ROWS))
    finally:
        os.remove(path)
    assert orders['dummy'] == orders['thread'] == orders['process']
    plain, _, _ = read_items(make_reader, store['url'], shuffle_row_groups=True, seed=29)
    assert orders['dummy'] != plain


def test_cold_start_equals_unscheduled_reader(store, tmp_path):
    ledger_path = str(tmp_path / 'absent.json')
    plain, plain_rows, _ = read_items(make_reader, store['url'], shuffle_row_groups=True,
                                      seed=17)
    cold, cold_rows, report = read_items(
        make_reader, store['url'], shuffle_row_groups=True, seed=17,
        cost_schedule=SchedulePolicy(ledger_path=ledger_path))
    assert cold == plain and cold_rows == plain_rows
    assert report['cold_start'] and not report['splits']
    expected = list(range(len(store['keys'])))
    np.random.RandomState(17).shuffle(expected)
    assert [piece for _epoch, piece, _drop in plain] == expected
    jax_plain, _, _ = read_items(jax_make_reader, store['url'], shuffle_row_groups=True,
                                 seed=17)
    assert plain == jax_plain
    # the cold run persisted what it measured: the next run plans warm
    assert report['live_observations'] > 0 and os.path.exists(ledger_path)
    _, _, warm = read_items(make_reader, store['url'], shuffle_row_groups=False,
                            cost_schedule=SchedulePolicy(ledger_path=ledger_path))
    assert not warm['cold_start'] and warm['ledger_rowgroups'] == len(store['keys'])


def test_cost_ledger_of_a_traced_read_and_profile_dataset(store, tmp_path):
    from petastorm_tpu_torch.telemetry import tracing
    from petastorm_tpu_torch.telemetry.cost_model import profile_dataset
    ledger_path = str(tmp_path / 'ledger.json')
    ledger, path = profile_dataset(store['url'], workers=1, ledger_path=ledger_path)
    assert path == ledger_path and len(ledger) == len(store['keys'])
    assert set(ledger.to_dict()['rowgroups']) == set(store['keys'])
    assert not tracing.trace_enabled()
    # a second profile merges into the same sidecar
    again, _ = profile_dataset(store['url'], workers=1, ledger_path=ledger_path)
    cells = again.to_dict()['rowgroups'][store['keys'][0]]['stages']
    assert cells['decode']['count'] == 2
    with make_reader(store['url'], reader_pool_type='dummy') as reader:
        assert len(reader.cost_ledger()) == 0   # tracing not armed: empty


def test_state_dict_refusals_and_fingerprint(store):
    path = save_ledger(store, skewed_costs(store['keys']))
    try:
        with make_reader(store['url'], reader_pool_type='dummy', num_epochs=1,
                         shuffle_row_groups=False, cost_schedule=True) as reader:
            assert reader.diagnostics['schedule']['splits']
            with pytest.raises(ValueError, match='split'):
                reader.state_dict()
            for _ in reader.iter_columnar():
                pass
        with make_reader(store['url'], reader_pool_type='dummy', num_epochs=1,
                         shuffle_row_groups=False,
                         cost_schedule=SchedulePolicy(split=False)) as reader:
            state = reader.state_dict()
            assert state['items_per_epoch'] == len(store['keys'])
            assert state['schedule'] == reader._cost_scheduler.plan_fingerprint()
            assert not state['schedule']['cold_start'] and not state['schedule']['splits']
            for _ in reader.iter_columnar():
                pass
    finally:
        os.remove(path)
    with make_reader(store['url'], num_epochs=2, reader_pool_type='dummy') as reader:
        for _ in reader.iter_columnar():
            break
        state = reader.state_dict()
        assert 'schedule' not in state
    with pytest.raises(ValueError, match='resume_state'):
        make_reader(store['url'], num_epochs=2, reader_pool_type='dummy',
                    resume_state=state, cost_schedule=True)


def test_schedule_interleave_knob(store):
    from petastorm_tpu_torch.autotune.knobs import KNOB_IDS, build_reader_knobs
    assert 'schedule_interleave' in KNOB_IDS
    path = save_ledger(store, skewed_costs(store['keys']))
    try:
        with make_reader(store['url'], reader_pool_type='dummy', num_epochs=2,
                         shuffle_row_groups=True, seed=1, cost_schedule=True) as reader:
            knob = {k.knob_id: k for k in build_reader_knobs(reader)}['schedule_interleave']
            assert knob.get() == 1.0
            assert knob.apply(0.0) == 0.0 and reader._cost_scheduler.interleave is False
            assert knob.apply(1.0) == 1.0
            for _ in reader.iter_columnar():
                pass
            report = reader.diagnostics['schedule']
        assert len(report['epoch_orders']) == 2
        assert report['epoch_orders'][0] != report['epoch_orders'][1]
        with make_reader(store['url'], reader_pool_type='dummy', num_epochs=1,
                         shuffle_row_groups=False, cost_schedule=True) as reader:
            assert 'schedule_interleave' not in [k.knob_id for k in build_reader_knobs(reader)]
            for _ in reader.iter_columnar():
                pass
    finally:
        os.remove(path)
    with make_reader(store['url'], reader_pool_type='dummy', num_epochs=1) as reader:
        assert 'schedule_interleave' not in [k.knob_id for k in build_reader_knobs(reader)]
        assert 'schedule' not in reader.diagnostics


def test_costs_cli_json_has_schedule_preview(tmp_path, capsys):
    from petastorm_tpu_torch.benchmark.cli import main as cli_main
    path = str(tmp_path / 'ledger.json')
    build_ledger(CostLedger, 'tok', {'frag#{}'.format(i): (1.0 if i == 0 else 0.01)
                                     for i in range(5)}).save(path)
    assert cli_main(['costs', 'ignored-url', '--no-read', '--ledger', path, '--json']) == 0
    doc = json.loads(capsys.readouterr().out)
    preview = doc['schedule_preview']
    assert preview == jax_plan_preview(JaxLedger.load(path))
    assert preview['rowgroups'] == 5 and preview['interleave_order'][0] == 'frag#0'
    assert cli_main(['costs', 'ignored-url', '--no-read', '--ledger', path]) == 0
    assert 'per-rowgroup cost ledger' in capsys.readouterr().out


# ------------------------------------------- units mirrored from test_schedule.py

def test_resolve_policy_forms_and_validation():
    assert resolve_schedule_policy(None) is None
    assert resolve_schedule_policy(False) is None
    assert resolve_schedule_policy(True) == SchedulePolicy()
    policy = SchedulePolicy(split=False)
    assert resolve_schedule_policy(policy) is policy
    assert resolve_schedule_policy('/x/ledger.json').ledger_path == '/x/ledger.json'
    with pytest.raises(TypeError):
        resolve_schedule_policy(3)
    for kwargs in ({'heavy_skew': 1.0}, {'split_threshold': 1.5}, {'split_max': 1},
                   {'min_split_rows': 0}):
        with pytest.raises(ValueError):
            SchedulePolicy(**kwargs)
    assert SchedulePolicy().as_dict() == JaxPolicy().as_dict()


def test_interleave_spreads_and_prestages_heavies():
    costs = {'frag.parquet#{}'.format(i): 0.01 for i in range(12)}
    costs['frag.parquet#10'] = 0.30
    costs['frag.parquet#11'] = 0.20
    sched = scheduler_for(costs, SchedulePolicy(split=False))
    items, _ = sched.plan_items(make_items(12), make_locator(12))
    pieces = [item['piece_index'] for item in sched.order_items(items, None)]
    assert pieces[0] == 10
    positions = sorted(pieces.index(p) for p in (10, 11))
    assert positions[0] < len(pieces) // 2 <= positions[1]


def test_interleave_toggle_restores_plain_order():
    costs = {'frag.parquet#{}'.format(i): (1.0 if i == 0 else 0.01) for i in range(6)}
    sched = scheduler_for(costs, SchedulePolicy(split=False))
    items, _ = sched.plan_items(make_items(6), make_locator(6))
    assert sched.set_interleave(False) is False
    plain = sched.order_items(list(items), np.random.RandomState(5))
    expected = list(items)
    np.random.RandomState(5).shuffle(expected)
    assert [i['piece_index'] for i in plain] == [i['piece_index'] for i in expected]
    sched.set_interleave(True)
    assert sched.order_items(list(items), np.random.RandomState(5))[0]['piece_index'] == 0


def test_split_parts_keep_heavy_status_and_caps():
    costs = {'frag.parquet#{}'.format(i): 1.0 for i in range(5)}
    costs['frag.parquet#0'] = 4.5
    sched = scheduler_for(costs)
    items, _ = sched.plan_items(make_items(5), make_locator(5, rows=12), max_parts=4)
    split_pieces = [item['piece_index'] for item in items if item.get('row_range')]
    assert len(split_pieces) >= 2
    for piece in split_pieces:
        assert sched.cost_hint_for({'piece_index': piece}) >= SchedulePolicy().heavy_skew
    assert sched.order_items(items, None)[0]['piece_index'] in split_pieces
    costs = {'frag.parquet#0': 5.0, 'frag.parquet#1': 0.01, 'frag.parquet#2': 0.01}
    items, _ = scheduler_for(costs).plan_items(make_items(3), make_locator(3), max_parts=2)
    assert sum(1 for i in items if i.get('row_range')) == 2
    items, _ = scheduler_for(costs, SchedulePolicy(min_split_rows=8)).plan_items(
        make_items(3), make_locator(3, rows=10))
    assert not any(i.get('row_range') for i in items)
    items, _ = scheduler_for(costs).plan_items(make_items(3), make_locator(3),
                                               allow_split=False)
    assert not any(i.get('row_range') for i in items)


def test_cost_hint_clamped():
    costs = {'frag.parquet#0': 100.0, 'frag.parquet#1': 0.001, 'frag.parquet#2': 1.0,
             'frag.parquet#3': 1.0, 'frag.parquet#4': 1.0}
    sched = scheduler_for(costs, SchedulePolicy(split=False))
    sched.plan_items(make_items(5), make_locator(5))
    assert sched.cost_hint_for({'piece_index': 0}) == MAX_COST_HINT
    assert sched.cost_hint_for({'piece_index': 1}) == MIN_COST_HINT
    assert sched.cost_hint_for({'piece_index': 99}) == 1.0
    assert scheduler_for(None).cost_hint_for({'piece_index': 0}) == 1.0


def test_observe_persist_drain_and_max(tmp_path):
    path = str(tmp_path / 'ledger.json')
    sched = CostAwareScheduler('tok', SchedulePolicy(), ledger_path=path)
    sched.plan_items(make_items(2), make_locator(2))
    sched.observe(0, {'decode': {'sum': 0.25, 'count': 1, 'max': 0.25},
                      'rowgroup_read': {'sum': 0.05, 'count': 1},
                      'transform': {'sum': 9.0, 'count': 1}})
    for _ in range(3):
        sched.observe(1, {'decode': {'sum': 0.01, 'count': 1, 'max': 0.01}})
    cell = sched.live_ledger()._entries['frag.parquet#1']['stages']['decode']
    assert cell['sum_s'] == pytest.approx(0.03) and cell['max_s'] == pytest.approx(0.01)
    assert sched.persist() == path
    assert sched.persist() is None   # drained: a second stop() adds nothing
    reloaded = CostLedger.load(path)
    assert reloaded.rowgroup_cost('frag.parquet#0') == pytest.approx(0.30)
    sched2 = CostAwareScheduler('tok', SchedulePolicy(), ledger=reloaded, ledger_path=path)
    sched2.plan_items(make_items(2), make_locator(2))
    sched2.observe(0, {'decode': {'sum': 0.10, 'count': 1}})
    assert sched2.persist() == path
    assert CostLedger.load(path).rowgroup_cost('frag.parquet#0') == pytest.approx(0.40)
    assert CostAwareScheduler('tok', SchedulePolicy(),
                              ledger_path=str(tmp_path / 'o.json')).persist() is None


def test_load_ledger_degrades_to_cold(tmp_path):
    missing, path = load_ledger(str(tmp_path), 'tok')
    assert missing is None and path is not None
    build_ledger(CostLedger, 'other', {'k#0': 1.0}).save(path)
    assert load_ledger(str(tmp_path), 'tok')[0] is None
    with open(path, 'w') as f:
        f.write('{not json')
    assert load_ledger(str(tmp_path), 'tok')[0] is None
    assert load_ledger('s3://bucket/store', 'tok') == (None, None)


def test_percentile_and_what_if_edges():
    assert percentile([], 0.95) == 0.0
    assert percentile([3.0], 0.95) == 3.0
    assert percentile([1.0, 2.0], 1.5) == 2.0
    assert percentile([1.0, 2.0], -1.0) == 1.0
    total = next(row for row in build_ledger(CostLedger, 'tok', {'frag#0': 0.5}).what_if()
                 if row['scope'] == 'total')
    assert total['skew_p95_over_median'] == 1.0 and total['saving_fraction'] == 0.0
    for row in build_ledger(CostLedger, 'tok', {'frag#{}'.format(i): 0.2
                                                for i in range(4)}).what_if():
        assert row['skew_p95_over_median'] == 1.0 and row['saving_fraction'] == 0.0
    zero = build_ledger(CostLedger, 'tok', {'frag#0': 0.0, 'frag#1': 0.0})
    total = next(row for row in zero.what_if() if row['scope'] == 'total')
    assert total['skew_p95_over_median'] == 1.0 and total['total_s'] == 0.0
    assert zero.ranking(5)[0]['share'] == 0.0


def test_attribution_what_if_rows_equal_jax(tmp_path, capsys):
    from petastorm_tpu.telemetry.analyze import attribute_bottleneck as jax_attribute
    from petastorm_tpu_torch.telemetry.analyze import attribute_bottleneck
    from petastorm_tpu_torch.telemetry.analyze import main as analyze_main
    snapshot = {'histograms': {'decode': {'unit': 1e-6, 'count': 4, 'sum': 2.0},
                               'rowgroup_read': {'unit': 1e-6, 'count': 4, 'sum': 1.0}}}
    costs = {'frag#{}'.format(i): (2.0 if i == 0 else 0.05) for i in range(8)}
    report = attribute_bottleneck(snapshot, cost_ledger=build_ledger(CostLedger, 't', costs))
    jax_report = jax_attribute(snapshot, cost_ledger=build_ledger(JaxLedger, 't', costs))
    assert report['what_if'] == jax_report['what_if'] and report['what_if']

    def without_details(rows):
        return [{k: v for k, v in row.items() if k != 'detail'} for row in rows]

    assert without_details(report['advisories']) == without_details(jax_report['advisories'])
    assert report['advisories'][0]['signal'] == 'cost_skew_p95_over_median'
    snapshot_path, ledger_path = tmp_path / 'snap.json', str(tmp_path / 'ledger.json')
    snapshot_path.write_text(json.dumps(snapshot))
    build_ledger(CostLedger, 't', costs).save(ledger_path)
    assert analyze_main([str(snapshot_path), '--costs', ledger_path]) == 0
    assert '[what-if]' in capsys.readouterr().out
