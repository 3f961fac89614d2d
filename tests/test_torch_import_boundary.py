"""petastorm_tpu_torch, chip_smoke.py and every examples/**/torch_*.py import neither JAX (jax, flax, optax,
orbax) nor anything of the JAX package (``petastorm_tpu`` or ``petastorm_tpu.*``; the
port's own name shares that prefix, so matches are on whole module names), and
neither do the process pool's spawned workers or an input-service fleet's
decode workers, which load no torch either."""

import ast
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'petastorm_tpu_torch')
FORBIDDEN_ROOTS = ('jax', 'flax', 'optax', 'orbax', 'petastorm_tpu')


#: the measurement tools and the cost-aware scheduler
SLICE_14_MODULES = ('dataset_state.py',) + tuple(
    os.path.join(*parts) for parts in (
        ('benchmark', 'linkprobe.py'), ('benchmark', 'throughput.py'),
        ('benchmark', 'dummy_reader.py'), ('benchmark', 'decode_bench.py'),
        ('benchmark', 'wire_bench.py'), ('benchmark', 'cli.py'),
        ('telemetry', 'cost_model.py'), ('schedule', '__init__.py'),
        ('schedule', 'cost_schedule.py'), ('tools', 'doctor.py'),
        ('test_util', '__init__.py'), ('test_util', 'reader_mock.py')))
#: the input service
SLICE_15_MODULES = tuple(os.path.join('service', name) for name in (
    '__init__.py', 'wire.py', 'ledger.py', 'dispatcher.py', 'service_worker.py',
    'service_client.py', 'fleet.py'))
#: fault injection, the storage engine and the lineage plane
SLICE_16_MODULES = (os.path.join('test_util', 'fault_injection.py'),) + tuple(
    os.path.join('storage', name) for name in (
        '__init__.py', 'range_planner.py', 'metadata_cache.py', 'fetcher.py',
        'engine.py')) + tuple(
    os.path.join('telemetry', name) for name in (
        'lineage.py', 'incident.py', 'history.py', 'sentinel.py'))
#: the examples/hello_world twins, both halves
HELLO_WORLD_TWINS = tuple(
    ('hello_world', half, 'torch_{}.py'.format(name))
    for half, generator in (('petastorm_dataset', 'generate_petastorm_dataset'),
                            ('external_dataset', 'generate_external_dataset'))
    for name in (generator, 'python_hello_world', 'pytorch_hello_world', 'hello_world'))


def _forbidden(module):
    return module.split('.')[0] in FORBIDDEN_ROOTS


def _example_twins():
    return sorted(glob.glob(os.path.join(REPO, 'examples', '**', 'torch_*.py'),
                            recursive=True))


def _scanned_files():
    files = [os.path.join(REPO, 'chip_smoke.py')] + _example_twins()
    for root, _, names in os.walk(PORT):
        files.extend(os.path.join(root, n) for n in names if n.endswith('.py'))
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for alias in node.names:
                yield '{}.{}'.format(node.module, alias.name)
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', None)
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_forbidden_matches_whole_module_names():
    assert _forbidden('petastorm_tpu') and _forbidden('petastorm_tpu.codecs')
    assert _forbidden('jax.numpy') and _forbidden('flax') and _forbidden('optax')
    assert _forbidden('orbax.checkpoint')
    assert not _forbidden('petastorm_tpu_torch') and not _forbidden('petastorm_tpu_torch.ops')
    assert not _forbidden('jaxlib_like_name') and not _forbidden('torch')


def test_no_source_file_imports_jax_or_the_jax_package():
    files = _scanned_files()
    assert os.path.join(REPO, 'chip_smoke.py') in files and len(files) > 20
    for twin in (('moe', 'torch_example.py'), ('converter', 'torch_converter_example.py'),
                 ('mnist', 'torch_example.py'), ('imagenet', 'torch_example.py'),
                 ('long_context', 'torch_example.py')) + HELLO_WORLD_TWINS:
        assert os.path.join(REPO, 'examples', *twin) in files
    for module in ('converter.py', 'pytorch.py', 'utils.py', 'arrow_helpers.py',
                   'generator.py', os.path.join('etl', 'legacy.py'),
                   os.path.join('etl', 'generate_metadata.py'),
                   os.path.join('etl', 'metadata_util.py'),
                   os.path.join('tools', 'copy_dataset.py')) + SLICE_14_MODULES \
            + SLICE_15_MODULES + SLICE_16_MODULES:
        assert os.path.join(PORT, module) in files
    offenders = [(os.path.relpath(path, REPO), name) for path in files
                 for name in _imports(path) if _forbidden(name)]
    assert not offenders


def _code_imports(code):
    """The module names a code string imports."""
    for node in ast.walk(ast.parse(code)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


def test_subprocess_code_strings_import_neither_jax_nor_the_jax_package():
    """The doctor's backend and link probes run code strings in children: no
    jax, no petastorm_tpu there either (the link probe's child imports the
    port's probe)."""
    from petastorm_tpu_torch.tools import doctor
    link_code = doctor.LINK_PROBE_CODE.format(row_bytes=1024, batch=1024)
    assert set(_code_imports(doctor.PROBE_CODE)) == {'torch'}
    assert set(_code_imports(link_code)) == {'json',
                                             'petastorm_tpu_torch.benchmark.linkprobe'}
    for code in (doctor.PROBE_CODE, link_code):
        assert not [name for name in _code_imports(code) if _forbidden(name)]


_BLOCKED_RUN = textwrap.dedent('''
    import importlib, importlib.abc, os, pkgutil, sys, tempfile
    import numpy as np
    sys.modules['jax'] = None

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'petastorm_tpu'):
                raise ImportError('blocked import of ' + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import petastorm_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(petastorm_tpu_torch.__path__,
                                                   'petastorm_tpu_torch.')]
    for name in names:
        importlib.import_module(name)

    from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
    from petastorm_tpu_torch.codecs import (CompressedNdarrayCodec, DctImageCodec,
                                            ScalarCodec)
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + os.path.join(tempfile.mkdtemp(), 'store')
    schema = Unischema('Blocked', [
        UnischemaField('label', np.int64, (), ScalarCodec(), False),
        UnischemaField('img', np.uint8, (16, 16, 3), DctImageCodec(), False),
        UnischemaField('vec', np.float32, (8,), CompressedNdarrayCodec(stored=True),
                       False)])
    rng = np.random.RandomState(0)
    write_rows(url, schema, [{'label': i, 'img': rng.randint(0, 255, (16, 16, 3),
                                                             dtype=np.uint8),
                              'vec': rng.randn(8).astype(np.float32)} for i in range(12)])
    with make_reader(url, reader_pool_type='thread', workers_count=2,
                     device_decode_fields=['img', 'vec'], storage_policy=True,
                     lineage=True, seed=1) as reader:
        loader = TorchDataLoader(reader, batch_size=4, device='cpu', device_transforms={
            'img': DeviceTransform(crop=(8, 8), random_flip=True)})
        rows = sum(int(batch['label'].shape[0]) for batch in loader)
        digest = reader.order_digest()
        footers = reader.diagnostics['storage']['footer_cache_misses']
    import pyarrow as pa
    from petastorm_tpu_torch.converter import make_converter
    from petastorm_tpu_torch.pytorch import BatchedDataLoader, DataLoader
    converter = make_converter(pa.table({'x': np.arange(20, dtype=np.int64)}),
                               parent_cache_dir_url=tempfile.mkdtemp())
    with converter.make_torch_dataloader(batch_size=8, device='cpu',
                                         reader_pool_type='dummy') as adapter:
        adapter_rows = sum(int(batch['x'].shape[0]) for batch in adapter)
    converter.delete()
    for twin in ('converter.torch_converter_example', 'mnist.torch_example',
                 'imagenet.torch_example', 'long_context.torch_example',
                 'moe.torch_example', 'hello_world.petastorm_dataset.torch_hello_world',
                 'hello_world.petastorm_dataset.torch_pytorch_hello_world',
                 'hello_world.external_dataset.torch_hello_world'):
        importlib.import_module('examples.' + twin)
    from petastorm_tpu_torch.tools import doctor
    assert doctor.collect_report(link=False)['healthy']
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'petastorm_tpu'))
    print('MODULES', len(names), 'ROWS', rows, 'STORED', loader.stats.device_stored_batches,
          'ADAPTER', adapter_rows, 'DIGEST', digest, 'FOOTERS', footers, 'LEAKED', leaked)
''')


def test_port_imports_and_runs_an_epoch_with_jax_blocked():
    """A fresh interpreter (the test process already holds jax) with jax and
    petastorm_tpu refused imports every port module and runs one CPU epoch,
    with the storage engine and the lineage plane armed."""
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, '-c', _BLOCKED_RUN], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=240)
    assert result.returncode == 0, result.stderr[-3000:]
    line = [l for l in result.stdout.splitlines() if l.startswith('MODULES')][-1]
    fields = line.split()
    assert int(fields[1]) > 20
    assert fields[3] == '12' and fields[5] == '3'
    assert fields[7] == '20'
    assert len(fields[9]) == 32 and int(fields[11]) > 0
    assert line.endswith('LEAKED []')


@pytest.mark.parametrize('module', ['petastorm_tpu_torch', 'petastorm_tpu_torch.reader',
                                    'petastorm_tpu_torch.parallel.loader',
                                    'petastorm_tpu_torch.converter',
                                    'petastorm_tpu_torch.pytorch'])
def test_top_level_modules_name_no_jax_in_their_globals(module):
    import importlib
    mod = importlib.import_module(module)
    for value in vars(mod).values():
        owner = getattr(value, '__module__', None) or getattr(value, '__name__', '')
        assert not _forbidden(str(owner)), (module, owner)


_SITECUSTOMIZE = textwrap.dedent('''
    import atexit, importlib.abc, json, os, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'petastorm_tpu'):
                raise ImportError('blocked import of ' + name)
            return None

    sys.meta_path.insert(0, Refuse())

    def _report():
        path = os.path.join(os.environ['BOUNDARY_REPORT_DIR'], '{}.json'.format(os.getpid()))
        with open(path, 'w') as f:
            json.dump({'argv': sys.argv, 'torch': 'torch' in sys.modules,
                       'refused': sorted(m for m in sys.modules
                                         if m.split('.')[0] in ('jax', 'flax', 'optax',
                                                                'petastorm_tpu'))}, f)

    atexit.register(_report)
''')

_POOL_RUN = textwrap.dedent('''
    import os, sys, tempfile
    import numpy as np
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + os.path.join(tempfile.mkdtemp(), 'store')
    schema = Unischema('Pool', [UnischemaField('id', np.int64, (), ScalarCodec(), False)])
    write_rows(url, schema, [{'id': i} for i in range(24)], n_files=4)
    with make_reader(url, reader_pool_type='process', workers_count=2) as reader:
        ids = sorted(int(row.id) for row in reader)
        shm = reader.diagnostics['shm_batches']
    print('IDS', ids == list(range(24)), 'SHM', shm, 'PARENT', os.getpid())
''')


def test_process_pool_workers_refuse_jax_and_load_no_torch(tmp_path):
    """One process-pool epoch in a fresh interpreter whose spawned workers
    (they inherit ``sitecustomize.py`` through ``PYTHONPATH``) refuse jax and
    the JAX package; each worker reports at exit that it loaded no torch."""
    site = tmp_path / 'site'
    reports = tmp_path / 'reports'
    site.mkdir()
    reports.mkdir()
    (site / 'sitecustomize.py').write_text(_SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]),
               BOUNDARY_REPORT_DIR=str(reports))
    result = subprocess.run([sys.executable, '-c', _POOL_RUN], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=240)
    assert result.returncode == 0, result.stderr[-3000:]
    line = [l for l in result.stdout.splitlines() if l.startswith('IDS')][-1].split()
    assert line[1] == 'True' and line[3] == '4'
    parent = int(line[5])
    reports = {int(path.stem): json.loads(path.read_text()) for path in reports.iterdir()}
    assert reports[parent]['torch'] is False and reports[parent]['refused'] == []
    workers = [report for report in reports.values()
               if report['argv'][0].endswith('process_worker_main.py')]
    assert len(workers) == 2
    for report in workers:
        assert report['torch'] is False and report['refused'] == []


def test_importing_the_service_package_loads_neither_zmq_nor_torch():
    code = ('import sys; import petastorm_tpu_torch.service as s; '
            'from petastorm_tpu_torch.service import ServiceFleet, ServicePool; '
            'print(sorted(m for m in ("zmq", "torch", "jax") if m in sys.modules))')
    result = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                            text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert result.returncode == 0, result.stderr[-3000:]
    assert result.stdout.split('\n')[-2] == '[]'


_FLEET_RUN = textwrap.dedent('''
    import os, sys, tempfile
    import numpy as np
    import torch
    from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
    from petastorm_tpu_torch.codecs import DctImageCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.service import ServiceFleet
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + os.path.join(tempfile.mkdtemp(), 'store')
    schema = Unischema('Fleet', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('img', np.uint8, (16, 16, 3), DctImageCodec(), False)])
    rng = np.random.RandomState(0)
    write_rows(url, schema, [{'id': i, 'img': rng.randint(0, 255, (16, 16, 3), dtype=np.uint8)}
                             for i in range(24)], n_files=4)
    with ServiceFleet(workers=2) as fleet:
        with make_reader(url, service_url=fleet.service_url,
                         device_decode_fields=['img']) as reader:
            loader = TorchDataLoader(reader, batch_size=6, device='cpu', device_transforms={
                'img': DeviceTransform(crop=(8, 8))})
            ids = sorted(int(i) for batch in loader for i in batch['id'])
        pids = [process.pid for process in fleet.processes]
    print('IDS', ids == list(range(24)), 'PARENT', os.getpid(), 'TORCH',
          'torch' in sys.modules, 'WORKERS', ','.join(map(str, pids)))
''')


def test_fleet_workers_refuse_jax_and_load_no_torch(tmp_path):
    """A service read into a TorchDataLoader from a parent that holds torch:
    the fleet's two spawned decode workers (their ``PYTHONPATH`` carries the
    parent's ``sys.path``, and with it ``sitecustomize.py``) refuse jax and
    the JAX package, and each reports at exit that it loaded no torch."""
    site = tmp_path / 'site'
    reports = tmp_path / 'reports'
    site.mkdir()
    reports.mkdir()
    (site / 'sitecustomize.py').write_text(_SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]),
               BOUNDARY_REPORT_DIR=str(reports))
    result = subprocess.run([sys.executable, '-c', _FLEET_RUN], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=240)
    assert result.returncode == 0, result.stderr[-3000:]
    line = [l for l in result.stdout.splitlines() if l.startswith('IDS')][-1].split()
    assert line[1] == 'True' and line[5] == 'True'
    parent = int(line[3])
    pids = [int(pid) for pid in line[7].split(',')]
    reports = {int(path.stem): json.loads(path.read_text()) for path in reports.iterdir()}
    assert reports[parent]['torch'] is True and reports[parent]['refused'] == []
    assert set(pids) <= set(reports)
    for pid in pids:
        assert reports[pid]['argv'][0].endswith('service_worker.py')
        assert reports[pid]['torch'] is False and reports[pid]['refused'] == []
