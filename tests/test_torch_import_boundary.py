"""petastorm_tpu_torch, chip_smoke.py and examples/moe/torch_example.py import neither JAX (jax, flax, optax,
orbax) nor anything of the JAX package (``petastorm_tpu`` or ``petastorm_tpu.*``; the
port's own name shares that prefix, so matches are on whole module names), and
neither do the process pool's spawned workers, which load no torch either."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'petastorm_tpu_torch')
FORBIDDEN_ROOTS = ('jax', 'flax', 'optax', 'orbax', 'petastorm_tpu')


def _forbidden(module):
    return module.split('.')[0] in FORBIDDEN_ROOTS


def _scanned_files():
    files = [os.path.join(REPO, 'chip_smoke.py'),
             os.path.join(REPO, 'examples', 'moe', 'torch_example.py')]
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
    assert os.path.join(REPO, 'examples', 'moe', 'torch_example.py') in files
    offenders = [(os.path.relpath(path, REPO), name) for path in files
                 for name in _imports(path) if _forbidden(name)]
    assert not offenders


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
                     device_decode_fields=['img', 'vec']) as reader:
        loader = TorchDataLoader(reader, batch_size=4, device='cpu', device_transforms={
            'img': DeviceTransform(crop=(8, 8), random_flip=True)})
        rows = sum(int(batch['label'].shape[0]) for batch in loader)
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'petastorm_tpu'))
    print('MODULES', len(names), 'ROWS', rows, 'STORED', loader.stats.device_stored_batches,
          'LEAKED', leaked)
''')


def test_port_imports_and_runs_an_epoch_with_jax_blocked():
    """A fresh interpreter (the test process already holds jax) with jax and
    petastorm_tpu refused imports every port module and runs one CPU epoch."""
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, '-c', _BLOCKED_RUN], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=240)
    assert result.returncode == 0, result.stderr[-3000:]
    line = [l for l in result.stdout.splitlines() if l.startswith('MODULES')][-1]
    fields = line.split()
    assert int(fields[1]) > 20
    assert fields[3] == '12' and fields[5] == '3'
    assert line.endswith('LEAKED []')


@pytest.mark.parametrize('module', ['petastorm_tpu_torch', 'petastorm_tpu_torch.reader',
                                    'petastorm_tpu_torch.parallel.loader'])
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
