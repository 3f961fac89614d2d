"""petastorm_tpu_torch and chip_smoke.py import neither JAX (jax, flax, optax,
orbax) nor anything of the JAX package (``petastorm_tpu`` or ``petastorm_tpu.*``; the
port's own name shares that prefix, so matches are on whole module names)."""

import ast
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
    files = [os.path.join(REPO, 'chip_smoke.py')]
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
