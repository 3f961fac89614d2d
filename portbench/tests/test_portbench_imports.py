"""What the benchmark may import: never JAX or the JAX package, and in its
references nothing of the port."""

import ast
import os
import subprocess
import sys

from portbench.tests.tiny import REPO

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'petastorm_tpu'}
BENCH = os.path.join(REPO, 'portbench')


def _sources(root):
    for directory, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith('.py'):
                yield os.path.join(directory, name)


def _imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(alias.name.split('.')[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split('.')[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', None) == 'import_module'
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split('.')[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    offenders = {os.path.relpath(path, REPO): sorted(_imported_tops(path) & FORBIDDEN)
                 for path in _sources(BENCH)}
    assert not {path: tops for path, tops in offenders.items() if tops}
    # whole names: the port's own name begins with the JAX package's
    assert 'petastorm_tpu_torch' not in FORBIDDEN


def test_the_references_import_nothing_of_the_port():
    offenders = {os.path.relpath(path, REPO): _imported_tops(path)
                 for path in _sources(os.path.join(BENCH, 'reference'))}
    assert not {path: tops for path, tops in offenders.items()
                if 'petastorm_tpu_torch' in tops or tops & FORBIDDEN}


BLOCKER = r'''
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax', 'petastorm_tpu'}:
            raise ImportError('refused: ' + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, %r)
from portbench import harness
from portbench.tests import tiny
result, checks = harness.run_cell(tiny.lm_cell(), 5, 4.0, 1, device='cpu')
assert result['correct'], checks
assert not harness.forbidden_modules(), harness.forbidden_modules()
print('ran', sorted(result['metrics']))
'''


def test_a_run_with_jax_and_the_jax_package_unimportable():
    out = subprocess.run([sys.executable, '-c', BLOCKER % REPO], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert out.returncode == 0, out.stderr[-4000:]
    assert 'pack_fill.lm' in out.stdout
