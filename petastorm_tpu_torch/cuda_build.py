"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each kernel source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``
(seconds per source, against minutes for an extension that includes
PyTorch's headers). A source may export several entry points (the three
flash-attention kernels share one; the batch norm's six passes share
``batch_norm.cu``). Libraries land in
``petastorm_tpu_torch/_build/``, named by a digest of their source and the
headers beside it (``csrc/*.cuh``), so an edited source or header rebuilds
and an unchanged one is reused. :func:`load` compiles
a missing library on first use, one ``nvcc`` call per source, and raises
with the compiler's output if ``nvcc`` fails; nothing falls back. The
compiler's report (``-Xptxas -v``: registers, shared memory and spills of
each kernel) is kept beside the library as ``<library>.log``.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PACKAGE_DIR, '_build')

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: library name -> (source under csrc/, {exported C function: ctypes argtypes})
KERNELS = {
    'stored_copy': ('stored_copy.cu', {
        # src, segs, m, out, out_len, stream
        'stored_copy': (_P, _P, _I, _P, ctypes.c_longlong, _P),
    }),
    'flash_attention': ('flash_attention.cu', {
        # q, k, v, seg, key_seg, o, lse, bh, t, d, heads, causal, dtype, stream
        'flash_fwd': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        # q, k, v, do, lse, delta, seg, key_seg, dq, bh, t, d, heads, causal, dtype, stream
        'flash_bwd_dq': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        # q, k, v, do, lse, delta, seg, key_seg, dk, dv, bh, t, d, heads, causal, dtype,
        # stream
        'flash_bwd_dkv': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P),
    }),
    'batch_norm': ('batch_norm.cu', {
        # x, m, c, p_rows, partial, stream
        'bn_stats': (_P, _L, _I, _I, _P, _P),
        # partial, p_rows, m, c, weight, running_mean, running_var, stats, keep, take,
        # eps, training, stream
        'bn_finalize': (_P, _I, _L, _I, _P, _P, _P, _P, _F, _F, _F, _I, _P),
        # x, stats, bias, x2, stats2, bias2, res, out, m, c, mode, out_bf16, stream
        'bn_apply': (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
        # dy, x, stats, bias, x2, stats2, bias2, res, m, c, mode, dy_bf16, p_rows,
        # partial, stream
        'bn_backward_reduce': (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P),
        # partial, p_rows, m, c, stats, stats2, dweight, dbias, dweight2, dbias2, coef,
        # coef2, training, stream
        'bn_backward_finalize': (_P, _I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
        # dy, x, stats, bias, coef, x2, stats2, bias2, coef2, res, dx, dx2, dres, m, c,
        # mode, dy_bf16, stream
        'bn_backward_apply': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                              _I, _P),
    }),
}

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: one lock per kernel source, so different sources may build at once
_locks = {name: threading.Lock() for name in KERNELS}
_loaded = {}


def _source_path(name):
    return os.path.join(_PACKAGE_DIR, 'csrc', KERNELS[name][0])


def library_path(name):
    """Where the library of kernel source ``name`` is built: keyed by its
    source, the headers it may include and the flags."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_PACKAGE_DIR, 'csrc', '*.cuh')))
    for path in [_source_path(name)] + headers:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0' + f.read())
    return os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(name, digest.hexdigest()[:16]))


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found (looked on PATH and in /usr/local/cuda/bin): '
                       'the CUDA kernels of petastorm_tpu_torch cannot be built')


def _compile(name, path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '{}.{}.tmp'.format(path, os.getpid())
    result = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, _source_path(name)],
                            capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError('nvcc failed for {} (exit {}):\n{}{}'.format(
            name, result.returncode, result.stdout, result.stderr))
    with open(path + '.log', 'w') as f:
        f.write(result.stdout + result.stderr)
    os.replace(tmp, path)


def load(name, symbol=None):
    """The ``ctypes`` function ``symbol`` (default: ``name``) of kernel source
    ``name``, built on first use, with its argument types declared and an
    ``int`` (``cudaError_t``) result. Loads of different sources may run in
    parallel threads (one ``nvcc`` each)."""
    symbol = symbol or name
    with _locks[name]:
        fn = _loaded.get((name, symbol))
        if fn is None:
            path = library_path(name)
            if not os.path.exists(path):
                _compile(name, path)
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.argtypes = KERNELS[name][1][symbol]
            fn.restype = ctypes.c_int
            _loaded[(name, symbol)] = fn
        return fn
