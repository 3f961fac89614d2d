"""The twin audit: for every module present in both ``petastorm_tpu/`` and
``petastorm_tpu_torch/``, each public top-level name the JAX module binds
(``def``, ``class`` or assignment; module loggers aside), each public method
of its public classes and each parameter of those functions, constructors and
methods must be bound in the port's twin, or be listed in
:data:`DEFINED_DIFFERENCES` with its reason and the number of the
``CHANGES.md`` entry that decided it.

Both packages are parsed with ``ast``; neither is imported. A gap that is not
listed fails the audit, and so does a listed entry that is no longer a gap
(a stale entry would hide a regression)."""

import ast
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / 'petastorm_tpu'
PORT_ROOT = ROOT / 'petastorm_tpu_torch'
PORT_PACKAGE = 'petastorm_tpu_torch'

_MESH = 'the port passes torch.distributed groups and DeviceMesh dimensions where JAX names mesh axes'
_LOADERS = 'the torch loaders and DTensor placements take the place of the JAX loaders and shardings'
_DECODE_TAIL = 'the torch decode tail: torch.Generator for JAX keys, no JAX device_put or mesh'
_NO_X64 = "JAX's x64 mode has no torch counterpart"
_FLAX = "flax's mutable collections: the port's sown losses are outputs and state_dict entries"

#: ``module:Name``, ``module:Name.method`` or ``module:function(param)`` ->
#: (reason, the number of the ``CHANGES.md`` entry that decided it)
DEFINED_DIFFERENCES = {
    'benchmark/mfu.py:PEAK_BF16_FLOPS': ("TPU generations' peaks; the port's mfu takes the H100's", 18),
    'benchmark/mfu.py:chip_generation': ('TPU generations; the port measures one H100', 18),
    'benchmark/mfu.py:peak_flops': ("TPU generations' peaks; the port's mfu takes the H100's", 18),
    'benchmark/mfu.py:xla_cost_flops': ("XLA's cost analysis; the port counts FLOPs analytically", 18),
    'benchmark/mfu.py:mfu_fields': ("XLA's cost analysis; the port counts FLOPs analytically", 18),
    'benchmark/throughput.py:READ_JAX': ('the port reads with READ_TORCH', 18),
    'benchmark/throughput.py:reader_throughput(jax_batch_size)': ('torch_batch_size', 14),
    'converter.py:DatasetConverter.make_jax_loader': ('make_torch_loader', 12),
    'models/moe.py:expert_partition_specs(params)': ('the specs follow the state_dict', 10),
    'models/moe.py:expert_partition_specs(expert_axis)': (_MESH, 10),
    'models/moe.py:collect_sown(mutables)': (_FLAX, 10),
    'models/moe.py:moe_aux_total(mutables)': (_FLAX, 10),
    'models/moe.py:moe_drop_fractions(mutables)': (_FLAX, 10),
    'models/resnet.py:ModuleDef': ('a flax type alias', 18),
    'models/transformer.py:attention_sublayer(dtype)': ('the modules passed carry their dtype', 2),
    'ops/image.py:random_crop_flip(rng)': ('generator= (a torch.Generator)', 1),
    'ops/image_decode.py:dct_decode_images_jax': ("JAX's device path; the port's is torch", 18),
    'ops/index_shuffle.py:random_index_shuffle(key)': ('round keys from epoch_round_keys', 6),
    'ops/index_shuffle.py:random_index_shuffle(rounds)': ('round keys from epoch_round_keys', 6),
    'ops/raw_decode.py:STORED_COPY_WINDOW': ("K1's table has one row a stored block", 5),
    'ops/raw_decode.py:bitcast_rows(x64)': (_NO_X64, 1),
    'ops/raw_decode.py:unpack_npy_rows(x64)': (_NO_X64, 1),
    'ops/raw_decode.py:stored_inflate(interpret)': ("Pallas interpret mode; the CPU path is the plain copy", 5),
    'ops/ring_attention.py:ring_attention(axis_name)': (_MESH, 10),
    'ops/ring_attention.py:ring_attention_sharded(with_segments)': ('passing segments decides', 10),
    'ops/sharded_moe.py:expert_alltoall_ffn(axis_name)': (_MESH, 10),
    'ops/sharded_moe.py:expert_alltoall_ffn(activation)': ('removed in review: one activation', 10),
    'ops/sharded_moe.py:sharded_moe_ffn(axis_name)': (_MESH, 10),
    'ops/sharded_moe.py:sharded_moe_ffn(activation)': ('removed in review: one activation', 10),
    'parallel/device_stage.py:DeviceTransform.apply(rng)': (_DECODE_TAIL, 1),
    'parallel/device_stage.py:DeviceDecodeStage(device_put)': (_DECODE_TAIL, 5),
    'parallel/device_stage.py:DeviceDecodeStage.field_names': (_DECODE_TAIL, 5),
    'parallel/device_stage.py:DeviceDecodeStage.has_transforms': (_DECODE_TAIL, 5),
    'parallel/device_stage.py:DeviceDecodeStage.prepare(mesh)': (_DECODE_TAIL, 5),
    'parallel/device_stage.py:DeviceDecodeStage.apply_transforms': (_DECODE_TAIL, 5),
    'parallel/device_stage.py:DeviceDecodeStage.throttle(batch)': (_DECODE_TAIL, 5),
    'parallel/inmem_loader.py:InMemJaxLoader': ('InMemTorchLoader', 18),
    'parallel/loader.py:JaxDataLoader': ('TorchDataLoader', 18),
    'parallel/loader.py:make_jax_loader': ('make_torch_loader', 18),
    'parallel/loader.py:coalescible_layout': (_LOADERS, 18),
    'parallel/loader.py:resolve_sharding': (_LOADERS, 18),
    'parallel/loader.py:sharding_for_field': (_LOADERS, 18),
    'parallel/loader.py:iter_reader_chunks(accum_rows)': ('removed in review: no caller', 7),
    'parallel/loader.py:FieldShardings(per_field)': (_LOADERS, 11),
    'parallel/loader.py:FieldShardings(default)': (_LOADERS, 11),
    'parallel/loader.py:FieldShardings.for_field': (_LOADERS, 11),
    'parallel/mesh.py:shard_map_compat': ("JAX's shard_map; the port runs per rank", 18),
    'parallel/mesh.py:make_mesh(devices)': (_MESH, 10),
    'parallel/mesh.py:initialize_distributed(coordinator_address)': ('init_method', 11),
    'parallel/mesh.py:initialize_distributed(num_processes)': ('world_size', 11),
    'parallel/mesh.py:initialize_distributed(process_id)': ('rank', 11),
    'parallel/pipeline.py:make_pipeline(xs_spec)': ("the stage takes this rank's tensors", 11),
    'parallel/pipeline.py:make_pipeline(out_spec)': ("the stage takes this rank's tensors", 11),
    'unischema.py:UnischemaField.shape_dtype_struct': ('jax.ShapeDtypeStruct', 19),
    'unischema.py:Unischema.as_shape_dtype_structs': ('jax.ShapeDtypeStruct', 19),
    'utils.py:value_readback_gate': ('the port syncs with torch.cuda.synchronize()', 18),
    'workers/process_pool.py:MSG_STARTED': ("the pipe's message kinds are str literals", 18),
    'workers/process_pool.py:MSG_RESULT': ("the pipe's message kinds are str literals", 18),
    'workers/process_pool.py:MSG_DONE': ("the pipe's message kinds are str literals", 18),
    'workers/process_pool.py:MSG_ERROR': ("the pipe's message kinds are str literals", 18),
    'workers/process_pool.py:MSG_RESULT_SHM': ("the pipe's message kinds are str literals", 18),
    'workers/process_pool.py:MSG_HEARTBEAT': ("the pipe's message kinds are str literals", 18),
    'workers/process_pool.py:ProcessPool(zmq_copy_buffers)': ('no zmq transport; no caller', 9),
    'workers/process_pool.py:ProcessPool(shm_slot_bytes)': ('no caller', 9),
    'workers/process_pool.py:ProcessPool(shm_slots_per_worker)': ('no caller', 9),
    'workers/process_pool.py:ProcessPool(shm_checksum)': ('no caller', 9),
    'workers/process_pool.py:ProcessPool(shm_breaker)': ('no caller', 9),
    'workers/ventilator.py:ConcurrentVentilator(tag_epoch)': (
        'removed in review: every call carries its epoch', 7),
}


# ---------------------------------------------------------------- the audit

def _statements(body):
    """Top-level statements, those inside module-level if/try blocks too."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.If, ast.Try)):
            yield from _statements(stmt.body)
            yield from _statements(stmt.orelse)
            for handler in getattr(stmt, 'handlers', ()):
                yield from _statements(handler.body)
            yield from _statements(getattr(stmt, 'finalbody', ()))


def _target_names(target):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for element in target.elts:
            yield from _target_names(element)


def _is_logger(value):
    return isinstance(value, ast.Call) and 'getLogger' in ast.unparse(value.func)


def _defined(tree):
    """``{name: node}`` a module binds by def, class or assignment."""
    out = {}
    for stmt in _statements(tree.body):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[stmt.name] = stmt
        elif isinstance(stmt, ast.Assign) and not _is_logger(stmt.value):
            for target in stmt.targets:
                for name in _target_names(target):
                    out[name] = stmt
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            out[stmt.target.id] = stmt
    return out


def _imported(tree, module):
    """``{name: (module path or None, original name)}`` of a module's imports;
    the path is set for imports from the port's own package."""
    out = {}
    package = module.rsplit('/', 1)[0].split('/') if '/' in module else []
    for stmt in _statements(tree.body):
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                out[(alias.asname or alias.name).split('.')[0]] = (None, alias.name)
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.level:
                parts = package[:len(package) - stmt.level + 1] + (
                    stmt.module.split('.') if stmt.module else [])
            elif stmt.module and stmt.module.split('.')[0] == PORT_PACKAGE:
                parts = stmt.module.split('.')[1:]
            else:
                parts = None
            for alias in stmt.names:
                source = '/'.join(parts) + '.py' if parts else None
                out[alias.asname or alias.name] = (source, alias.name)
    return out


def _params(fn):
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append('*' + args.vararg.arg)
    if args.kwarg:
        names.append('**' + args.kwarg.arg)
    return [name for name in names if name not in ('self', 'cls')]


def _methods(cls, module_defs):
    """``{name: FunctionDef}`` of a class and its bases defined in the same
    module (the class's own definitions win)."""
    out = {}
    for base in cls.bases:
        node = module_defs.get(ast.unparse(base))
        if isinstance(node, ast.ClassDef) and node is not cls:
            out.update(_methods(node, module_defs))
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[stmt.name] = stmt
    return out


def _constructor(cls, methods):
    """The constructor's parameters: ``__init__``'s, or a dataclass's or a
    NamedTuple's fields; None when the audit cannot tell."""
    if '__init__' in methods:
        return _params(methods['__init__'])
    decorated = any('dataclass' in ast.unparse(d) for d in cls.decorator_list)
    if decorated or any(ast.unparse(b).endswith('NamedTuple') for b in cls.bases):
        return [stmt.target.id for stmt in cls.body
                if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)
                and 'ClassVar' not in ast.unparse(stmt.annotation)]
    return None


def _parse(root):
    return {path.relative_to(root).as_posix(): ast.parse(path.read_text())
            for path in sorted(root.rglob('*.py'))}


def audit(jax_root=JAX_ROOT, port_root=PORT_ROOT):
    """The sorted gaps: what the JAX twin of a module has and the port's
    lacks, as ``module:Name``, ``module:Name.method`` or
    ``module:callable(param)`` (``*args`` and ``**kwargs`` keep their stars)."""
    jax_modules, port_modules = _parse(jax_root), _parse(port_root)
    port_defined = {module: _defined(tree) for module, tree in port_modules.items()}

    def resolve(module, name, depth=0):
        """The port's node for ``name`` in ``module``, through imports from the
        port's own package; ``True`` when bound but not resolvable."""
        if name in port_defined[module]:
            return port_defined[module][name]
        source, original = _imported(port_modules[module], module).get(name, (False, None))
        if source is False:
            return None
        if source in port_defined and depth < 4:
            node = resolve(source, original, depth + 1)
            return True if node is None else node
        return True

    gaps = []
    for module in sorted(set(jax_modules) & set(port_modules)):
        jax_defs = _defined(jax_modules[module])
        for name, node in jax_defs.items():
            if name.startswith('_'):
                continue
            twin = resolve(module, name)
            if twin is None:
                gaps.append('{}:{}'.format(module, name))
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(twin, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    have = _params(twin)
                    gaps.extend('{}:{}({})'.format(module, name, p)
                                for p in _params(node) if p not in have)
            elif isinstance(node, ast.ClassDef) and isinstance(twin, ast.ClassDef):
                jax_methods = _methods(node, jax_defs)
                twin_module = next(m for m, defs in port_defined.items()
                                   if defs.get(twin.name) is twin)
                port_methods = _methods(twin, port_defined[twin_module])
                jax_ctor = _constructor(node, jax_methods)
                port_ctor = _constructor(twin, port_methods)
                if jax_ctor is not None and port_ctor is not None:
                    gaps.extend('{}:{}({})'.format(module, name, p)
                                for p in jax_ctor if p not in port_ctor)
                own = [stmt for stmt in node.body
                       if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))]
                for fn in own:
                    method = fn.name
                    if method.startswith('_'):
                        continue
                    if method not in port_methods:
                        gaps.append('{}:{}.{}'.format(module, name, method))
                        continue
                    have = _params(port_methods[method])
                    gaps.extend('{}:{}.{}({})'.format(module, name, method, p)
                                for p in _params(fn) if p not in have)
    return sorted(gaps)


# ---------------------------------------------------------------- the tests

def test_defined_differences_give_a_reason_and_their_change():
    for entry, (reason, change) in DEFINED_DIFFERENCES.items():
        assert reason.strip() and isinstance(change, int) and 1 <= change <= 20, entry


def test_the_port_has_every_public_name_method_and_parameter_of_its_twin():
    gaps = set(audit())
    assert sorted(gaps - set(DEFINED_DIFFERENCES)) == [], 'gaps the table does not list'
    assert sorted(set(DEFINED_DIFFERENCES) - gaps) == [], 'table entries that are no gap'


#: (port module, text replaced, replacement, the gap the audit must report)
PLANTED = {
    'name': ('unischema.py', 'def insert_explicit_nulls(', 'def _insert_explicit_nulls(',
             'unischema.py:insert_explicit_nulls'),
    'method': ('ngram.py', 'def form_ngram(self, rows):', 'def _form_ngram(self, rows):',
               'ngram.py:NGram.form_ngram'),
    'parameter': ('workers/thread_pool.py', 'def get_results(self, timeout=None):',
                  'def get_results(self):', 'workers/thread_pool.py:ThreadPool.get_results(timeout)'),
    'constructor': ('errors.py', 'cause: Optional[BaseException] = None) -> None:',
                    ') -> None:', 'errors.py:QuarantinedRowGroupError(cause)'),
}


@pytest.mark.parametrize('kind', sorted(PLANTED))
def test_a_gap_planted_in_a_copy_of_the_port_fails_the_audit(tmp_path, kind):
    module, old, new, gap = PLANTED[kind]
    copy = tmp_path / PORT_PACKAGE
    shutil.copytree(PORT_ROOT, copy, ignore=shutil.ignore_patterns(
        '__pycache__', '_build', '*.cu', '*.cuh', '*.so*'))
    path = copy / module
    text = path.read_text()
    assert text.count(old) == 1
    path.write_text(text.replace(old, new))
    gaps = set(audit(JAX_ROOT, copy))
    assert gaps - set(DEFINED_DIFFERENCES) == {gap}
