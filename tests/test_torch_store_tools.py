"""The port's store tools and host helpers against the JAX package's on the
same stores and seeds: ``generate_metadata``, ``metadata_util``,
``copy_dataset``, ``fs_utils.delete_path``, ``run_in_subprocess``,
``BatchingTableQueue`` and ``generate_random_datapoint``. All comparisons are
exact."""

import contextlib
import io
import json
import math
import operator
import os
import shutil
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

#: a port Unischema at a dotted path, for ``generate_metadata(unischema_class=...)``
TOOLS_SCHEMA = Unischema('Tools', [
    UnischemaField('id', np.int64, (), ScalarCodec(), False),
    UnischemaField('label', np.int32, (), ScalarCodec(), True),
    UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
])


def _rows(n=40):
    rng = np.random.RandomState(0)
    return [{'id': i, 'label': None if i % 7 == 3 else i % 5,
             'vec': rng.randn(4).astype(np.float32)} for i in range(n)]


@pytest.fixture(scope='module')
def tools_store(tmp_path_factory):
    """A Unischema store of 40 rows in 4 files (a null label every 7 rows)
    with a rowgroup index on ``label``."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
    from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    path = str(tmp_path_factory.mktemp('tools') / 'store')
    write_rows('file://' + path, TOOLS_SCHEMA, _rows(), n_files=4)
    build_rowgroup_index('file://' + path, [SingleFieldIndexer('by_label', 'label')])
    return path


def _copy_without_metadata(src, dst):
    shutil.copytree(src, dst)
    os.remove(os.path.join(dst, '_common_metadata'))
    return dst


def _metadata(path):
    import pyarrow.parquet as pq
    return pq.read_metadata(os.path.join(path, '_common_metadata')).metadata


@pytest.mark.parametrize('source', ['inferred', 'unischema_class', 'legacy'])
def test_generate_metadata_writes_the_jax_tools_keys(tools_store, tmp_path, source):
    from petastorm_tpu.etl.generate_metadata import generate_metadata as jax_generate
    from petastorm_tpu_torch.etl import dataset_metadata
    from petastorm_tpu_torch.etl.generate_metadata import generate_metadata, main
    if source == 'legacy':
        legacy = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data', 'legacy',
                              '0.7.6')
        ours, theirs = (str(tmp_path / name) for name in ('ours', 'theirs'))
        shutil.copytree(legacy, ours)
        shutil.copytree(legacy, theirs)
    else:
        ours = _copy_without_metadata(tools_store, str(tmp_path / 'ours'))
        theirs = _copy_without_metadata(tools_store, str(tmp_path / 'theirs'))
    if source == 'unischema_class':
        assert main([ours, '--unischema-class',
                     'test_torch_store_tools.TOOLS_SCHEMA']) == 0
        from petastorm_tpu.unischema import Unischema as JaxUnischema
        jax_schema = JaxUnischema.from_json_dict(TOOLS_SCHEMA.to_json_dict())
        import petastorm_tpu.etl.generate_metadata as jax_module
        jax_module.TOOLS_SCHEMA = jax_schema
        try:
            jax_generate(theirs, 'petastorm_tpu.etl.generate_metadata.TOOLS_SCHEMA')
        finally:
            del jax_module.TOOLS_SCHEMA
    else:
        generate_metadata(ours)
        jax_generate(theirs)
    got, want = _metadata(ours), _metadata(theirs)
    assert sorted(got) == sorted(want)
    for key in (dataset_metadata.UNISCHEMA_JSON_KEY, dataset_metadata.ROW_GROUPS_JSON_KEY,
                dataset_metadata.LEGACY_ROW_GROUPS_KEY):
        assert json.loads(got[key]) == json.loads(want[key]), key
    schema = dataset_metadata.get_schema_from_dataset_url(ours)
    if source == 'unischema_class':
        assert schema == TOOLS_SCHEMA
    if source == 'legacy':
        assert 'image_png' in schema.fields


def test_generate_metadata_refuses_a_path_that_is_not_a_port_unischema(tools_store,
                                                                         tmp_path):
    from petastorm_tpu_torch.etl.generate_metadata import generate_metadata
    path = _copy_without_metadata(tools_store, str(tmp_path / 'store'))
    with pytest.raises(ValueError, match='Unischema'):
        generate_metadata(path, 'test_torch_store_tools._rows')


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize('argv', [[], ['--print-values'], ['--skip-schema']])
def test_metadata_util_prints_what_the_jax_tool_prints(tools_store, argv):
    from petastorm_tpu.etl.metadata_util import main as jax_main
    from petastorm_tpu_torch.etl.metadata_util import main
    ours = _printed(main, [tools_store] + argv)
    assert ours == _printed(jax_main, [tools_store] + argv)
    assert "index 'by_label'" in ours
    if not argv:
        assert 'Unischema(' in ours and '4 rowgroups, 40 rows' in ours


@pytest.mark.parametrize('field_regex,not_null', [
    (None, None), (['id', 'label'], ['label']), (['v.*', 'id'], None)])
def test_copy_dataset_copies_the_rows_the_jax_tool_copies(tools_store, tmp_path,
                                                          field_regex, not_null):
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu.tools.copy_dataset import copy_dataset as jax_copy
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    ours, theirs = str(tmp_path / 'ours'), str(tmp_path / 'theirs')
    kwargs = dict(field_regex=field_regex, not_null_fields=not_null, rows_per_file=16)
    assert copy_dataset(tools_store, ours, **kwargs) == jax_copy(tools_store, theirs, **kwargs)

    def read(factory, url):
        with factory(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
            return [row._asdict() for row in reader]

    got, want = read(make_reader, ours), read(jax_make_reader, theirs)
    assert len(got) == len(want) == (34 if not_null else 40)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            np.testing.assert_array_equal(g[name], w[name])
    with pytest.raises(ValueError, match='not empty'):
        copy_dataset(tools_store, ours)


def test_copy_dataset_cli_overwrites(tools_store, tmp_path):
    from petastorm_tpu_torch.etl.dataset_metadata import open_dataset, load_row_groups
    from petastorm_tpu_torch.tools.copy_dataset import main
    target = str(tmp_path / 'copy')
    assert main([tools_store, target, '--field-regex', 'id']) == 0
    assert main([tools_store, target, '--not-null-fields', 'label', '--overwrite']) == 0
    assert sum(rg.row_group_num_rows for rg in load_row_groups(open_dataset(target))) == 34


def test_run_in_subprocess_returns_raises_and_reports_a_dead_child():
    from petastorm_tpu_torch.utils import run_in_subprocess
    assert run_in_subprocess(operator.add, 2, 3) == 5
    assert run_in_subprocess(math.factorial, 10) == 3628800
    with pytest.raises(RuntimeError, match='Subprocess failed') as info:
        run_in_subprocess(int, 'not a number')
    assert 'Traceback' in str(info.value) and 'invalid literal' in str(info.value)
    assert isinstance(info.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match='died with exit code 3'):
        run_in_subprocess(os._exit, 3)


def test_batching_table_queue_equals_the_jax_queue():
    from petastorm_tpu.arrow_helpers import BatchingTableQueue as JaxQueue
    from petastorm_tpu_torch.arrow_helpers import BatchingTableQueue
    sizes = [3, 0, 11, 1, 7, 20, 2]
    tables = []
    start = 0
    for size in sizes:
        tables.append(pa.table({'a': np.arange(start, start + size),
                                'b': [str(i) for i in range(start, start + size)]}))
        start += size
    results = []
    for queue_cls in (BatchingTableQueue, JaxQueue):
        queue = queue_cls(5)
        out = []
        for table in tables:
            queue.put(table)
            while not queue.empty():
                out.append(queue.get())
        results.append(out)
        with pytest.raises(ValueError):
            queue.get()
    ours, theirs = results
    assert len(ours) == len(theirs) == sum(sizes) // 5
    for got, want in zip(ours, theirs):
        assert got.equals(want)
    with pytest.raises(ValueError):
        BatchingTableQueue(0)


def test_generate_random_datapoint_equals_the_jax_generator():
    from petastorm_tpu.generator import generate_random_datapoint as jax_generate
    from petastorm_tpu.unischema import Unischema as JaxUnischema
    from petastorm_tpu.unischema import UnischemaField as JaxField
    from petastorm_tpu_torch.generator import generate_datapoint, generate_random_datapoint
    specs = [('i8', np.int8, ()), ('u32', np.uint32, (2, 3)), ('i64', np.int64, (None,)),
             ('f32', np.float32, (4,)), ('f64', np.float64, ()), ('flag', np.bool_, (5,)),
             ('s', np.str_, ()), ('b', np.bytes_, (2,)), ('t', np.dtype('datetime64[ns]'), ()),
             ('d', Decimal, ())]
    ours_schema = Unischema('G', [UnischemaField(n, d, s) for n, d, s in specs])
    theirs_schema = JaxUnischema('G', [JaxField(n, d, s) for n, d, s in specs])
    assert generate_datapoint is generate_random_datapoint
    for seed in (0, 1):
        ours = generate_random_datapoint(ours_schema, np.random.RandomState(seed))
        theirs = jax_generate(theirs_schema, np.random.RandomState(seed))
        assert list(ours) == list(theirs)
        for name in theirs:
            assert type(ours[name]) is type(theirs[name]), name
            if isinstance(theirs[name], np.ndarray):
                assert ours[name].dtype == theirs[name].dtype
                np.testing.assert_array_equal(ours[name], theirs[name])
            else:
                assert ours[name] == theirs[name], name


@pytest.mark.parametrize('target,recursive', [('file', True), ('tree', True), ('tree', False),
                                              ('missing', True)])
def test_delete_path_leaves_what_the_jax_helper_leaves(tmp_path, target, recursive):
    import pyarrow.fs as pafs

    from petastorm_tpu.fs_utils import delete_path as jax_delete_path
    from petastorm_tpu_torch.fs_utils import delete_path

    def make(root):
        os.makedirs(os.path.join(root, 'tree', 'sub'))
        for name in ('file', os.path.join('tree', 'a'), os.path.join('tree', 'sub', 'b')):
            with open(os.path.join(root, name), 'w') as f:
                f.write(name)

    def left(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, dirs, files in os.walk(root) for n in dirs + files)

    fs = pafs.LocalFileSystem()
    for name, helper in (('ours', delete_path), ('theirs', jax_delete_path)):
        root = str(tmp_path / name)
        make(root)
        helper(fs, os.path.join(root, target), recursive=recursive)
    assert left(str(tmp_path / 'ours')) == left(str(tmp_path / 'theirs'))
