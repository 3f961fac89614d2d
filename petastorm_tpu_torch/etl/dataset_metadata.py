"""Dataset materialization and embedded metadata: a trimmed copy of
``petastorm_tpu.etl.dataset_metadata``.

The metadata keys and their JSON layouts are the same, so a store written by
either package reads in the other: the Unischema as JSON under
:data:`UNISCHEMA_JSON_KEY` and the per-file rowgroup row counts under
:data:`ROW_GROUPS_JSON_KEY`, both in ``_common_metadata``. Reading the
reference petastorm's pickled schema key is left for a later slice.
"""

import json
import logging
import os
from contextlib import contextmanager

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths, path_exists
from petastorm_tpu_torch.unischema import Unischema, dict_to_encoded_row

logger = logging.getLogger(__name__)

#: JSON-serialized Unischema
UNISCHEMA_JSON_KEY = b'petastorm_tpu.unischema.v1'
#: JSON map of {relative file path: {'size': bytes, 'row_groups': [rows per rowgroup]}}
ROW_GROUPS_JSON_KEY = b'petastorm_tpu.row_groups_per_file.v2'
#: rowgroup count per file, in the layout the reference petastorm writes
LEGACY_ROW_GROUPS_KEY = b'dataset-toolkit.num_row_groups_per_file.v1'

DEFAULT_ROW_GROUP_SIZE_MB = 32


class RowGroupIndices(object):
    """The unit of scheduling: one Parquet rowgroup, with its fragment's hive
    partition values."""

    __slots__ = ('fragment_index', 'fragment_path', 'row_group_id', 'row_group_num_rows',
                 'partition_keys')

    def __init__(self, fragment_index, fragment_path, row_group_id, row_group_num_rows,
                 partition_keys=None):
        self.fragment_index = fragment_index
        self.fragment_path = fragment_path
        self.row_group_id = row_group_id
        self.row_group_num_rows = row_group_num_rows
        self.partition_keys = partition_keys or {}

    def __repr__(self):
        return ('RowGroupIndices(fragment_index={}, fragment_path={!r}, row_group_id={}, '
                'row_group_num_rows={})'.format(self.fragment_index, self.fragment_path,
                                                self.row_group_id, self.row_group_num_rows))


class DatasetHandle(object):
    """An opened Parquet dataset: filesystem + path(s) + pyarrow dataset."""

    def __init__(self, filesystem, path_or_paths, arrow_dataset):
        self.filesystem = filesystem
        self.path_or_paths = path_or_paths
        self.arrow_dataset = arrow_dataset

    @property
    def root_path(self):
        if isinstance(self.path_or_paths, (list, tuple)):
            return os.path.dirname(self.path_or_paths[0])
        return self.path_or_paths

    @property
    def partition_field_names(self):
        partitioning = getattr(self.arrow_dataset, 'partitioning', None)
        if partitioning is None or partitioning.schema is None:
            return []
        data_names = set()
        for fragment in self.arrow_dataset.get_fragments():
            data_names = set(fragment.physical_schema.names)
            break
        return [name for name in partitioning.schema.names if name not in data_names]


def open_dataset(dataset_url_or_urls):
    """Resolve URL(s) and open a pyarrow dataset with hive-partition discovery
    (``_``/``.``-prefixed files such as ``_common_metadata`` are skipped)."""
    fs, path_or_paths = get_filesystem_and_path_or_paths(dataset_url_or_urls)
    arrow_dataset = pads.dataset(path_or_paths, filesystem=fs,
                                 format='parquet', partitioning='hive')
    return DatasetHandle(fs, path_or_paths, arrow_dataset)


# ---------------------------------------------------------------- write path

def rows_to_arrow_table(schema, rows):
    """Encode row dicts through the schema's codecs into an Arrow table."""
    encoded = [dict_to_encoded_row(schema, row) for row in rows]
    arrow_schema = schema.as_arrow_schema()
    columns = [pa.array([row[field.name] for row in encoded], type=field.type)
               for field in arrow_schema]
    return pa.Table.from_arrays(columns, schema=arrow_schema)


def write_table_files(filesystem, path, arrow_schema, batches,
                      rowgroup_size_mb=DEFAULT_ROW_GROUP_SIZE_MB, rows_per_file=None,
                      compression='snappy', file_prefix='part'):
    """Stream record batches into ``<path>/<prefix>_NNNNN.parquet`` files:
    rowgroups of about ``rowgroup_size_mb`` each, files rolled over at
    ``rows_per_file`` rows (None = one file). Returns the rows written."""
    state = {'writer': None, 'sink': None, 'file_index': 0, 'file_rows': 0, 'total': 0,
             'pending': [], 'pending_rows': 0, 'row_group_rows': None}

    def _flush_rowgroup():
        if not state['pending']:
            return
        rowgroup = pa.Table.from_batches(state['pending'], schema=arrow_schema)
        if state['writer'] is None:
            file_path = '{}/{}_{:05d}.parquet'.format(path, file_prefix,
                                                      state['file_index'])
            state['sink'] = filesystem.open_output_stream(file_path)
            state['writer'] = pq.ParquetWriter(state['sink'], arrow_schema,
                                               compression=compression)
        state['writer'].write_table(rowgroup, row_group_size=rowgroup.num_rows)
        state['file_rows'] += rowgroup.num_rows
        state['total'] += rowgroup.num_rows
        state['pending'], state['pending_rows'] = [], 0

    def _close_file():
        _flush_rowgroup()
        if state['writer'] is not None:
            state['writer'].close()
            state['sink'].close()
            state['writer'] = state['sink'] = None
            state['file_index'] += 1
            state['file_rows'] = 0

    for batch in batches:
        if batch.num_rows == 0:
            continue
        if state['row_group_rows'] is None:
            per_row = max(1, batch.nbytes // max(1, batch.num_rows))
            state['row_group_rows'] = max(1, (rowgroup_size_mb << 20) // per_row)
        offset = 0
        while offset < batch.num_rows:
            take = min(batch.num_rows - offset,
                       state['row_group_rows'] - state['pending_rows'])
            if rows_per_file is not None:
                take = min(take,
                           rows_per_file - state['file_rows'] - state['pending_rows'])
            state['pending'].append(batch.slice(offset, take))
            state['pending_rows'] += take
            offset += take
            if state['pending_rows'] >= state['row_group_rows']:
                _flush_rowgroup()
            if rows_per_file is not None and \
                    state['file_rows'] + state['pending_rows'] >= rows_per_file:
                _close_file()
    _close_file()
    return state['total']


def write_rows(dataset_url, schema, rows, rowgroup_size_mb=DEFAULT_ROW_GROUP_SIZE_MB,
               rows_per_file=None, n_files=None, file_prefix='part', compression='snappy'):
    """Encode ``rows`` (list of dicts) and write a Parquet store with the
    embedded metadata. ``compression`` is any pyarrow Parquet codec."""
    with materialize_dataset(dataset_url, schema):
        fs, path = get_filesystem_and_path_or_paths(dataset_url)
        fs.create_dir(path, recursive=True)
        table = rows_to_arrow_table(schema, rows)
        if rows_per_file is None:
            n_files = n_files or 1
            rows_per_file = max(1, (table.num_rows + n_files - 1) // n_files)
        write_table_files(fs, path, table.schema, table.to_batches(),
                          rowgroup_size_mb=rowgroup_size_mb, rows_per_file=rows_per_file,
                          file_prefix=file_prefix, compression=compression)


@contextmanager
def materialize_dataset(dataset_url, schema):
    """Context manager around Parquet-writing code; on exit, embeds the
    Unischema and rowgroup index into ``_common_metadata`` and checks that the
    store reads back."""
    yield
    handle = open_dataset(dataset_url)
    row_groups_map = _scan_row_groups_per_file(handle)
    metadata = {
        UNISCHEMA_JSON_KEY: json.dumps(schema.to_json_dict()).encode('utf-8'),
        ROW_GROUPS_JSON_KEY: json.dumps(row_groups_map).encode('utf-8'),
        LEGACY_ROW_GROUPS_KEY: json.dumps(
            {rel: len(entry['row_groups'])
             for rel, entry in row_groups_map.items()}).encode('utf-8'),
    }
    write_dataset_metadata(handle, metadata)
    if not load_row_groups(open_dataset(dataset_url)):
        raise MetadataError('Materialization verification failed: no rowgroups found '
                            'under {!r}'.format(dataset_url))


def _relative_path(root, full_path):
    root = root.rstrip('/')
    if full_path.startswith(root + '/'):
        return full_path[len(root) + 1:]
    return full_path


def _scan_row_groups_per_file(handle):
    """``{relative path: {'size': file_bytes, 'row_groups': [rows per rowgroup]}}``
    from every fragment footer."""
    result = {}
    for fragment in sorted(handle.arrow_dataset.get_fragments(), key=lambda f: f.path):
        fragment.ensure_complete_metadata()
        result[_relative_path(handle.root_path, fragment.path)] = {
            'size': handle.filesystem.get_file_info(fragment.path).size,
            'row_groups': [rg.num_rows for rg in fragment.row_groups],
        }
    return result


def common_metadata_path(handle):
    """Path of the dataset's ``_common_metadata`` file."""
    return handle.root_path.rstrip('/') + '/_common_metadata'


def read_metadata_dict(handle):
    """Key-value metadata of ``_common_metadata``, or {} when absent."""
    md_path = common_metadata_path(handle)
    if not path_exists(handle.filesystem, md_path):
        return {}
    with handle.filesystem.open_input_file(md_path) as f:
        return pq.read_metadata(f).metadata or {}


def write_dataset_metadata(handle, new_keys):
    """Merge ``new_keys`` into ``_common_metadata``, keeping existing keys."""
    existing = dict(read_metadata_dict(handle))
    existing.update(new_keys)
    md_path = common_metadata_path(handle)
    if path_exists(handle.filesystem, md_path):
        with handle.filesystem.open_input_file(md_path) as f:
            base_schema = pq.read_schema(f)
    else:
        base_schema = handle.arrow_dataset.schema
    with handle.filesystem.open_output_stream(md_path) as sink:
        pq.write_metadata(base_schema.with_metadata(existing), sink)


# ----------------------------------------------------------------- read path

def load_row_groups(handle):
    """Every rowgroup of the dataset in path-sorted order. Uses the metadata
    index when it is present and its file sizes match, else the footers."""
    metadata = read_metadata_dict(handle)
    index_map = None
    if ROW_GROUPS_JSON_KEY in metadata:
        try:
            index_map = json.loads(metadata[ROW_GROUPS_JSON_KEY].decode('utf-8'))
        except (ValueError, UnicodeDecodeError):
            logger.warning('Could not parse rowgroup index metadata; recomputing from '
                           'footers')
    fragments = sorted(handle.arrow_dataset.get_fragments(), key=lambda f: f.path)
    row_groups = []
    for fragment_index, fragment in enumerate(fragments):
        rel = _relative_path(handle.root_path, fragment.path)
        partition_keys = pads.get_partition_keys(fragment.partition_expression)
        counts = None
        if index_map is not None and rel in index_map:
            entry = index_map[rel]
            if entry.get('size') == handle.filesystem.get_file_info(fragment.path).size:
                counts = entry['row_groups']
            else:
                logger.warning('Rowgroup index for %s is stale; recomputing from footer',
                               rel)
        if counts is None:
            fragment.ensure_complete_metadata()
            counts = [rg.num_rows for rg in fragment.row_groups]
        for row_group_id, num_rows in enumerate(counts):
            row_groups.append(RowGroupIndices(fragment_index, fragment.path, row_group_id,
                                              num_rows, partition_keys))
    return row_groups


def get_schema(handle):
    """The Unischema embedded in ``_common_metadata``."""
    metadata = read_metadata_dict(handle)
    if UNISCHEMA_JSON_KEY not in metadata:
        raise MetadataError(
            'Dataset at {!r} has no {} metadata (stores written with the reference '
            "petastorm's pickled schema are not readable by this package yet)"
            .format(handle.root_path, UNISCHEMA_JSON_KEY))
    return Unischema.from_json_dict(
        json.loads(metadata[UNISCHEMA_JSON_KEY].decode('utf-8')))
