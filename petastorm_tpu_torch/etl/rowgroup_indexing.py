"""Build and load rowgroup indexes kept in a store's ``_common_metadata``: a
copy of ``petastorm_tpu.etl.rowgroup_indexing``. The metadata key and the JSON
are the same, so an index built by either package is read by the other."""

import json
from decimal import Decimal

import numpy as np
import pyarrow.dataset as pads

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.etl.rowgroup_indexers import indexer_from_json_dict
from petastorm_tpu_torch.fs_utils import normalize_dataset_url_or_urls
from petastorm_tpu_torch.unischema import Unischema

ROWGROUPS_INDEX_KEY = b'petastorm_tpu.rowgroups_index.v1'


def build_rowgroup_index(dataset_url, indexers):
    """Scan every rowgroup, feed each indexer the decoded values of its
    columns with the rowgroup's piece index (its position in
    ``load_row_groups``), and store the indexes in ``_common_metadata``."""
    handle = dataset_metadata.open_dataset(normalize_dataset_url_or_urls(dataset_url))
    try:
        schema = dataset_metadata.get_schema(handle)
    except MetadataError:
        schema = Unischema.from_arrow_schema(handle.arrow_dataset.schema)
    columns = sorted({col for indexer in indexers for col in indexer.column_names})
    unknown = [c for c in columns if c not in schema.fields]
    if unknown:
        raise ValueError('Indexed fields {} are not part of the schema'.format(unknown))
    parquet_format = pads.ParquetFileFormat()
    for piece_index, rg in enumerate(dataset_metadata.load_row_groups(handle)):
        fragment = parquet_format.make_fragment(rg.fragment_path, handle.filesystem,
                                                row_groups=[rg.row_group_id])
        records = fragment.to_table(columns=columns).to_pylist()
        decoded = [{name: _decode_value(schema.fields[name], value)
                    for name, value in record.items()} for record in records]
        for indexer in indexers:
            indexer.build_index(decoded, piece_index)
    payload = json.dumps([indexer.to_json_dict() for indexer in indexers]).encode('utf-8')
    dataset_metadata.write_dataset_metadata(handle, {ROWGROUPS_INDEX_KEY: payload})
    return indexers


def get_row_group_indexes(handle):
    """The stored indexes as ``{index_name: indexer}``."""
    metadata = dataset_metadata.read_metadata_dict(handle)
    if ROWGROUPS_INDEX_KEY not in metadata:
        raise ValueError('Dataset has no rowgroup index metadata; run '
                         'build_rowgroup_index first')
    entries = json.loads(metadata[ROWGROUPS_INDEX_KEY].decode('utf-8'))
    indexers = [indexer_from_json_dict(entry) for entry in entries]
    return {indexer.index_name: indexer for indexer in indexers}


def _decode_value(field, value):
    """One stored value as ``petastorm_tpu.unischema.decode_row`` decodes it
    (an index key is the ``str`` of this value, so the types must agree)."""
    if value is None:
        return None
    if field.codec is not None:
        return field.codec.decode(field, value)
    if field.numpy_dtype is Decimal:
        return value if isinstance(value, Decimal) else Decimal(str(value))
    if field.shape == () and np.dtype(field.numpy_dtype).kind not in ('U', 'S', 'O'):
        return np.dtype(field.numpy_dtype).type(value)
    if field.shape != ():
        return np.asarray(value, dtype=field.numpy_dtype)
    return value
