"""The rowgroup worker: loads one Parquet rowgroup, decodes it through the
compiled decode plan, applies the seeded in-rowgroup shuffle and publishes a
columnar batch. A trimmed copy of ``petastorm_tpu.reader_worker``: predicates,
transform specs, the rowgroup cache, NGram windows, retries/quarantine and the
telemetry sidecars are left for later slices."""

import re

import numpy as np
import pyarrow.dataset as pads

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.workers.worker_base import WorkerBase


class ColumnarBatch(object):
    """Decoded columns of one rowgroup: ``{field_name: ndarray | list}``.
    ``item_id`` ``(epoch, piece_index)`` names the work item that produced it
    (empty batches are published to carry it)."""

    __slots__ = ('columns', 'num_rows', 'item_id')

    def __init__(self, columns, num_rows, item_id=None):
        self.columns = columns
        self.num_rows = num_rows
        self.item_id = item_id


class WorkerSetup(object):
    """Per-reader configuration shared by every worker."""

    __slots__ = ('filesystem', 'schema', 'fields_to_read', 'result_schema',
                 'shuffle_rows', 'seed', 'partition_field_names', 'device_decode_fields')

    def __init__(self, filesystem, schema, fields_to_read, shuffle_rows=False, seed=None,
                 partition_field_names=(), device_decode_fields=()):
        self.filesystem = filesystem
        self.schema = schema
        self.fields_to_read = list(fields_to_read)
        self.shuffle_rows = shuffle_rows
        self.seed = seed
        self.partition_field_names = set(partition_field_names)
        #: fields whose payloads skip host decode and ship raw to the loader's
        #: device decode tail
        self.device_decode_fields = frozenset(device_decode_fields)
        self.result_schema = schema.create_schema_view(
            [re.escape(name) for name in self.fields_to_read])


class RowGroupWorker(WorkerBase):
    """Loads and decodes one rowgroup per ventilated item."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._setup = args
        self._parquet_format = pads.ParquetFileFormat()
        setup = args
        self._plan = decode_engine.compile_decode_plan(
            setup.schema, setup.fields_to_read,
            partition_field_names=setup.partition_field_names,
            device_decode_fields=setup.device_decode_fields)

    def process(self, piece_index, fragment_path, row_group_id, partition_keys=None,
                epoch_index=0):
        setup = self._setup
        item_id = (epoch_index, piece_index)
        fragment = self._parquet_format.make_fragment(fragment_path, setup.filesystem,
                                                      row_groups=[row_group_id])
        table = fragment.to_table(columns=[name for name in setup.fields_to_read
                                           if name not in setup.partition_field_names])
        columns = self._plan.execute(table, partition_keys or {},
                                     fragment_path=fragment_path)
        num_rows = table.num_rows
        if num_rows and setup.shuffle_rows:
            # the same seeded permutation petastorm_tpu's worker draws
            seed = None if setup.seed is None else (setup.seed + piece_index) % (2 ** 31)
            permutation = np.random.RandomState(seed).permutation(num_rows)
            columns = {name: _take(col, permutation) for name, col in columns.items()}
        self.publish_func(ColumnarBatch(columns if num_rows else {}, num_rows,
                                        item_id=item_id))


def _take(col, indices):
    if isinstance(col, np.ndarray):
        return col[indices]
    return [col[i] for i in indices]
