"""The rowgroup worker: loads one Parquet rowgroup, keeps its
shuffle-row-drop partition, decodes it through the compiled decode plan,
applies the seeded in-rowgroup shuffle and the :class:`TransformSpec`, and
publishes a columnar batch. A trimmed copy of ``petastorm_tpu.reader_worker``:
predicates, the rowgroup cache, NGram windows, retries/quarantine and the
telemetry sidecars are left for later slices."""

import re

import numpy as np
import pyarrow.dataset as pads

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers.worker_base import WorkerBase


class ColumnarBatch(object):
    """Decoded columns of (a drop partition of) one rowgroup:
    ``{field_name: ndarray | list}``. ``item_id`` ``(epoch, piece_index,
    drop_partition)`` names the work item that produced it, the unit of the
    reader's checkpoint accounting (empty batches are published to carry it)."""

    __slots__ = ('columns', 'num_rows', 'item_id')

    def __init__(self, columns, num_rows, item_id=None):
        self.columns = columns
        self.num_rows = num_rows
        self.item_id = item_id


class WorkerSetup(object):
    """Per-reader configuration shared by every worker. ``batched_output``
    marks the batch reader: it emits stored values without codec decode, and
    its transform ``func`` takes a ``DataFrame`` unless the spec is
    ``batched``."""

    __slots__ = ('filesystem', 'schema', 'fields_to_read', 'result_schema',
                 'transform_spec', 'batched_output', 'shuffle_rows', 'seed',
                 'partition_field_names', 'device_decode_fields')

    def __init__(self, filesystem, schema, fields_to_read, transform_spec=None,
                 batched_output=False, shuffle_rows=False, seed=None,
                 partition_field_names=(), device_decode_fields=()):
        self.filesystem = filesystem
        self.schema = schema
        self.fields_to_read = list(fields_to_read)
        self.transform_spec = transform_spec
        self.batched_output = batched_output
        self.shuffle_rows = shuffle_rows
        self.seed = seed
        self.partition_field_names = set(partition_field_names)
        #: fields whose payloads skip host decode and ship raw to the loader's
        #: device decode tail
        self.device_decode_fields = frozenset(device_decode_fields)
        read_view = schema.create_schema_view(
            [re.escape(name) for name in self.fields_to_read])
        if transform_spec is not None:
            self.result_schema = transform_schema(read_view, transform_spec)
        else:
            self.result_schema = read_view


class RowGroupWorker(WorkerBase):
    """Loads and processes one rowgroup (drop partition) per ventilated item."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._setup = args
        self._parquet_format = pads.ParquetFileFormat()
        setup = args
        self._plan = decode_engine.compile_decode_plan(
            setup.schema, setup.fields_to_read,
            partition_field_names=setup.partition_field_names,
            decode=not setup.batched_output,
            device_decode_fields=setup.device_decode_fields)

    def process(self, piece_index, fragment_path, row_group_id, partition_keys=None,
                shuffle_row_drop_partition=(0, 1), epoch_index=0):
        setup = self._setup
        item_id = (epoch_index, piece_index, shuffle_row_drop_partition[0])
        fragment = self._parquet_format.make_fragment(fragment_path, setup.filesystem,
                                                      row_groups=[row_group_id])
        table = fragment.to_table(columns=[name for name in setup.fields_to_read
                                           if name not in setup.partition_field_names])
        part_index, num_parts = shuffle_row_drop_partition
        if num_parts > 1:
            # the same equal split of row indices petastorm_tpu's worker takes
            table = table.take(np.array_split(np.arange(table.num_rows), num_parts)[part_index])
        columns = self._plan.execute(table, partition_keys or {},
                                     fragment_path=fragment_path)
        num_rows = table.num_rows
        if num_rows:
            if setup.shuffle_rows:
                # the same seeded permutation petastorm_tpu's worker draws
                seed = None if setup.seed is None else (setup.seed + piece_index) % (2 ** 31)
                permutation = np.random.RandomState(seed).permutation(num_rows)
                columns = {name: _take(col, permutation) for name, col in columns.items()}
            columns, num_rows = self._apply_transform(columns, num_rows)
        # an emptied item is published too: every item yields exactly one
        # result, so the reader's consumption accounting stays exact
        self.publish_func(ColumnarBatch(columns if num_rows else {}, num_rows,
                                        item_id=item_id))

    def _apply_transform(self, columns, num_rows):
        setup = self._setup
        spec = setup.transform_spec
        if spec is None:
            return columns, num_rows
        fields = setup.result_schema.fields
        if spec.func is None:
            # a spec that only deletes, selects or redeclares fields
            return {name: columns[name] for name in fields}, num_rows
        if spec.batched:
            # whole columns in, whole columns out (both readers)
            out_columns = spec.func(dict(columns))
            out = {}
            out_rows = num_rows
            for name, field in fields.items():
                values = out_columns[name]
                if not isinstance(values, np.ndarray):
                    values = decode_engine.stack_if_uniform(list(values), field)
                out[name] = values
                out_rows = len(values)
            return out, out_rows
        if setup.batched_output:
            # the batch reader's pandas contract; pandas is needed only here
            import pandas as pd
            frame = pd.DataFrame({name: list(col) if not isinstance(col, list) else col
                                  for name, col in columns.items()})
            frame = spec.func(frame)
            return ({name: decode_engine.stack_if_uniform(list(frame[name]), field)
                     for name, field in fields.items()}, len(frame))
        # the row reader: func takes one row dict at a time
        rows = [spec.func({name: col[i] for name, col in columns.items()})
                for i in range(num_rows)]
        return ({name: decode_engine.stack_if_uniform([row[name] for row in rows], field)
                 for name, field in fields.items()}, len(rows))


def _take(col, indices):
    if isinstance(col, np.ndarray):
        return col[indices]
    return [col[i] for i in indices]
