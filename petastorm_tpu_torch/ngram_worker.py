"""NGram pieces inside the rowgroup worker: a copy of
``petastorm_tpu.ngram_worker``.

One work item is one rowgroup, and its windows are formed inside it. A
shuffle-row-drop partition takes ``length - 1`` carry-over rows from the next
partition, so the windows across the partition boundary survive. The payload
is columnar: one :class:`NGramWindows` holds the decoded columns once and the
window start indices from :meth:`~petastorm_tpu_torch.ngram.NGram.form_ngram_columnar`;
the reader gathers windows from it when they are consumed."""

import numpy as np


class NGramWindows(object):
    """The windows of one rowgroup piece: ``starts[i]`` is the first row of
    window i, and every window spans ``length`` consecutive rows of
    ``columns``. ``item_id`` is the work item's ``(epoch, piece,
    drop_partition)``, the unit of the reader's accounting (a piece with no
    window is published too, to carry it). As in the JAX package, NGram
    pieces count no cache hits or misses. ``retries``, ``quarantine`` and
    ``breakers`` are :class:`~petastorm_tpu_torch.reader_worker.ColumnarBatch`'s
    resilience fields, ``telemetry``, ``trace`` and ``lineage`` its
    sidecars."""

    __slots__ = ('columns', 'starts', 'item_id', 'retries', 'quarantine', 'breakers',
                 'telemetry', 'trace', 'lineage')

    def __init__(self, columns, starts, item_id=None, retries=0, quarantine=None,
                 breakers=None, telemetry=None, trace=None, lineage=None):
        self.columns = columns
        self.starts = starts
        self.item_id = item_id
        self.retries = retries
        self.quarantine = quarantine
        self.breakers = breakers
        self.telemetry = telemetry
        self.trace = trace
        self.lineage = lineage

    def __len__(self):
        return len(self.starts)

    @property
    def num_rows(self):
        """Windows in this payload (the window is the NGram path's row unit)."""
        return len(self.starts)


def process_ngram_piece(worker, piece_index, fragment_path, row_group_id, partition_keys,
                        shuffle_row_drop_partition, epoch_index=0, with_retry=None):
    """Decode one rowgroup piece and form its windows: an :class:`NGramWindows`
    (possibly of no window) tagged with the piece's item id. ``with_retry``
    runs the load under the reader's retry policy."""
    from petastorm_tpu_torch.reader_worker import _take
    setup = worker._setup
    ngram = setup.ngram

    def load_windows():
        fragment = worker._make_fragment(fragment_path, row_group_id)
        table = fragment.to_table(columns=worker._storage_columns(setup.fields_to_read))
        columns = worker._decode_table(table, partition_keys, setup.fields_to_read,
                                       fragment_path=fragment_path)
        num_rows = table.num_rows
        part_index, num_parts = shuffle_row_drop_partition
        if num_parts > 1 and num_rows > 0:
            partition_indexes = np.floor(
                np.arange(num_rows) / (float(num_rows) / min(num_rows, num_parts)))
            # carry over length-1 rows from the next partition, so the windows
            # across the boundary form
            next_part = np.nonzero(partition_indexes >= part_index + 1)[0]
            if next_part.size:
                partition_indexes[next_part[:ngram.length - 1]] = part_index
            selected = np.nonzero(partition_indexes == part_index)[0]
            columns = {name: _take(col, selected) for name, col in columns.items()}
            num_rows = len(selected)
        timestamps = np.asarray(columns[ngram.timestamp_field_name][:num_rows])
        return {'columns': columns, 'starts': ngram.form_ngram_columnar(timestamps)}

    cache_key = 'ngram:{}:{}:{}:{}'.format(setup.dataset_token, fragment_path,
                                           row_group_id, shuffle_row_drop_partition)
    payload = setup.cache.get(cache_key, load_windows if with_retry is None
                              else lambda: with_retry(load_windows))
    starts = payload['starts']
    if setup.shuffle_rows and len(starts):
        # seeded per piece: a replayed piece gives the same window order,
        # which makes a window-exact resume possible
        seed = None if setup.seed is None else (setup.seed + piece_index) % (2 ** 31)
        starts = starts[np.random.RandomState(seed).permutation(len(starts))]
    item_id = (epoch_index, piece_index, shuffle_row_drop_partition[0])
    return NGramWindows(payload['columns'], starts, item_id=item_id)
