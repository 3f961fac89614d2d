"""NGram: sliding windows over timestamp-sorted rows, a copy of
``petastorm_tpu.ngram`` (same spec, same windows in the same order).

``fields`` maps timestep offsets to per-timestep field subsets (fields or
regexes); ``delta_threshold`` bounds the timestamp gap between consecutive
timesteps; ``timestamp_overlap=False`` forbids emitted windows from
overlapping in timestamp range. Windows are formed inside one rowgroup, so
the rowgroup size bounds the window length.

:meth:`NGram.form_ngram_columnar` works on columnar batches and returns
window start indices; :meth:`NGram.windows_as_arrays` gathers window-major
arrays ``{field: (num_windows, length, *shape)}``, the form the loaders
upload (the window is the batch axis).
"""

import re

import numpy as np

from petastorm_tpu_torch.unischema import UnischemaField, match_unischema_fields


class NGram(object):
    """Sequence-window spec (reference: petastorm/ngram.py): ``{offset: fields}``
    windows over timestamp-ordered rows, gated by ``delta_threshold``. Pass as
    ``schema_fields`` to ``make_reader``; the row path yields ``{offset:
    namedtuple}`` per window, the device path window-major sequence batches
    (:meth:`windows_as_arrays`)."""

    def __init__(self, fields, delta_threshold, timestamp_field, timestamp_overlap=True):
        """
        :param fields: dict {offset(int): list of UnischemaField or regex str}
        :param delta_threshold: max allowed timestamp delta between consecutive timesteps
        :param timestamp_field: UnischemaField (or name) ordering the rows
        :param timestamp_overlap: when False, consecutive emitted windows must not overlap
            in timestamp range (reference: ngram.py:102-125)
        """
        if not isinstance(fields, dict) or not fields:
            raise ValueError('fields must be a non-empty dict of {offset: [fields]}')
        if not all(isinstance(key, int) for key in fields):
            raise ValueError('field keys must be integers (timestep offsets)')
        self._fields = {key: list(value) for key, value in sorted(fields.items())}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self.timestamp_overlap = timestamp_overlap

    @property
    def length(self):
        """Window span: max offset - min offset + 1 (reference: ngram.py:127-133)."""
        keys = list(self._fields.keys())
        return max(keys) - min(keys) + 1

    @property
    def fields(self):
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def timestamp_field_name(self):
        if isinstance(self._timestamp_field, UnischemaField):
            return self._timestamp_field.name
        return self._timestamp_field

    # -------------------------------------------------------------- resolution

    def resolve_regex_field_names(self, schema):
        """Expand any regex entries against the schema (reference: ngram.py:195-203)."""
        for key, field_list in self._fields.items():
            resolved = []
            for item in field_list:
                if isinstance(item, UnischemaField):
                    resolved.append(item)
                elif isinstance(item, str):
                    matched = match_unischema_fields(schema, [item])
                    if not matched:
                        raise ValueError('NGram pattern {!r} matched no fields'.format(item))
                    resolved.extend(matched)
                else:
                    raise ValueError('NGram fields must be UnischemaFields or regex '
                                     'strings, got {!r}'.format(item))
            # overlapping patterns may match the same field twice: dedup by name,
            # preserving first-match order
            seen = {}
            for field in resolved:
                seen.setdefault(field.name, field)
            self._fields[key] = list(seen.values())

    def get_field_names_at_timestep(self, key):
        return [f.name for f in self._fields.get(key, [])]

    def get_field_names_at_all_timesteps(self):
        names = []
        for key in self._fields:
            for name in self.get_field_names_at_timestep(key):
                if name not in names:
                    names.append(name)
        ts_name = self.timestamp_field_name
        if ts_name not in names:
            names.append(ts_name)
        return names

    def get_schema_at_timestep(self, schema, key):
        """The view of ``schema`` holding the fields of timestep ``key``."""
        names = [n for n in self.get_field_names_at_timestep(key) if n in schema.fields]
        return schema.create_schema_view([re.escape(n) for n in names])

    # -------------------------------------------------------------- formation

    def form_ngram_columnar(self, timestamps):
        """Compute window start indices over a timestamp vector (rows of ONE rowgroup,
        sorted ascending). Returns an array of starts; window i spans
        ``starts[i] : starts[i] + length`` (the reference's form_ngram,
        ngram.py:225-270, on columns).

        Vectorized: the delta-threshold scan is a cumulative count of oversized gaps
        (a window is valid iff no bad gap falls inside it) — O(n) numpy, no Python loop
        over rows. Only the ``timestamp_overlap=False`` greedy selection walks the
        (already-filtered) candidate list sequentially, as the emitted-window dependency
        chain requires."""
        timestamps = np.asarray(timestamps)
        n = len(timestamps)
        length = self.length
        if n < length:
            return np.empty(0, dtype=np.int64)
        if np.any(timestamps[1:] < timestamps[:-1]):
            raise NotImplementedError(
                'NGram assumes data sorted by {!r}, which is not the case'
                .format(self.timestamp_field_name))
        if length == 1:
            candidates = np.arange(n, dtype=np.int64)
        else:
            bad = np.diff(timestamps) > self._delta_threshold
            bad_before = np.concatenate([[0], np.cumsum(bad)])
            # window at start s covers deltas s .. s+length-2
            window_bad = bad_before[length - 1:] - bad_before[:n - length + 1]
            candidates = np.nonzero(window_bad == 0)[0].astype(np.int64)
        if self.timestamp_overlap:
            return candidates
        starts = []
        prev_end_ts = None
        for start in candidates:
            if prev_end_ts is not None and timestamps[start] <= prev_end_ts:
                continue
            starts.append(start)
            prev_end_ts = timestamps[start + length - 1]
        return np.asarray(starts, dtype=np.int64)

    def windows_as_arrays(self, columns, starts):
        """Materialize windows as window-major arrays: ``{field: (num_windows, length,
        *field_shape)}`` via one vectorized gather per column — the device-layer
        representation the loaders upload.

        Every column is emitted over the FULL window length; the reference's
        per-offset field subsets (ngram.py:215-223) are a row-path view — on the
        device, consumers take ``batch[field][:, off]`` where needed. Overlapping
        windows are materialized (O(windows x length) host memory, vs the
        shared-column row path's O(rows)); that copy is the price of a dense
        tensor on the card."""
        starts = np.asarray(starts, dtype=np.int64)
        length = self.length
        idx = starts[:, None] + np.arange(length, dtype=np.int64)
        out = {}
        for name, col in columns.items():
            if isinstance(col, list):
                raise ValueError(
                    'NGram field {!r} is ragged (variable shape); give it a fixed '
                    'shape via a TransformSpec before forming device windows'
                    .format(name))
            out[name] = np.asarray(col)[idx]
        return out

    def form_ngram(self, rows):
        """petastorm's row-dict API: ``rows`` (a list of row dicts in
        timestamp order) -> a list of windows ``{offset: row dict of that
        timestep's fields}``, the windows :meth:`form_ngram_columnar` starts."""
        if not rows:
            return []
        timestamps = np.asarray([row[self.timestamp_field_name] for row in rows])
        base_key = min(self._fields.keys())
        windows = []
        for start in self.form_ngram_columnar(timestamps):
            window = {}
            for key in self._fields:
                wanted = set(self.get_field_names_at_timestep(key))
                row = rows[start + key - base_key]
                window[key] = {name: row[name] for name in row if name in wanted}
            windows.append(window)
        return windows

    def make_namedtuples(self, window, schema=None):
        """A :meth:`form_ngram` window ``{offset: row dict}`` -> ``{offset:
        namedtuple}`` (fields in sorted order; ``schema`` is petastorm's
        argument and unused)."""
        return {key: _timestep_namedtuple(tuple(sorted(row)))(**row)
                for key, row in window.items()}

    def window_plan(self, column_names):
        """Precompute the per-timestep emission plan for a given set of available
        columns: ``[(offset, row_position, field_names, namedtuple_cls), ...]``. The
        plan is identical for every window of every batch with the same columns —
        compute it once, then emit windows with :meth:`window_from_plan` (hoists the
        sort/filter/namedtuple-cache work off the per-window hot path)."""
        column_names = set(column_names)
        base_key = min(self._fields.keys())
        plan = []
        for key, field_list in self._fields.items():
            names = tuple(sorted({f.name for f in field_list if f.name in column_names}))
            plan.append((key, key - base_key, names, _timestep_namedtuple(names)))
        return plan

    @staticmethod
    def window_from_plan(columns, start, plan):
        """Emit one ``{offset: namedtuple}`` window straight from columnar data using a
        precomputed :meth:`window_plan` — the hot-path consumer of
        :meth:`form_ngram_columnar` gather indices (no intermediate per-row dicts;
        columns are shared across all windows of a rowgroup)."""
        return {key: cls._make(columns[name][start + position] for name in names)
                for key, position, names, cls in plan}


_timestep_cache = {}


def _timestep_namedtuple(names):
    if names not in _timestep_cache:
        from collections import namedtuple
        _timestep_cache[names] = namedtuple('NGramTimestep', names)
    return _timestep_cache[names]
