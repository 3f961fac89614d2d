"""Field-value -> rowgroup-set indexers: a copy of
``petastorm_tpu.etl.rowgroup_indexers`` with the same JSON form, so an index
built by either package reads in the other."""

from collections import defaultdict

from petastorm_tpu_torch.etl import RowGroupIndexerBase


class SingleFieldIndexer(RowGroupIndexerBase):
    """Maps every observed value of one field to the set of rowgroup (piece) indexes
    containing it. Mergeable via ``+`` for map-reduce builds (reference:
    rowgroup_indexers.py:21-77)."""

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._index_field = index_field
        self._index_data = defaultdict(set)

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._index_field]

    @property
    def indexed_values(self):
        return list(self._index_data.keys())

    def get_row_group_indexes(self, value_key):
        return self._index_data.get(_value_token(value_key), set())

    def build_index(self, decoded_rows, piece_index):
        if not decoded_rows:
            raise ValueError('Cannot build index for empty rowgroup')
        for row in decoded_rows:
            value = row[self._index_field]
            if value is not None:
                self._index_data[_value_token(value)].add(piece_index)

    def __add__(self, other):
        if other.column_names != self.column_names:
            raise ValueError('Cannot merge indexers of different fields')
        merged = SingleFieldIndexer(self._index_name, self._index_field)
        for source in (self, other):
            for key, pieces in source._index_data.items():
                merged._index_data[key] |= pieces
        return merged

    # JSON round-trip for the metadata store
    def to_json_dict(self):
        return {'type': 'single_field', 'index_name': self._index_name,
                'index_field': self._index_field,
                'data': {key: sorted(pieces) for key, pieces in self._index_data.items()}}

    @classmethod
    def from_json_dict(cls, d):
        indexer = cls(d['index_name'], d['index_field'])
        for key, pieces in d['data'].items():
            indexer._index_data[key] = set(pieces)
        return indexer


class FieldNotNullIndexer(RowGroupIndexerBase):
    """Indexes rowgroups that contain at least one non-null value of a field (reference:
    rowgroup_indexers.py:80-124)."""

    _NOT_NULL_KEY = '__not_null__'

    def __init__(self, index_name, index_field):
        self._index_name = index_name
        self._index_field = index_field
        self._pieces = set()

    @property
    def index_name(self):
        return self._index_name

    @property
    def column_names(self):
        return [self._index_field]

    @property
    def indexed_values(self):
        return [self._NOT_NULL_KEY]

    def get_row_group_indexes(self, value_key=None):
        return self._pieces

    def build_index(self, decoded_rows, piece_index):
        if not decoded_rows:
            raise ValueError('Cannot build index for empty rowgroup')
        for row in decoded_rows:
            if row[self._index_field] is not None:
                self._pieces.add(piece_index)
                break

    def __add__(self, other):
        if other.column_names != self.column_names:
            raise ValueError('Cannot merge indexers of different fields')
        merged = FieldNotNullIndexer(self._index_name, self._index_field)
        merged._pieces = self._pieces | other._pieces
        return merged

    def to_json_dict(self):
        return {'type': 'field_not_null', 'index_name': self._index_name,
                'index_field': self._index_field, 'data': sorted(self._pieces)}

    @classmethod
    def from_json_dict(cls, d):
        indexer = cls(d['index_name'], d['index_field'])
        indexer._pieces = set(d['data'])
        return indexer


def _value_token(value):
    """Index keys are stored as strings (JSON metadata); lookups tokenize the same way."""
    return str(value)


_INDEXER_TYPES = {'single_field': SingleFieldIndexer, 'field_not_null': FieldNotNullIndexer}


def indexer_from_json_dict(d):
    """Rebuild an indexer from its ``to_json_dict()`` persistence form."""
    return _INDEXER_TYPES[d['type']].from_json_dict(d)
