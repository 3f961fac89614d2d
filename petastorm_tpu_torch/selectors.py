"""Rowgroup selectors over the indexes that
:func:`~petastorm_tpu_torch.etl.rowgroup_indexing.build_rowgroup_index` stores:
a copy of ``petastorm_tpu.selectors``. A selector returns the piece indexes
(positions in the full ``load_row_groups`` enumeration) to read."""


class RowGroupSelectorBase(object):
    """Rowgroup-selector interface (reference: petastorm/selectors.py) over built
    rowgroup indexes."""

    def select_row_groups(self, index_dict):
        """Return the set of piece indexes to read, given {index_name: indexer}."""
        raise NotImplementedError()


class SingleIndexSelector(RowGroupSelectorBase):
    """Rowgroups containing any of ``values`` in the named index (reference:
    selectors.py:30-55)."""

    def __init__(self, index_name, values_list):
        self._index_name = index_name
        self._values = list(values_list)

    def select_row_groups(self, index_dict):
        if self._index_name not in index_dict:
            raise ValueError('Index {!r} not found in dataset metadata (available: {})'
                             .format(self._index_name, sorted(index_dict)))
        indexer = index_dict[self._index_name]
        selected = set()
        for value in self._values:
            selected |= indexer.get_row_group_indexes(value)
        return selected


class IntersectIndexSelector(RowGroupSelectorBase):
    """Rowgroups selected by ALL child selectors (reference: selectors.py:58-78)."""

    def __init__(self, selectors):
        self._selectors = list(selectors)

    def select_row_groups(self, index_dict):
        result = None
        for selector in self._selectors:
            pieces = selector.select_row_groups(index_dict)
            result = pieces if result is None else (result & pieces)
        return result or set()


class UnionIndexSelector(RowGroupSelectorBase):
    """Rowgroups selected by ANY child selector (reference: selectors.py:81-101)."""

    def __init__(self, selectors):
        self._selectors = list(selectors)

    def select_row_groups(self, index_dict):
        result = set()
        for selector in self._selectors:
            result |= selector.select_row_groups(index_dict)
        return result
