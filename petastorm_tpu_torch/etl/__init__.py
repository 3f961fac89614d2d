"""Dataset writing, metadata and rowgroup indexing."""


class RowGroupIndexerBase(object):
    """Base class of rowgroup indexers
    (:mod:`~petastorm_tpu_torch.etl.rowgroup_indexers`)."""

    @property
    def index_name(self):
        raise NotImplementedError()

    @property
    def column_names(self):
        raise NotImplementedError()

    @property
    def indexed_values(self):
        raise NotImplementedError()

    def get_row_group_indexes(self, value_key):
        raise NotImplementedError()

    def build_index(self, decoded_rows, piece_index):
        raise NotImplementedError()
