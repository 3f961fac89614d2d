"""A fake Reader for adapter tests: rows generated from a schema without any
IO (a copy of ``petastorm_tpu.test_util.reader_mock``)."""

from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.generator import generate_random_datapoint
from petastorm_tpu_torch.unischema import dict_to_encoded_row


def _decode_row(row, schema):
    """An encoded row dict decoded as the JAX package's ``decode_row`` does:
    codec fields through their codec, codec-less scalars to their numpy type,
    codec-less lists to arrays."""
    decoded = {}
    for name, value in row.items():
        field = schema.fields.get(name)
        if value is None or field is None:
            decoded[name] = value
        elif field.codec is not None:
            decoded[name] = field.codec.decode(field, value)
        elif field.numpy_dtype is Decimal:
            decoded[name] = value if isinstance(value, Decimal) else Decimal(str(value))
        else:
            dtype = np.dtype(field.numpy_dtype)
            textual = dtype.kind in ('U', 'S', 'O')
            if field.shape == ():
                decoded[name] = value if textual else dtype.type(value)
            else:
                decoded[name] = np.asarray(value, dtype=object if textual else dtype)
    return decoded


def schema_data_generator_example(schema, rng=None):
    """The default generator: a random datapoint a row, round-tripped through
    the codecs so the values look exactly like a reader's output."""
    rng = rng or np.random.RandomState(0)

    def generate(row_index):
        row = generate_random_datapoint(schema, rng)
        return _decode_row(dict_to_encoded_row(schema, row), schema)

    return generate


class ReaderMock(object):
    """Mimics a Reader: iterates the namedtuples ``row_generator(index)``
    makes, forever or for ``num_rows`` rows."""

    def __init__(self, schema, row_generator=None, num_rows=None):
        self.schema = schema
        self.result_schema = schema
        self.is_batched_reader = False
        self.ngram = None
        self.last_row_consumed = False
        self._row_generator = row_generator or schema_data_generator_example(schema)
        self._num_rows = num_rows
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._num_rows is not None and self._index >= self._num_rows:
            self.last_row_consumed = True
            raise StopIteration
        row = self._row_generator(self._index)
        self._index += 1
        return self.schema.make_namedtuple(**row)

    next = __next__

    def reset(self):
        self._index = 0
        self.last_row_consumed = False

    def stop(self):
        pass

    def join(self):
        pass

    @property
    def diagnostics(self):
        return {}
