"""Random rows for any Unischema, within each dtype's range: a copy of
``petastorm_tpu.generator``, for synthesizing stores."""

from decimal import Decimal

import numpy as np


def generate_random_datapoint(schema, rng=None, var_dim_max=10, string_length=8):
    """One row dict with random values matching each field's dtype/shape."""
    rng = rng or np.random.RandomState()
    row = {}
    for name, field in schema.fields.items():
        shape = tuple(var_dim_max if dim is None else dim for dim in field.shape)
        row[name] = _random_value(field, shape, rng, string_length)
    return row


def _random_value(field, shape, rng, string_length):
    if field.numpy_dtype is Decimal:
        return Decimal('{:.2f}'.format(rng.rand() * 100))
    dtype = np.dtype(field.numpy_dtype)
    if dtype.kind in ('U', 'S'):
        letters = np.array(list('abcdefghijklmnopqrstuvwxyz'))

        def _one_string():
            value = ''.join(rng.choice(letters, string_length))
            return value.encode('utf-8') if dtype.kind == 'S' else value

        if shape == ():
            return _one_string()
        count = int(np.prod(shape))
        return np.array([_one_string() for _ in range(count)]).reshape(shape)
    if dtype.kind == 'b':
        data = rng.randint(0, 2, shape).astype(bool)
    elif dtype.kind in ('i', 'u'):
        info = np.iinfo(dtype)
        low = max(info.min, -(1 << 30))
        high = min(info.max, 1 << 30)
        data = rng.randint(low, high, size=shape or None)
        data = np.asarray(data, dtype=dtype)
    elif dtype.kind == 'f':
        data = rng.rand(*shape).astype(dtype) if shape else dtype.type(rng.rand())
    elif dtype.kind == 'M':
        data = (np.datetime64('2020-01-01') +
                np.timedelta64(1, 'h') * rng.randint(0, 10000, size=shape or None))
    else:
        raise ValueError('Cannot generate data for dtype {}'.format(dtype))
    if shape == ():
        return data if np.isscalar(data) or isinstance(data, np.generic) \
            else dtype.type(data)
    return np.asarray(data, dtype=dtype).reshape(shape)


#: the reference petastorm's name for the same function
generate_datapoint = generate_random_datapoint
