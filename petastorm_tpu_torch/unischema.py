"""Unischema: one schema definition for storage (Arrow) and rows (namedtuples).

A trimmed copy of ``petastorm_tpu.unischema``: the same JSON layout
(``to_json_dict``/``from_json_dict``), so a schema embedded by either package
loads in the other, and the same schema inference from plain Parquet stores
(:meth:`Unischema.from_arrow_schema`, for ``make_batch_reader``). The JAX
``ShapeDtypeStruct`` render is left out.
"""

import copy
import re
import threading
from collections import namedtuple
from decimal import Decimal

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.codecs import (FieldCodec, arrow_type_for_numpy,
                                        codec_from_config)


class UnischemaField(object):
    """A single field: ``(name, numpy_dtype, shape, codec, nullable)``; ``shape``
    dims may be None (variable length). Equality is value-based, over the
    codec's config rather than its identity."""

    __slots__ = ('name', 'numpy_dtype', 'shape', 'codec', 'nullable')

    def __init__(self, name, numpy_dtype, shape=(), codec=None, nullable=False):
        if codec is not None and not isinstance(codec, FieldCodec):
            raise TypeError('codec must be a FieldCodec or None, got {!r}'.format(codec))
        self.name = name
        self.numpy_dtype = numpy_dtype
        self.shape = tuple(shape)
        self.codec = codec
        self.nullable = nullable

    def _key(self):
        codec_config = self.codec.to_config() if self.codec is not None else None
        return (self.name, _dtype_token(self.numpy_dtype), self.shape,
                None if codec_config is None else tuple(sorted(codec_config.items())),
                self.nullable)

    def __eq__(self, other):
        return isinstance(other, UnischemaField) and self._key() == other._key()

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return ('UnischemaField(name={!r}, numpy_dtype={}, shape={}, codec={}, nullable={})'
                .format(self.name, _dtype_token(self.numpy_dtype), self.shape, self.codec,
                        self.nullable))

    def arrow_type(self):
        """Arrow storage type of this field's encoded column."""
        if self.codec is not None:
            return self.codec.arrow_type(self)
        if self.numpy_dtype is Decimal:
            return pa.string()
        if self.shape == ():
            return arrow_type_for_numpy(self.numpy_dtype)
        if len(self.shape) == 1:
            return pa.list_(arrow_type_for_numpy(self.numpy_dtype))
        raise ValueError('Field {} has shape {} but no codec; multidim fields require a codec'
                         .format(self.name, self.shape))

    def to_json_dict(self):
        return {
            'name': self.name,
            'numpy_dtype': _dtype_token(self.numpy_dtype),
            'shape': list(self.shape),
            'codec': self.codec.to_config() if self.codec is not None else None,
            'nullable': self.nullable,
        }

    @classmethod
    def from_json_dict(cls, field_dict):
        codec_config = field_dict.get('codec')
        return cls(
            name=field_dict['name'],
            numpy_dtype=_dtype_from_token(field_dict['numpy_dtype']),
            shape=tuple(field_dict['shape']),
            codec=codec_from_config(codec_config) if codec_config is not None else None,
            nullable=field_dict.get('nullable', False),
        )


def _dtype_token(numpy_dtype):
    """Stable string token for a field dtype (JSON store + hashing)."""
    if numpy_dtype is Decimal:
        return 'Decimal'
    dtype = np.dtype(numpy_dtype)
    return dtype.str.lstrip('<>=|') if dtype.kind in ('U', 'S') else dtype.name


def _dtype_from_token(token):
    if token == 'Decimal':
        return Decimal
    return np.dtype(token)


class _NamedtupleCache(object):
    """One namedtuple class per (schema name, field names), so type identity is
    stable across calls."""

    _lock = threading.Lock()
    _store = {}

    @classmethod
    def get(cls, parent_name, field_names):
        key = (parent_name, tuple(field_names))
        with cls._lock:
            if key not in cls._store:
                cls._store[key] = namedtuple(parent_name or 'UnischemaRow', field_names)
            return cls._store[key]


class Unischema(object):
    """An ordered collection of :class:`UnischemaField` (input order kept)."""

    def __init__(self, name, fields):
        self._name = name
        self._fields = {}
        for field in fields:
            if field.name in self._fields:
                raise ValueError('Duplicate field name {!r} in schema {!r}'
                                 .format(field.name, name))
            self._fields[field.name] = field
        for field_name, field in self._fields.items():
            if not hasattr(self, field_name):
                setattr(self, field_name, field)

    @property
    def name(self):
        return self._name

    @property
    def fields(self):
        """Ordered dict of name -> UnischemaField."""
        return self._fields

    def __iter__(self):
        return iter(self._fields.values())

    def __len__(self):
        return len(self._fields)

    def __eq__(self, other):
        return (isinstance(other, Unischema) and self._name == other._name
                and list(self._fields.values()) == list(other._fields.values()))

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((self._name, tuple(self._fields.values())))

    def __repr__(self):
        lines = ['  {!r}'.format(f) for f in self._fields.values()]
        return 'Unischema({!r}, [\n{}\n])'.format(self._name, ',\n'.join(lines))

    def create_schema_view(self, fields_or_patterns):
        """Subset view from UnischemaField instances, field names, or regex
        patterns (fullmatch); field order follows the schema."""
        if isinstance(fields_or_patterns, (str, UnischemaField)):
            fields_or_patterns = [fields_or_patterns]
        patterns = []
        for item in fields_or_patterns:
            if isinstance(item, UnischemaField):
                if item.name not in self._fields:
                    raise ValueError('Field {!r} does not belong to schema {!r}'
                                     .format(item.name, self._name))
                patterns.append(re.escape(item.name))
            elif isinstance(item, str):
                patterns.append(item)
            else:
                raise ValueError('create_schema_view accepts UnischemaFields, names or '
                                 'regex patterns; got {!r}'.format(item))
        compiled = [re.compile(p) for p in patterns]
        view_fields = [f for name, f in self._fields.items()
                       if any(c.fullmatch(name) for c in compiled)]
        if not view_fields:
            raise ValueError('create_schema_view matched no fields of schema {!r} '
                             'with patterns {!r}'.format(self._name, patterns))
        return Unischema('{}_view'.format(self._name), view_fields)

    @property
    def namedtuple(self):
        """The cached namedtuple class for this schema's field set."""
        return _NamedtupleCache.get(self._name, list(self._fields))

    def make_namedtuple(self, **kwargs):
        """A row namedtuple of this schema's fields from keyword arguments."""
        return self.namedtuple(**{k: kwargs[k] for k in self._fields})

    def as_arrow_schema(self):
        """Arrow schema of the *encoded* (storage) representation."""
        return pa.schema([pa.field(f.name, f.arrow_type(), nullable=bool(f.nullable))
                          for f in self._fields.values()])

    def to_json_dict(self):
        return {
            'version': 1,
            'name': self._name,
            'fields': [f.to_json_dict() for f in self._fields.values()],
        }

    @classmethod
    def from_json_dict(cls, schema_dict):
        version = schema_dict.get('version', 1)
        if version != 1:
            raise ValueError('Unsupported schema version {}'.format(version))
        return cls(schema_dict['name'],
                   [UnischemaField.from_json_dict(f) for f in schema_dict['fields']])

    @classmethod
    def from_arrow_schema(cls, arrow_schema, omit_unsupported_fields=True, name='inferred'):
        """Infer a codec-less Unischema from a plain Parquet/Arrow schema: list
        types become shape ``(None,)``; unsupported types are skipped with a
        warning (or raise when ``omit_unsupported_fields=False``)."""
        import warnings
        fields = []
        for arrow_field in arrow_schema:
            try:
                numpy_dtype, shape = _numpy_from_arrow_type(arrow_field.type)
            except ValueError as exc:
                if omit_unsupported_fields:
                    warnings.warn('Suppressing unsupported field {!r}: {}'
                                  .format(arrow_field.name, exc))
                    continue
                raise
            fields.append(UnischemaField(arrow_field.name, numpy_dtype, shape,
                                         codec=None, nullable=arrow_field.nullable))
        return cls(name, fields)


def _numpy_from_arrow_type(arrow_type):
    """``(numpy_dtype, shape)`` of an Arrow type."""
    import pyarrow.types as patypes
    if patypes.is_list(arrow_type) or patypes.is_large_list(arrow_type):
        inner_dtype, inner_shape = _numpy_from_arrow_type(arrow_type.value_type)
        if inner_shape != ():
            raise ValueError('Nested list type {} is not supported'.format(arrow_type))
        return inner_dtype, (None,)
    if patypes.is_decimal(arrow_type):
        return Decimal, ()
    if patypes.is_string(arrow_type) or patypes.is_large_string(arrow_type):
        return np.dtype('str_'), ()
    if patypes.is_binary(arrow_type) or patypes.is_large_binary(arrow_type):
        return np.dtype('bytes_'), ()
    if patypes.is_timestamp(arrow_type) or patypes.is_date(arrow_type):
        return np.dtype('datetime64[ns]'), ()
    try:
        return np.dtype(arrow_type.to_pandas_dtype()), ()
    except (NotImplementedError, pa.ArrowNotImplementedError):
        raise ValueError('Arrow type {} has no numpy mapping'.format(arrow_type))


def match_unischema_fields(schema, field_regexes):
    """The schema's fields whose names fullmatch any of ``field_regexes``."""
    if not field_regexes:
        return []
    compiled = [re.compile(p) for p in field_regexes]
    return [field for name, field in schema.fields.items()
            if any(c.fullmatch(name) for c in compiled)]


def dict_to_encoded_row(schema, row_dict):
    """Validate and codec-encode one row dict into its storage representation
    (the input of the Arrow writer in :mod:`petastorm_tpu_torch.etl`). Missing
    nullable fields become None; missing non-nullable ones raise."""
    if not isinstance(row_dict, dict):
        raise TypeError('row_dict must be a dict, got {!r}'.format(type(row_dict)))
    unknown = set(row_dict) - set(schema.fields)
    if unknown:
        raise ValueError('Fields {} are not part of schema {!r}'.format(sorted(unknown),
                                                                        schema.name))
    full_dict = copy.copy(row_dict)
    encoded = {}
    for name, field in schema.fields.items():
        if name not in full_dict and not field.nullable:
            raise ValueError('Field {} is not found in row and is not nullable'
                             .format(name))
        value = full_dict.get(name)
        if value is None:
            if not field.nullable:
                raise ValueError('Field {} is not nullable but got None'.format(name))
            encoded[name] = None
        elif field.codec is not None:
            encoded[name] = field.codec.encode(field, value)
        else:
            encoded[name] = _default_encode(field, value)
    return encoded


def _default_encode(field, value):
    """Encode a codec-less field (scalar or 1-d list column) for the Arrow writer."""
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return value.item()
        if value.ndim == 1:
            return value.tolist()
        raise ValueError('Field {} has no codec; cannot store {}-dim array natively'
                         .format(field.name, value.ndim))
    if isinstance(value, np.generic):
        return value.item()
    return value
