"""Reading stores written by the reference petastorm: a copy of
``petastorm_tpu.etl.legacy``.

The reference embeds its Unischema as a pickle under
``dataset-toolkit.unischema.v1``. To read those stores without petastorm or
pyspark installed, this module depickles through a restricted unpickler whose
``find_class`` maps every petastorm and ``pyspark.sql.types`` global onto shim
classes that build the equivalent :mod:`petastorm_tpu_torch` objects, and
allows no other global but data-bearing constructors. The package paths of
petastorm's ancestors (``av.*.dataset_toolkit``) are rewritten first.
"""

import io
import pickle

import pyarrow as pa

from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec, ScalarCodec)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def _safe_numpy_names():
    import numpy as np
    names = {'dtype', 'ndarray'}
    for name in dir(np):
        obj = getattr(np, name)
        if isinstance(obj, type) and issubclass(obj, np.generic):
            names.add(name)
    return names


#: exact (module -> allowed global names): a whole-module allowlist would still
#: expose e.g. builtins.eval to a crafted pickle; only data-bearing constructors
#: are permitted.
_SAFE_GLOBALS = {
    'builtins': {'object', 'tuple', 'list', 'dict', 'set', 'frozenset', 'bytearray',
                 'complex', 'bytes', 'str', 'int', 'float', 'bool'},
    '__builtin__': {'object', 'tuple', 'list', 'dict', 'set', 'frozenset', 'bytearray',
                    'complex', 'bytes', 'str', 'int', 'float', 'bool'},
    'copyreg': {'_reconstructor'},
    'copy_reg': {'_reconstructor'},
    'collections': {'OrderedDict', 'defaultdict'},
    'decimal': {'Decimal'},
    'numpy': _safe_numpy_names(),
    'numpy.core.multiarray': {'_reconstruct', 'scalar'},
    'numpy._core.multiarray': {'_reconstruct', 'scalar'},
}


class _LegacyUnischema(Unischema):
    """Reconstructs our Unischema from a pickled petastorm Unischema's state dict."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):  # state arrives via __setstate__
        if args or kwargs:
            Unischema.__init__(self, *args, **kwargs)

    def __setstate__(self, state):
        fields = [_coerce_field(f) for f in state['_fields'].values()]
        Unischema.__init__(self, state.get('_name', 'legacy'), fields)


class _LegacyFieldTuple(tuple):
    """Stand-in for the reference's UnischemaField namedtuple. Old pickles construct it
    three ways: ``copyreg._reconstructor(cls, tuple, values)`` (protocol 0 — bypasses
    ``cls.__new__``, so the instance stays a plain tuple until :func:`_coerce_field`),
    NEWOBJ with positional args (namedtuple ``__getnewargs__``), or a direct REDUCE call."""

    def __new__(cls, *args):
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            return tuple.__new__(cls, args[0])
        return tuple.__new__(cls, args)


def _coerce_field(field):
    if isinstance(field, UnischemaField):
        return field
    if isinstance(field, tuple):
        return _convert_field(*field)
    raise pickle.UnpicklingError('Unexpected legacy field representation {!r}'.format(field))


def _convert_field(name, numpy_dtype, shape, codec=None, nullable=False):
    return UnischemaField(name, numpy_dtype, tuple(shape or ()), codec=codec,
                          nullable=bool(nullable))


def _pyspark_restore(name, fields, values):
    """Shim for pyspark.serializers._restore — pyspark's namedtuple-hijack pickles
    namedtuple instances as ``_restore(class_name, field_names, values)``."""
    if name == 'UnischemaField':
        kwargs = dict(zip(fields, values))
        return _convert_field(**kwargs)
    return tuple(values)


class _LegacyScalarCodec(ScalarCodec):
    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        if args or kwargs:
            ScalarCodec.__init__(self, *args, **kwargs)

    def __setstate__(self, state):
        spark_type = (state or {}).get('_spark_type')
        ScalarCodec.__init__(self, _spark_type_to_arrow(spark_type))


class _LegacyNdarrayCodec(NdarrayCodec):
    def __setstate__(self, state):
        NdarrayCodec.__init__(self)


class _LegacyCompressedNdarrayCodec(CompressedNdarrayCodec):
    def __setstate__(self, state):
        CompressedNdarrayCodec.__init__(self)


class _LegacyCompressedImageCodec(CompressedImageCodec):
    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        if args or kwargs:
            CompressedImageCodec.__init__(self, *args, **kwargs)

    def __setstate__(self, state):
        state = state or {}
        image_codec = state.get('_image_codec', '.png').lstrip('.')
        if image_codec == 'jpg':
            image_codec = 'jpeg'
        CompressedImageCodec.__init__(self, image_codec, state.get('_quality', 80))


class _SparkTypeStub(object):
    """Placeholder standing in for a pyspark.sql.types type instance; carries the class
    name and any state (e.g. DecimalType precision/scale)."""

    type_name = None

    def __init__(self, *args, **kwargs):
        if args:
            # DecimalType(precision, scale) positional form
            self.__dict__['precision'] = args[0]
            if len(args) > 1:
                self.__dict__['scale'] = args[1]
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if state:
            self.__dict__.update(state)


_SPARK_TYPE_TO_ARROW = {
    'BooleanType': pa.bool_(),
    'ByteType': pa.int8(),
    'ShortType': pa.int16(),
    'IntegerType': pa.int32(),
    'LongType': pa.int64(),
    'FloatType': pa.float32(),
    'DoubleType': pa.float64(),
    'StringType': pa.string(),
    'BinaryType': pa.binary(),
    'TimestampType': pa.timestamp('ns'),
    'DateType': pa.date32(),
}


def _spark_type_to_arrow(stub):
    if stub is None:
        return None
    name = getattr(stub, 'type_name', type(stub).__name__)
    if name == 'DecimalType':
        precision = getattr(stub, 'precision', 10)
        scale = getattr(stub, 'scale', 0)
        return pa.decimal128(precision, scale)
    if name in _SPARK_TYPE_TO_ARROW:
        return _SPARK_TYPE_TO_ARROW[name]
    raise pickle.UnpicklingError('Unsupported legacy Spark type {!r}'.format(name))


_spark_stub_cache = {}


def _spark_type_stub_class(name):
    if name not in _spark_stub_cache:
        _spark_stub_cache[name] = type(name, (_SparkTypeStub,), {'type_name': name})
    return _spark_stub_cache[name]


_PETASTORM_SHIMS = {
    ('petastorm.unischema', 'Unischema'): _LegacyUnischema,
    ('petastorm.unischema', 'UnischemaField'): _LegacyFieldTuple,
    ('petastorm.codecs', 'ScalarCodec'): _LegacyScalarCodec,
    ('petastorm.codecs', 'NdarrayCodec'): _LegacyNdarrayCodec,
    ('petastorm.codecs', 'CompressedNdarrayCodec'): _LegacyCompressedNdarrayCodec,
    ('petastorm.codecs', 'CompressedImageCodec'): _LegacyCompressedImageCodec,
    ('pyspark.serializers', '_restore'): _pyspark_restore,
}

#: numpy 1.x scalar-type names removed in numpy 2.x, seen in old pickles
_NUMPY_RENAMES = {'string_': 'bytes_', 'unicode_': 'str_', 'int0': 'intp',
                  'uint0': 'uintp', 'float_': 'float64', 'complex_': 'complex128',
                  'object0': 'object_'}


class LegacyUnischemaUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _PETASTORM_SHIMS:
            return _PETASTORM_SHIMS[(module, name)]
        if module == 'pyspark.sql.types':
            return _spark_type_stub_class(name)
        if module.split('.')[0] == 'numpy' and name in _NUMPY_RENAMES:
            name = _NUMPY_RENAMES[name]
        allowed = _SAFE_GLOBALS.get(module, ())
        if name in allowed:
            return super().find_class(module, name)
        raise pickle.UnpicklingError('global {!r}.{!r} is forbidden in legacy unischema '
                                     'pickles'.format(module, name))


#: pre-rename package paths of petastorm's ancestors
_LEGACY_PACKAGE_NAMES = ('av.experimental.deepdrive.dataset_toolkit', 'av.ml.dataset_toolkit')
_LEGACY_MODULES = ('codecs', 'unischema', 'sequence')


def _rewrite_prehistoric_names(blob):
    for package in _LEGACY_PACKAGE_NAMES:
        for module in _LEGACY_MODULES:
            old = '\n(c{}.{}\n'.format(package, module).encode('ascii')
            new = '\n(cpetastorm.{}\n'.format(module).encode('ascii')
            blob = blob.replace(old, new)
    return blob


def depickle_legacy_unischema(blob):
    """Depickle a reference-written Unischema blob into a port :class:`Unischema`."""
    blob = _rewrite_prehistoric_names(blob)
    result = LegacyUnischemaUnpickler(io.BytesIO(blob)).load()
    if not isinstance(result, Unischema):
        raise pickle.UnpicklingError('Legacy unischema pickle did not contain a Unischema '
                                     '(got {!r})'.format(type(result)))
    return result
