"""Row predicates pushed into the reader's workers: a copy of
``petastorm_tpu.predicates`` (same classes, arguments and results).

A predicate names the fields it needs (``get_fields``) and decides inclusion
(``do_include``). Workers read only the predicate's columns first, evaluate
it, then read the other columns for the rows that are kept. ``do_include``
receives a dict of field values: scalars for ``make_reader``'s rows, numpy
arrays for ``make_batch_reader`` (where it must return a boolean mask).
``in_pseudorandom_split`` buckets a row by the md5 of its key's ``str``, so
both packages keep the same rows.
"""

import hashlib

import numpy as np


class PredicateBase(object):
    """Row-predicate interface (reference: petastorm/predicates.py): ``get_fields``
    names the columns needed, ``do_include`` decides per row."""

    def get_fields(self):
        raise NotImplementedError()

    def do_include(self, values):
        raise NotImplementedError()


class in_set(PredicateBase):
    """True when ``values[field]`` is in the given set (reference: predicates.py:45-61)."""

    def __init__(self, inclusion_values, predicate_field):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    @property
    def inclusion_values(self):
        """The inclusion set (read-only)."""
        return frozenset(self._inclusion_values)

    @property
    def predicate_field(self):
        """Name of the field this predicate reads."""
        return self._predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        value = values[self._predicate_field]
        if isinstance(value, np.ndarray) and value.ndim > 0:
            return np.isin(value, list(self._inclusion_values))
        return value in self._inclusion_values


class in_intersection(PredicateBase):
    """True when any element of a list-valued field intersects the given values
    (reference: predicates.py:64-80).

    Row mode gets one row's sequence and returns a scalar; batch mode
    (``make_batch_reader``) gets the whole column — an object array of per-row
    sequences, or a 2-D array when row lengths are uniform — and returns an ``(n,)``
    mask."""

    def __init__(self, inclusion_values, predicate_field):
        self._inclusion_values = set(inclusion_values)
        self._predicate_field = predicate_field

    def get_fields(self):
        return {self._predicate_field}

    def do_include(self, values):
        value = values[self._predicate_field]
        if isinstance(value, np.ndarray) and (value.ndim >= 2 or value.dtype == object):
            intersects = self._inclusion_values.intersection
            return np.fromiter((bool(intersects(np.ravel(row))) for row in value),
                               dtype=bool, count=len(value))
        return bool(self._inclusion_values.intersection(value))


class in_lambda(PredicateBase):
    """Arbitrary user function over the named fields, with optional shared state
    (reference: predicates.py:83-107)."""

    def __init__(self, predicate_fields, predicate_func, state_arg=None):
        if not isinstance(predicate_fields, (list, tuple, set)):
            raise ValueError('predicate_fields must be a collection of field names')
        self._predicate_fields = list(predicate_fields)
        self._predicate_func = predicate_func
        self._state_arg = state_arg

    def get_fields(self):
        return set(self._predicate_fields)

    def do_include(self, values):
        args = [values[f] for f in self._predicate_fields]
        if self._state_arg is not None:
            return self._predicate_func(*args, self._state_arg)
        return self._predicate_func(*args)


class in_negate(PredicateBase):
    """Logical NOT of another predicate (reference: predicates.py:110-122)."""

    def __init__(self, predicate):
        self._predicate = predicate

    @property
    def predicate(self):
        """The negated inner predicate (read-only; the vectorized mask introspects it)."""
        return self._predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        result = self._predicate.do_include(values)
        if isinstance(result, np.ndarray):
            return ~result
        return not result


class in_reduce(PredicateBase):
    """Reduce several predicates with ``any``/``all``-style function, e.g.
    ``in_reduce([p1, p2], all)`` (reference: predicates.py:125-142). For batch (mask)
    results, ``numpy.logical_and.reduce``/``logical_or.reduce`` are applied when the
    reduction function is ``all``/``any``."""

    def __init__(self, predicate_list, reduce_func):
        self._predicate_list = list(predicate_list)
        self._reduce_func = reduce_func

    @property
    def predicates(self):
        """The reduced child predicates (read-only; the vectorized mask introspects them)."""
        return tuple(self._predicate_list)

    @property
    def reduce_func(self):
        """The reduction function (``all``/``any`` evaluate vectorized)."""
        return self._reduce_func

    def get_fields(self):
        fields = set()
        for predicate in self._predicate_list:
            fields |= predicate.get_fields()
        return fields

    def do_include(self, values):
        results = [p.do_include(values) for p in self._predicate_list]
        if any(isinstance(r, np.ndarray) for r in results):
            results = [np.asarray(r) for r in results]
            if self._reduce_func is all:
                return np.logical_and.reduce(results)
            if self._reduce_func is any:
                return np.logical_or.reduce(results)
        return self._reduce_func(results)


class in_pseudorandom_split(PredicateBase):
    """Deterministic hash-bucket split of a dataset on a key field: ``fraction_list``
    partitions [0,1); rows land in a bucket by md5 of the key; the predicate keeps rows in
    bucket ``subset_index`` (reference: predicates.py:145-183). Stable across runs and
    machines — suitable for train/val/test splits."""

    def __init__(self, fraction_list, subset_index, predicate_field):
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError('subset_index out of range')
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError('fractions must sum to <= 1.0')
        self._boundaries = np.cumsum([0.0] + list(fraction_list))
        self._subset_index = subset_index
        self._predicate_field = predicate_field

    @property
    def predicate_field(self):
        """Name of the hash-bucketed key field."""
        return self._predicate_field

    def get_fields(self):
        return {self._predicate_field}

    @staticmethod
    def _bucket_position(value):
        digest = hashlib.md5(str(value).encode('utf-8')).hexdigest()
        return int(digest[:8], 16) / float(0xFFFFFFFF + 1)

    def do_include(self, values):
        value = values[self._predicate_field]
        lo = self._boundaries[self._subset_index]
        hi = self._boundaries[self._subset_index + 1]
        if isinstance(value, np.ndarray) and value.ndim > 0:
            positions = np.array([self._bucket_position(v) for v in value])
            return (positions >= lo) & (positions < hi)
        position = self._bucket_position(value)
        return lo <= position < hi
