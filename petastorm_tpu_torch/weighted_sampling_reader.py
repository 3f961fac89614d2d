"""Mix several readers by sampling probability: a copy of
``petastorm_tpu.weighted_sampling_reader``. Draws come from
``np.random.default_rng(seed)``, so given the same readers both packages
yield the same sequence. The mixer has no ``iter_columnar``: the loaders
read it through their batched or per-row fallback."""

import numpy as np


class WeightedSamplingReader(object):
    """On every ``next()``, draws one of the underlying readers according to normalized
    ``probabilities`` and returns its next sample. Stops when ANY underlying reader is
    exhausted (reference semantics :89-92). All readers must emit the same schema and
    batched/ngram mode (:64-77)."""

    def __init__(self, readers, probabilities, seed=None):
        if len(readers) != len(probabilities) or not readers:
            raise ValueError('readers and probabilities must be equal-length, non-empty')
        if any(p < 0 for p in probabilities):
            raise ValueError('probabilities must be non-negative')
        total = float(sum(probabilities))
        if total <= 0:
            raise ValueError('probabilities must not all be zero')
        self._readers = list(readers)
        self._cdf = np.cumsum([p / total for p in probabilities])
        self._random = np.random.default_rng(seed)

        first = readers[0]
        for other in readers[1:]:
            if getattr(other, 'is_batched_reader', False) != \
                    getattr(first, 'is_batched_reader', False):
                raise ValueError('All readers must share batched/row mode')
            if getattr(other, 'ngram', None) is not None or \
                    getattr(first, 'ngram', None) is not None:
                if getattr(other, 'ngram', None) != getattr(first, 'ngram', None):
                    raise ValueError('All readers must share the same NGram spec')
            first_fields = set(first.result_schema.fields)
            other_fields = set(other.result_schema.fields)
            if first_fields != other_fields:
                raise ValueError('All readers must emit the same fields; {} != {}'
                                 .format(sorted(first_fields), sorted(other_fields)))

    @property
    def is_batched_reader(self):
        return getattr(self._readers[0], 'is_batched_reader', False)

    @property
    def result_schema(self):
        return self._readers[0].result_schema

    @property
    def ngram(self):
        return getattr(self._readers[0], 'ngram', None)

    @property
    def last_row_consumed(self):
        return any(getattr(r, 'last_row_consumed', False) for r in self._readers)

    def reset(self):
        # Mixing stops when ANY reader exhausts, so the others are mid-stream; only the
        # exhausted ones can (and need to) restart — the rest keep their position.
        for reader in self._readers:
            if getattr(reader, 'last_row_consumed', False):
                reader.reset()

    def __iter__(self):
        return self

    def __next__(self):
        draw = self._random.random()
        index = int(np.searchsorted(self._cdf, draw, side='right'))
        index = min(index, len(self._readers) - 1)
        return next(self._readers[index])

    def stop(self):
        for reader in self._readers:
            reader.stop()

    def join(self):
        for reader in self._readers:
            reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()
