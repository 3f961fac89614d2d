"""TensorFlow adapters over the port's readers: a copy of
``petastorm_tpu.tf_utils`` (which follows petastorm/tf_utils.py). TensorFlow
has no path to the card here; the torch loaders
(:mod:`petastorm_tpu_torch.parallel`) are the device path. tensorflow is
imported inside the functions, so the package imports without it; the graph
op names are the JAX package's.

``make_petastorm_dataset(reader)`` — ``tf.data.Dataset`` over a reader (row, batch, or
NGram), the reference's tf_utils.py:336-405. ``tf_tensors(reader)`` — legacy graph-mode
tensors via ``tf.compat.v1.py_func`` (:269-318).
"""

import datetime
import logging
from decimal import Decimal

import numpy as np

logger = logging.getLogger(__name__)

# Well-known graph op name carrying the shuffling queue's current size — monitoring
# code fetches it with graph.get_tensor_by_name(RANDOM_SHUFFLING_QUEUE_SIZE + ':0')
# (reference: tf_utils.py:45-47, same name for drop-in diagnostics compatibility).
RANDOM_SHUFFLING_QUEUE_SIZE = 'random_shuffling_queue_size'

# numpy -> tf dtype sanitization map (reference: tf_utils.py:27-96): TF has no uint16/32
# kernels for most ops and no Decimal/datetime; strings pass through as tf.string.
_PROMOTIONS = {
    'uint16': np.int32,
    'uint32': np.int64,
    'int8': np.int8,
    'bool': np.bool_,
}


def _sanitize_field_value(value):
    if isinstance(value, Decimal):
        return str(value)
    if isinstance(value, (datetime.date, datetime.datetime, np.datetime64)):
        return np.datetime64(value).astype('datetime64[ns]').astype(np.int64)
    if isinstance(value, np.ndarray):
        if value.dtype == np.uint16:
            return value.astype(np.int32)
        if value.dtype == np.uint32:
            return value.astype(np.int64)
        if value.dtype.kind == 'M':
            return value.astype('datetime64[ns]').astype(np.int64)
    if isinstance(value, np.uint16):
        return np.int32(value)
    if isinstance(value, np.uint32):
        return np.int64(value)
    return value


def _tf_dtype_for_field(field):
    """TF dtype render of a Unischema field (reference: tf_utils.py:27-43)."""
    import tensorflow as tf
    if field.numpy_dtype is Decimal:
        return tf.string
    dtype = np.dtype(field.numpy_dtype)
    if dtype.kind in ('U', 'S', 'O'):
        return tf.string
    if dtype == np.uint16:
        return tf.int32
    if dtype == np.uint32:
        return tf.int64
    if dtype.kind == 'M':
        return tf.int64
    return tf.as_dtype(dtype)


def _output_signature(schema, batched):
    """Namedtuple-of-TensorSpecs so dataset elements support ``row.field`` access and
    keep a stable nest type across generator re-creation (reference's cached-namedtuple
    contract for tf.data type equality: unischema.py:88-111)."""
    import tensorflow as tf
    signature = {}
    for name, field in schema.fields.items():
        shape = tuple(field.shape)
        if batched:
            shape = (None,) + shape
        tf_shape = tf.TensorShape([None if d is None else d for d in shape])
        signature[name] = tf.TensorSpec(shape=tf_shape, dtype=_tf_dtype_for_field(field))
    return schema.namedtuple(**signature)


def make_petastorm_dataset(reader):
    """``tf.data.Dataset`` over a reader (reference: tf_utils.py:336-405). Row readers
    yield dicts of scalars/tensors; batch readers yield dicts of batched tensors; NGram
    readers yield {offset: dict} nested structures. Re-creating the generator after full
    consumption resets the reader (reference :328-333,371-394)."""
    import tensorflow as tf

    ngram = getattr(reader, 'ngram', None)
    batched = getattr(reader, 'is_batched_reader', False)

    if ngram is not None:
        signature = {offset: _output_signature(
            ngram.get_schema_at_timestep(reader.result_schema, offset), False)
            for offset in ngram.fields}
        # tf.nest matches namedtuples by type name + fields: re-wrap worker rows into the
        # exact classes used in the signature.
        step_types = {offset: type(spec) for offset, spec in signature.items()}
    else:
        signature = _output_signature(reader.result_schema, batched)
        row_type = type(signature)

    def generator():
        if getattr(reader, 'last_row_consumed', False):
            logger.warning('Dataset generator re-created after consumption: resetting '
                           'the reader (reference: tf_utils.py:328-333)')
            reader.reset()
        for item in reader:
            if ngram is not None:
                yield {offset: step_types[offset](
                    **{k: _sanitize_field_value(v) for k, v in step._asdict().items()})
                    for offset, step in item.items()}
            else:
                yield row_type(**{k: _sanitize_field_value(v)
                                  for k, v in item._asdict().items()})

    return tf.data.Dataset.from_generator(generator, output_signature=signature)


def tf_tensors(reader, shuffling_queue_capacity=0, min_after_dequeue=0):
    """Legacy graph-mode tensors (reference: tf_utils.py:269-318): a ``py_func`` wrapping
    ``next(reader)``, optionally through a ``RandomShuffleQueue``. Returns a namedtuple
    of tensors, or ``{offset: namedtuple}`` for NGram readers (the window is flattened
    to one tuple through the graph boundary and unflattened after — reference:
    tf_utils.py:107-120,254-266,408-438)."""
    if getattr(reader, 'is_batched_reader', False) and shuffling_queue_capacity > 0:
        raise ValueError('Shuffling queue is not supported with batched readers '
                         '(reference: tf_utils.py:307-311)')
    if getattr(reader, 'ngram', None) is not None:
        return _tf_tensors_ngram(reader, shuffling_queue_capacity, min_after_dequeue)

    schema = reader.result_schema
    field_names = list(schema.fields)
    fields = [schema.fields[n] for n in field_names]

    def _next_sample():
        row = next(reader)
        return [np.asarray(_sanitize_field_value(v)) for v in row]

    values = _flat_graph_values(_next_sample, fields, shuffling_queue_capacity,
                                min_after_dequeue, op_name='petastorm_tpu_next_sample')
    return schema.namedtuple(**dict(zip(field_names, values)))


def _tf_tensors_ngram(reader, shuffling_queue_capacity, min_after_dequeue):
    """NGram variant: flatten ``{offset: namedtuple}`` into one flat tensor tuple across
    the py_func/queue boundary, rebuild the per-offset namedtuples after (reference:
    tf_utils.py:107-120,140-182,408-438)."""
    ngram = reader.ngram
    schema = reader.result_schema
    # The emission plan IS the flattening order: (offset, row_position, names, cls) per
    # timestep, exactly matching what the reader's window reader emits.
    plan = ngram.window_plan(schema.fields)
    flat_fields = [schema.fields[name] for _, _, names, _ in plan for name in names]

    def _next_window():
        window = next(reader)
        out = []
        for key, _, names, _ in plan:
            step = window[key]
            for name in names:
                out.append(np.asarray(_sanitize_field_value(getattr(step, name))))
        return out

    values = _flat_graph_values(_next_window, flat_fields, shuffling_queue_capacity,
                                min_after_dequeue, op_name='petastorm_tpu_next_window')
    result = {}
    index = 0
    for key, _, names, cls in plan:
        result[key] = cls._make(values[index:index + len(names)])
        index += len(names)
    return result


def _flat_graph_values(next_fn, fields, shuffling_queue_capacity, min_after_dequeue,
                       op_name):
    """py_func over ``next_fn`` -> optional RandomShuffleQueue -> list of tensors with
    static shapes assigned from ``fields`` (reference: tf_utils.py:185-219)."""
    import tensorflow as tf

    dtypes = [_tf_dtype_for_field(field) for field in fields]

    def _set_shapes(values):
        for value, field in zip(values, fields):
            if not any(d is None for d in field.shape):
                value.set_shape(field.shape)

    values = tf.compat.v1.py_func(next_fn, [], dtypes, name=op_name)
    _set_shapes(values)

    if shuffling_queue_capacity > 0:
        queue = tf.queue.RandomShuffleQueue(shuffling_queue_capacity, min_after_dequeue,
                                            dtypes,
                                            name='petastorm_tpu_shuffling_queue')
        enqueue = queue.enqueue(values)
        runner = tf.compat.v1.train.QueueRunner(queue, [enqueue])
        tf.compat.v1.train.add_queue_runner(runner)
        # Well-known op name so queue depth is observable (reference: tf_utils.py:45-47).
        tf.identity(queue.size(), name=RANDOM_SHUFFLING_QUEUE_SIZE)
        values = queue.dequeue()
        if len(fields) == 1:
            # dequeue() returns a lone Tensor (not a list) for single-component queues.
            values = [values]
        _set_shapes(values)

    return list(values)
