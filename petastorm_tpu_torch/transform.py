"""Worker-side transforms with schema mutation: a copy of
``petastorm_tpu.transform`` (same arguments, same refusals, same result
schema).

A :class:`TransformSpec` carries a function that a reader worker applies to
each rowgroup, and a declaration of how the output schema differs from the
input schema (edited, removed or selected fields).

Defined difference: the port's ``make_batch_reader`` honours ``batched=True``
(``func`` takes and returns a dict of columns, no pandas needed), where the
JAX package's ignores it and always hands ``func`` a pandas ``DataFrame``.
With ``batched=False`` both hand the batch reader's ``func`` a ``DataFrame``.
"""

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec(object):
    """Specification of a worker-side transform.

    :param func: callable applied on the worker, per ``batched`` and the
        reader: ``make_reader`` calls it on one row dict at a time, or with
        ``batched=True`` on the rowgroup's ``{field: ndarray-or-list}`` columns
        dict (returning such a dict); ``make_batch_reader`` calls it on a
        pandas ``DataFrame``, or with ``batched=True`` on the columns dict.
        May be None when only field selection or removal is wanted.
    :param edit_fields: 4-tuples ``(name, numpy_dtype, shape, nullable)`` or
        :class:`UnischemaField` s describing fields added or changed by ``func``.
    :param removed_fields: names of fields the transform deletes. Mutually
        exclusive with ``selected_fields``.
    :param selected_fields: ordered names of the fields to keep (the output
        column order).
    :param batched: ``func`` takes and returns whole columns (see ``func``).
        A ``func=None`` spec never materializes rows, ``batched`` or not.
    """

    def __init__(self, func=None, edit_fields=None, removed_fields=None, selected_fields=None,
                 batched=False):
        if removed_fields and selected_fields:
            raise ValueError('removed_fields and selected_fields are mutually exclusive '
                             '(reference semantics: petastorm/transform.py:49-52)')
        self.func = func
        self.edit_fields = edit_fields or []
        self.removed_fields = removed_fields or []
        self.selected_fields = selected_fields
        self.batched = bool(batched)


def transform_schema(schema, transform_spec):
    """The schema after ``transform_spec``: edited fields replace their
    namesakes in place, new ones append in edit order, removed ones go, and
    ``selected_fields`` picks and orders the rest."""
    edited = {}
    for edit in transform_spec.edit_fields:
        if isinstance(edit, UnischemaField):
            field = edit
        else:
            name, numpy_dtype, shape, nullable = edit
            field = UnischemaField(name, numpy_dtype, shape, codec=None, nullable=nullable)
        edited[field.name] = field

    removed = set(transform_spec.removed_fields)
    unknown_removed = removed - set(schema.fields) - set(edited)
    if unknown_removed:
        raise ValueError('removed_fields {} not present in schema {!r}'
                         .format(sorted(unknown_removed), schema.name))

    fields = {}
    for name, field in schema.fields.items():
        if name in removed:
            continue
        fields[name] = edited.pop(name, field)
    for name, field in edited.items():
        if name not in removed:
            fields[name] = field

    if transform_spec.selected_fields is not None:
        unknown_selected = set(transform_spec.selected_fields) - set(fields)
        if unknown_selected:
            raise ValueError('selected_fields {} not present in transformed schema'
                             .format(sorted(unknown_selected)))
        fields = {name: fields[name] for name in transform_spec.selected_fields}

    return Unischema('{}_transformed'.format(schema.name), list(fields.values()))
