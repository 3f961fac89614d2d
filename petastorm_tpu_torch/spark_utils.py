"""Spark adapters: a copy of ``petastorm_tpu.spark_utils`` (which follows
petastorm/spark_utils.py and the reference's ``dict_to_spark_row``). pyspark
is imported inside the functions; the rest of the package needs no Spark.

Write path with Spark: codec-encode rows with :func:`dict_to_spark_row`, write
the DataFrame as Parquet, then attach the metadata with
:func:`~petastorm_tpu_torch.etl.dataset_metadata.materialize_dataset`; or
skip Spark: :func:`~petastorm_tpu_torch.etl.dataset_metadata.write_rows` is
the pure-Arrow writer."""


def dict_to_spark_row(schema, row_dict):
    """Validate and codec-encode one row dict and build a ``pyspark.sql.Row``
    with the schema's field order. The encoding is
    :func:`~petastorm_tpu_torch.unischema.dict_to_encoded_row`, the Arrow
    writer's, so the two writers cannot diverge."""
    try:
        from pyspark.sql import Row
    except ImportError:
        raise ImportError('dict_to_spark_row requires pyspark, which is not installed; '
                          'use petastorm_tpu_torch.etl.dataset_metadata.write_rows instead')
    from petastorm_tpu_torch.unischema import dict_to_encoded_row
    encoded = dict_to_encoded_row(schema, row_dict)
    # Row(**kwargs) sorts its fields on some pyspark versions: an ordered Row
    # class keeps the schema's order
    row_cls = Row(*schema.fields.keys())
    return row_cls(*[encoded[name] for name in schema.fields])


def dataset_as_rdd(dataset_url, spark_session, schema_fields=None, storage_options=None):
    """The store at ``dataset_url`` as a Spark RDD of decoded namedtuples
    (``schema_fields`` selects fields by name or regex)."""
    try:
        import pyspark  # noqa: F401
    except ImportError:
        raise ImportError('dataset_as_rdd requires pyspark, which is not installed; '
                          'use make_reader / make_batch_reader instead')
    from petastorm_tpu_torch.etl import dataset_metadata
    from petastorm_tpu_torch.unischema import decode_row

    schema = dataset_metadata.get_schema_from_dataset_url(
        dataset_url, storage_options=storage_options)
    view = schema.create_schema_view(schema_fields) if schema_fields else schema
    dataframe = spark_session.read.parquet(dataset_url).select(*list(view.fields))

    def _to_namedtuple(record):
        return view.make_namedtuple(**decode_row(record.asDict(), view))

    return dataframe.rdd.map(_to_namedtuple)
