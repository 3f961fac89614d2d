"""argparse plumbing for tools that optionally run against a Spark cluster:
a copy of ``petastorm_tpu.tools.spark_session_cli`` (which follows
petastorm/tools/spark_session_cli.py: ``--master`` and
``--spark-session-config k=v`` flags feeding a SparkSession builder).

The port's own tools are Arrow-native and do not need Spark, but users
migrating Spark-driven ETL jobs can reuse this helper to keep their CLI
contracts. Importing this module is safe without pyspark; only
:func:`configure_spark` requires it.
"""

import argparse


def _config_pair(pair):
    key, sep, value = pair.partition('=')
    if not sep or not key:
        raise argparse.ArgumentTypeError(
            'spark-session-config entries must be KEY=VALUE, got {!r}'.format(pair))
    return key, value


def add_configure_spark_arguments(parser):
    """Add ``--master`` and ``--spark-session-config`` arguments to ``parser``."""
    group = parser.add_argument_group('spark')
    group.add_argument('--master', type=str, default=None,
                       help='Spark master URL (e.g. local[4]). Default: whatever '
                            'the environment provides.')
    group.add_argument('--spark-session-config', type=_config_pair, nargs='+', default=[],
                       metavar='KEY=VALUE',
                       help='Extra SparkSession config entries, each KEY=VALUE.')
    return parser


def _parse_config_pairs(pairs):
    return dict(_config_pair(p) if isinstance(p, str) else p for p in pairs)


def configure_spark(builder_or_args, args=None):
    """Apply parsed CLI args to a ``SparkSession.Builder`` and return it.

    Can be called either as ``configure_spark(args)`` (a builder is created) or
    ``configure_spark(builder, args)`` (reference signature shape). Requires
    pyspark for the one-argument form.
    """
    if args is None:
        args = builder_or_args
        if hasattr(args, 'config') and hasattr(args, 'getOrCreate'):
            raise TypeError('configure_spark(builder) needs the parsed CLI args too: '
                            'call configure_spark(builder, args)')
        try:
            from pyspark.sql import SparkSession
        except ImportError:
            raise ImportError('configure_spark requires pyspark, which is not '
                              'installed; pip install pyspark')
        builder = SparkSession.builder
    else:
        builder = builder_or_args
    master = getattr(args, 'master', None)
    if isinstance(master, str) and master:
        builder = builder.master(master)
    for key, value in _parse_config_pairs(getattr(args, 'spark_session_config', [])).items():
        builder = builder.config(key, value)
    return builder
