"""Copy a store, optionally a subset of its fields and only the rows where
given fields are not null, into a new store with fresh metadata: the
counterpart of ``petastorm_tpu.tools.copy_dataset``. CLI::

    python -m petastorm_tpu_torch.tools.copy_dataset <source_url> <target_url> [options]
"""

import argparse
import logging
import sys

import pyarrow.compute as pc
import pyarrow.dataset as pads
import pyarrow.fs as pa_fs

from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs_utils import (delete_path, get_filesystem_and_path_or_paths,
                                          path_exists)
from petastorm_tpu_torch.unischema import match_unischema_fields

logger = logging.getLogger(__name__)


def copy_dataset(source_url, target_url, field_regex=None, not_null_fields=None,
                 rowgroup_size_mb=32, rows_per_file=None, storage_options=None,
                 overwrite=False):
    """Copy the store at ``source_url`` (written by either package or by the
    reference petastorm) to ``target_url``: only the fields matching
    ``field_regex`` (a list of regexes) when given, only the rows whose
    ``not_null_fields`` are all set. A non-empty target is refused unless
    ``overwrite``, which deletes it first. ``storage_options`` go to the
    fsspec filesystems of remote URLs. Returns the rows written."""
    source = dataset_metadata.open_dataset(source_url, storage_options=storage_options)
    schema = dataset_metadata.infer_or_load_unischema(source)
    if field_regex:
        fields = match_unischema_fields(schema, field_regex)
        if not fields:
            raise ValueError('field_regex {} matched no fields of {}'
                             .format(field_regex, list(schema.fields)))
        schema = schema.create_schema_view(fields)
    column_names = list(schema.fields)

    filter_expr = None
    for field_name in (not_null_fields or []):
        expr = ~pc.field(field_name).is_null()
        filter_expr = expr if filter_expr is None else (filter_expr & expr)

    target_fs, target_path = get_filesystem_and_path_or_paths(
        target_url, storage_options=storage_options)
    if path_exists(target_fs, target_path):
        infos = target_fs.get_file_info(pa_fs.FileSelector(target_path,
                                                           allow_not_found=True))
        if infos and not overwrite:
            raise ValueError('Target {} exists and is not empty; pass '
                             'overwrite=True (--overwrite) to replace it'
                             .format(target_url))
        if infos:
            delete_path(target_fs, target_path)

    with dataset_metadata.materialize_dataset(target_url, schema,
                                              storage_options=storage_options):
        target_fs.create_dir(target_path, recursive=True)
        scanner = pads.Scanner.from_dataset(source.arrow_dataset, columns=column_names,
                                            filter=filter_expr)
        # batches stream into files: the source is never whole in memory
        total_rows = dataset_metadata.write_table_files(
            target_fs, target_path, scanner.projected_schema, scanner.to_batches(),
            rowgroup_size_mb=rowgroup_size_mb, rows_per_file=rows_per_file)
    logger.info('Copied %d rows to %s', total_rows, target_url)
    return total_rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('source_url')
    parser.add_argument('target_url')
    parser.add_argument('--field-regex', nargs='+')
    parser.add_argument('--not-null-fields', nargs='+')
    parser.add_argument('--rowgroup-size-mb', type=int, default=32)
    parser.add_argument('--rows-per-file', type=int)
    parser.add_argument('--overwrite', action='store_true',
                        help='replace a non-empty target instead of refusing')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    copy_dataset(args.source_url, args.target_url, field_regex=args.field_regex,
                 not_null_fields=args.not_null_fields,
                 rowgroup_size_mb=args.rowgroup_size_mb,
                 rows_per_file=args.rows_per_file, overwrite=args.overwrite)
    return 0


if __name__ == '__main__':
    sys.exit(main())
