"""Print a store's schema and rowgroup indexes: the counterpart of
``petastorm_tpu.etl.metadata_util``. CLI::

    python -m petastorm_tpu_torch.etl.metadata_util <dataset_url> [--print-values]
"""

import argparse
import sys

from petastorm_tpu_torch.etl import dataset_metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('dataset_url')
    parser.add_argument('--skip-schema', action='store_true')
    parser.add_argument('--print-values', action='store_true',
                        help='print every indexed value of every rowgroup index')
    args = parser.parse_args(argv)

    handle = dataset_metadata.open_dataset(args.dataset_url)
    if not args.skip_schema:
        print(dataset_metadata.infer_or_load_unischema(handle))
        row_groups = dataset_metadata.load_row_groups(handle)
        print('{} rowgroups, {} rows'.format(
            len(row_groups), sum(rg.row_group_num_rows for rg in row_groups)))
    try:
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
        indexes = get_row_group_indexes(handle)
        for name, indexer in indexes.items():
            print('index {!r} over {}: {} values'.format(name, indexer.column_names,
                                                         len(indexer.indexed_values)))
            if args.print_values:
                for value in indexer.indexed_values:
                    print('  {!r} -> rowgroups {}'.format(
                        value, sorted(indexer.get_row_group_indexes(value))))
    except ValueError:
        print('(no rowgroup indexes)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
