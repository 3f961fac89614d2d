"""Generate a plain (non-petastorm) Parquet store with pyarrow: the twin of
``generate_external_dataset.py`` with ``petastorm_tpu_torch``'s filesystem
helper. ``make_batch_reader`` reads any Parquet store, with no Unischema.

Run: ``python -m examples.hello_world.external_dataset.torch_generate_external_dataset
-o file:///tmp/external_dataset``
"""

import argparse

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths


def generate_external_dataset(output_url='file:///tmp/external_dataset', rows_count=100):
    fs, path = get_filesystem_and_path_or_paths(output_url)
    fs.create_dir(path, recursive=True)
    ids = np.arange(rows_count, dtype=np.int64)
    table = pa.table({
        'id': ids,
        'value1': np.sin(ids.astype(np.float64)),
        'value2': ids * 2,
    })
    with fs.open_output_stream(path + '/data_0.parquet') as sink:
        pq.write_table(table, sink, row_group_size=max(1, rows_count // 4))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-o', '--output-url', default='file:///tmp/external_dataset')
    parser.add_argument('-n', '--rows-count', type=int, default=100)
    args = parser.parse_args(argv)
    generate_external_dataset(args.output_url, args.rows_count)
    print('wrote {} rows to {}'.format(args.rows_count, args.output_url))


if __name__ == '__main__':
    main()
