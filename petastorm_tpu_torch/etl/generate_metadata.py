"""(Re)write the petastorm metadata of an existing Parquet store: the
counterpart of ``petastorm_tpu.etl.generate_metadata``. CLI::

    python -m petastorm_tpu_torch.etl.generate_metadata <dataset_url> [--unischema-class path]
"""

import argparse
import logging
import sys
from pydoc import locate

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.unischema import Unischema

logger = logging.getLogger(__name__)


def generate_metadata(dataset_url, unischema_class=None, storage_options=None):
    """(Re)write ``_common_metadata`` of the store at ``dataset_url``. The
    schema is, in order: ``unischema_class`` (a dotted path to a port
    :class:`Unischema` instance), the schema already embedded (a reference
    petastorm pickle among them, which is then also written as JSON), or one
    inferred from the Arrow schema. ``storage_options`` go to the fsspec
    filesystem of a remote URL. Returns the schema."""
    if unischema_class:
        schema = locate(unischema_class)
        if schema is None or not isinstance(schema, Unischema):
            raise ValueError('{} does not resolve to a petastorm_tpu_torch Unischema '
                             'instance'.format(unischema_class))
    else:
        handle = dataset_metadata.open_dataset(dataset_url,
                                               storage_options=storage_options)
        schema = dataset_metadata.infer_or_load_unischema(handle)
        logger.info('Using %s schema: %s',
                    'embedded' if _has_embedded(handle) else 'inferred', schema.name)
    with dataset_metadata.materialize_dataset(dataset_url, schema,
                                              storage_options=storage_options):
        pass   # the files exist; leaving the context writes the metadata
    return schema


def _has_embedded(handle):
    try:
        dataset_metadata.get_schema(handle)
        return True
    except MetadataError:
        return False


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('dataset_url')
    parser.add_argument('--unischema-class',
                        help='dotted path to a petastorm_tpu_torch Unischema instance, '
                             'e.g. examples.mnist.torch_example.MnistSchema')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    generate_metadata(args.dataset_url, args.unischema_class)
    return 0


if __name__ == '__main__':
    sys.exit(main())
