"""The one generator of the benchmark's data, driven by a workload's ``data``
block. Two kinds:

- ``image_store``: an ImageNet-shaped petastorm store. ``distinct_images``
  synthetic photographs (coarse noise upsampled in ``photo_cell`` square
  cells, plus normal texture of ``photo_texture`` steps of 255), each
  encoded once in the DCT image format at ``quality``; row
  ``i`` carries photo ``i % distinct_images`` (so a rowgroup of fewer rows
  never holds a photo twice), a label and a float32 embedding of its own,
  the embedding as a one-member zip stored at deflate level 0 (the form the
  card inflates). ``files`` zstd files of ``rowgroup_mb`` rowgroups. Its
  content comes from ``store_seed``, not from the run's seed, so it is
  written once into the checkout's cache and read by every later run; the
  run's seed draws the order, the crops, the flips and the weights.
- ``token_documents``: a plain Parquet store (``doc_id`` int64, ``tokens``
  ``list<int32>``) of documents drawn from the run's seed: lengths
  log-normal with ``median`` and ``sigma``, rounded and clipped to ``[min,
  max]``, until ``total_tokens``; ids uniform in ``[0, vocab)``;
  ``docs_per_rowgroup`` documents a rowgroup, in one file. Written anew into
  the checkout's cache on every run (tens of megabytes).
"""

import hashlib
import io
import json
import os
import shutil
import zipfile

import numpy as np

from portbench.reference import dct

EMBED_NPY_MEMBER = 'arr.npy'


def sub_seed(seed, tag):
    """A 32-bit seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256('{}:{}'.format(int(seed), tag).encode()).digest()
    return int.from_bytes(digest[:4], 'little')


def synthetic_photo(rng, hw, cell, texture):
    coarse = rng.integers(0, 255, (hw // cell, hw // cell, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((cell, cell, 1), dtype=np.float32))
    noise = rng.standard_normal((hw, hw, 3), dtype=np.float32) * texture
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def stored_npz(array):
    """``array`` as ``np.savez`` would hold it, its member deflated at level 0."""
    npy = io.BytesIO()
    np.save(npy, array)
    out = io.BytesIO()
    with zipfile.ZipFile(out, 'w', zipfile.ZIP_DEFLATED, compresslevel=0) as archive:
        archive.writestr(EMBED_NPY_MEMBER, npy.getvalue())
    return out.getvalue()


class ImageStore(object):
    """The rows of an ``image_store`` and where they are written."""

    def __init__(self, spec, cache_root):
        self.spec = spec
        self.rows = int(spec['rows'])
        self.quality = int(spec['quality'])
        self.hw = int(spec['image_hw'])
        rng = np.random.default_rng([int(spec['store_seed']), 0])
        self.blobs = [dct.encode_blob(synthetic_photo(rng, self.hw, int(spec['photo_cell']),
                                                      float(spec['photo_texture'])),
                                      self.quality)
                      for _ in range(int(spec['distinct_images']))]
        self.labels = np.random.default_rng([int(spec['store_seed']), 1]).integers(
            0, int(spec['classes']), self.rows)
        key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
        self.path = os.path.join(cache_root, 'image_store-' + key)
        self.url = 'file://' + self.path

    def embedding(self, idx):
        return np.random.default_rng([int(self.spec['store_seed']), 2, int(idx)]) \
            .standard_normal(int(self.spec['embedding_len']), dtype=np.float32)

    def blob(self, idx):
        return self.blobs[int(idx) % len(self.blobs)]

    def write(self):
        """Write the store unless the cache holds it; returns True when written."""
        if os.path.exists(os.path.join(self.path, '_common_metadata')):
            return False
        import pyarrow as pa
        import pyarrow.fs as pafs
        from petastorm_tpu_torch.codecs import CompressedNdarrayCodec, DctImageCodec, ScalarCodec
        from petastorm_tpu_torch.etl.dataset_metadata import (materialize_dataset,
                                                              write_table_files)
        from petastorm_tpu_torch.unischema import Unischema, UnischemaField
        hw, embed = self.hw, int(self.spec['embedding_len'])
        schema = Unischema('PortbenchImages', [
            UnischemaField('idx', np.int64, (), ScalarCodec(), False),
            UnischemaField('label', np.int64, (), ScalarCodec(), False),
            UnischemaField('image', np.uint8, (hw, hw, 3), DctImageCodec(quality=self.quality),
                           False),
            UnischemaField('embedding', np.float32, (embed,),
                           CompressedNdarrayCodec(stored=True), False)])
        table = pa.table({
            'idx': pa.array(np.arange(self.rows, dtype=np.int64)),
            'label': pa.array(self.labels.astype(np.int64)),
            'image': pa.array([self.blob(i) for i in range(self.rows)], type=pa.binary()),
            'embedding': pa.array([stored_npz(self.embedding(i)) for i in range(self.rows)],
                                  type=pa.binary()),
        }, schema=schema.as_arrow_schema())
        tmp = self.path + '.tmp'
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(tmp)
        with materialize_dataset('file://' + tmp, schema):
            write_table_files(pafs.LocalFileSystem(), tmp, table.schema, table.to_batches(),
                              rowgroup_size_mb=int(self.spec['rowgroup_mb']),
                              rows_per_file=-(-self.rows // int(self.spec['files'])),
                              compression=self.spec['compression'])
        os.replace(tmp, self.path)
        return True


def document_lengths(rng, spec):
    mean_guess = float(spec['median']) * np.exp(float(spec['sigma']) ** 2 / 2)
    total = int(spec['total_tokens'])
    lengths = np.zeros(0, dtype=np.int64)
    while lengths.sum() < total:
        more = rng.lognormal(np.log(float(spec['median'])), float(spec['sigma']),
                             int(total / mean_guess * 1.2) + 16)
        more = np.clip(np.round(more), int(spec['min']), int(spec['max'])).astype(np.int64)
        lengths = np.concatenate([lengths, more])
    return lengths[:int(np.searchsorted(np.cumsum(lengths), total)) + 1]


class DocumentStore(object):
    """The documents of a ``token_documents`` store, drawn from ``seed``."""

    def __init__(self, spec, seed, cache_root, name):
        self.spec = spec
        rng = np.random.default_rng([int(seed), 3])
        lengths = document_lengths(rng, spec)
        tokens = rng.integers(0, int(spec['vocab']), int(lengths.sum()), dtype=np.int32)
        self.documents = np.split(tokens, np.cumsum(lengths)[:-1])
        self.path = os.path.join(cache_root, 'token_documents-' + name)
        self.url = 'file://' + self.path

    def write(self):
        import pyarrow as pa
        import pyarrow.parquet as pq
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(self.path)
        schema = pa.schema([pa.field('doc_id', pa.int64(), nullable=False),
                            pa.field('tokens', pa.list_(pa.int32()), nullable=False)])
        per_group = int(self.spec['docs_per_rowgroup'])
        with pq.ParquetWriter(os.path.join(self.path, 'part_00000.parquet'), schema) as writer:
            for start in range(0, len(self.documents), per_group):
                docs = self.documents[start:start + per_group]
                writer.write_table(pa.table(
                    {'doc_id': pa.array(np.arange(start, start + len(docs)), pa.int64()),
                     'tokens': pa.array(docs, pa.list_(pa.int32()))}, schema=schema),
                    row_group_size=len(docs))
        return True


def make(spec, seed, cache_root, name):
    """The data of a workload's ``data`` block, its store written."""
    if spec['kind'] == 'image_store':
        data = ImageStore(spec, cache_root)
    elif spec['kind'] == 'token_documents':
        data = DocumentStore(spec, seed, cache_root, name)
    else:
        raise ValueError('unknown data kind {!r}'.format(spec['kind']))
    data.written = data.write()
    return data
