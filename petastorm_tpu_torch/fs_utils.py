"""Filesystem resolution: dataset URL -> (pyarrow filesystem, path). A copy of
``petastorm_tpu.fs_utils``.

Every URL funnels into the ``pyarrow.fs`` API: local paths and ``file://``
map to ``LocalFileSystem``, ``hdfs://`` to ``HadoopFileSystem`` through the
namenode resolver of :mod:`~petastorm_tpu_torch.hdfs.namenode` (an HA
nameservice to a failover proxy), and every other scheme (s3, gs, abfs,
``memory``, ``local``, ...) to an fsspec filesystem built with
``storage_options`` and wrapped in ``PyFileSystem(FSSpecHandler)`` so Arrow's
C++ readers consume it. Worker processes receive a picklable
:class:`FilesystemFactory` and rebuild the filesystem themselves.

The path of an object-store URL keeps its netloc (``s3://bucket/key`` ->
``bucket/key``), as the JAX package's does. fsspec's ``memory`` filesystem
roots its paths at ``/``, so a store there is addressed as
``memory:///bucket/key``; ``memory://bucket/key`` fails in both packages.
fsspec's ``memory`` filesystem hands every reader of a file the same
``BytesIO``, so two open handles share one position and a seek on one moves
the other: concurrent seek-and-read pairs (the storage engine's per-thread
range reads) return another range's bytes. Each open of such a file gets a
copy of its bytes here (:class:`_IndependentOpens`), where the JAX
package's reads race. This module imports no torch: process-pool and
service workers build their filesystem through it.
"""

import io
import warnings
from urllib.parse import urlparse

import pyarrow.fs as pafs


def normalize_dataset_url(url):
    """Strip trailing slashes; accept plain paths."""
    if not isinstance(url, str):
        raise ValueError('dataset URL must be a string, got {!r}'.format(url))
    return url.rstrip('/') if url != '/' else url


def normalize_dataset_url_or_urls(url_or_urls):
    """Normalize a URL or a non-empty list of URLs."""
    if isinstance(url_or_urls, (list, tuple)):
        if not url_or_urls:
            raise ValueError('dataset URL list must not be empty')
        return [normalize_dataset_url(url) for url in url_or_urls]
    return normalize_dataset_url(url_or_urls)


def _scheme_of(url):
    scheme = urlparse(url).scheme
    # drive letters and plain paths have empty or one-character schemes
    return scheme if len(scheme) > 1 else ''


def _extract_path(url):
    """The filesystem-local path of a URL: a local path stays as it is, hdfs
    drops the authority, an object store keeps ``bucket/key``."""
    parsed = urlparse(url)
    scheme = _scheme_of(url)
    if scheme == '':
        return url
    if scheme in ('file', 'hdfs'):
        return parsed.path
    return parsed.netloc + parsed.path


def check_hdfs_driver(hdfs_driver):
    """Validate the reference API's ``hdfs_driver`` argument. ``pyarrow.fs``
    has only the JVM libhdfs driver: ``'libhdfs3'`` is accepted, warns, and
    connects through libhdfs."""
    if hdfs_driver not in ('libhdfs', 'libhdfs3'):
        raise ValueError("hdfs_driver must be 'libhdfs' or 'libhdfs3', got {!r}"
                         .format(hdfs_driver))
    if hdfs_driver == 'libhdfs3':
        warnings.warn("hdfs_driver='libhdfs3' is accepted for petastorm API "
                      "compatibility, but pyarrow.fs only provides the JVM libhdfs "
                      "driver — connections will use libhdfs")


def _resolve_filesystem(url, storage_options=None):
    scheme = _scheme_of(url)
    if scheme in ('', 'file'):
        return pafs.LocalFileSystem()
    if scheme == 'hdfs':
        return _resolve_hdfs(url)
    # every other scheme goes through fsspec, with the caller's options
    import fsspec
    fs = fsspec.filesystem(scheme, **(storage_options or {}))
    return pafs.PyFileSystem(pafs.FSSpecHandler(_IndependentOpens(fs)))


class _IndependentOpens(object):
    """An fsspec filesystem whose opens for reading never share a position:
    a file object that is a ``BytesIO`` (fsspec's memory filesystem returns
    the one it stores) is handed out as a copy of its bytes, one an open.
    Everything else is the wrapped filesystem's."""

    def __init__(self, fs):
        self.fs = fs

    def __getattr__(self, name):
        if name.startswith('_') or name == 'fs':
            raise AttributeError(name)
        return getattr(self.fs, name)

    def open(self, path, mode='rb', **kwargs):
        handle = self.fs.open(path, mode=mode, **kwargs)
        if mode == 'rb' and isinstance(handle, io.BytesIO):
            return io.BytesIO(handle.getvalue())
        return handle


def _resolve_hdfs(url):
    """Connect an ``hdfs://`` URL, routing hostless and HA-nameservice
    authorities through the hadoop-config namenode resolver:

    - ``hdfs:///path``: ``fs.defaultFS`` of the hadoop config;
    - ``hdfs://nameservice/path`` naming a ``dfs.nameservices`` entry: its
      namenodes;
    - ``hdfs://host:port/path``: a direct connection (a portless host is
      first looked up among the configured nameservices).

    Several namenodes give an :class:`~petastorm_tpu_torch.hdfs.namenode.HAHdfsClient`
    failover proxy, one namenode a direct connection."""
    from petastorm_tpu_torch.hdfs.namenode import (HdfsConfigError, HdfsConnector,
                                                   HdfsNamenodeResolver)
    parsed = urlparse(url)
    if parsed.port:
        return pafs.HadoopFileSystem(parsed.hostname, parsed.port)
    resolver = HdfsNamenodeResolver()
    if parsed.hostname and not resolver.configured:
        # no hadoop config of ours: the authority may be a logical nameservice
        # only libhdfs's own core-site.xml resolves, so it gets port 0
        return pafs.HadoopFileSystem(parsed.hostname, 0)
    try:
        if not parsed.hostname:
            _, namenodes = resolver.resolve_default_hdfs_service()
        else:
            namenodes = resolver.resolve_hdfs_name_service(parsed.hostname)
    except HdfsConfigError:
        # a config that cannot resolve this URL: libhdfs's own lookup is last
        return pafs.HadoopFileSystem(parsed.hostname or 'default', parsed.port or 0)
    if len(namenodes) > 1:
        # the proxy fails over mid-job; Arrow C++ consumers unwrap it through
        # as_arrow_filesystem()
        return HdfsConnector.connect_ha(namenodes)
    return HdfsConnector.connect_to_either_namenode(namenodes)


def _resolve_single(url, storage_options=None, filesystem=None):
    if filesystem is None:
        filesystem = _resolve_filesystem(url, storage_options)
    return filesystem, _extract_path(url)


def get_filesystem_and_path_or_paths(url_or_urls, storage_options=None, filesystem=None):
    """Resolve a URL (or a list of URLs on one filesystem) into one pyarrow
    filesystem (``filesystem`` when given) and the path(s). URLs of different
    schemes or netlocs are refused, naming the first that differs."""
    urls = url_or_urls if isinstance(url_or_urls, (list, tuple)) else [url_or_urls]
    urls = [normalize_dataset_url(u) for u in urls]
    schemes = {_scheme_of(u) for u in urls}
    netlocs = {urlparse(u).netloc for u in urls}
    if len(schemes) > 1 or len(netlocs) > 1:
        first_key = (_scheme_of(urls[0]), urlparse(urls[0]).netloc)
        mismatched = next(
            u for u in urls[1:] if (_scheme_of(u), urlparse(u).netloc) != first_key)
        raise ValueError('All dataset URLs must share one filesystem; got schemes {} '
                         'netlocs {}; first mismatch: {!r} does not match {!r}'
                         .format(sorted(schemes), sorted(netlocs), mismatched,
                                 urls[0]))
    if filesystem is None:
        filesystem = _resolve_filesystem(urls[0], storage_options)
    paths = [_extract_path(u) for u in urls]
    if isinstance(url_or_urls, (list, tuple)):
        return filesystem, paths
    return filesystem, paths[0]


def as_arrow_filesystem(filesystem):
    """The real pyarrow filesystem behind ``filesystem``: a failover proxy
    (``HAHdfsClient``) is unwrapped for APIs that need a C++
    ``pyarrow.fs.FileSystem`` (``pyarrow.dataset``); others pass through."""
    unwrap = getattr(filesystem, 'unwrap', None)
    return unwrap() if callable(unwrap) else filesystem


def path_exists(filesystem, path):
    """True when the path exists on the filesystem."""
    return filesystem.get_file_info(path).type != pafs.FileType.NotFound


def delete_path(filesystem, path, recursive=True):
    """Delete a file or a directory tree (only the directory's contents when
    not ``recursive``); a missing path is left alone."""
    info = filesystem.get_file_info(path)
    if info.type == pafs.FileType.Directory:
        if recursive:
            filesystem.delete_dir(path)
        else:
            filesystem.delete_dir_contents(path)
    elif info.type != pafs.FileType.NotFound:
        filesystem.delete_file(path)


class FilesystemFactory(object):
    """A picklable zero-argument callable that rebuilds a URL's filesystem:
    what a reader ships to its workers instead of a live filesystem. With a
    ``retry_policy`` (:class:`~petastorm_tpu_torch.resilience.RetryPolicy`)
    a transient resolution failure (a DNS blip, throttled object-store auth,
    a namenode failover race) is retried before it surfaces; workers call the
    factory again after a retry dropped a broken connection."""

    def __init__(self, url, storage_options=None, retry_policy=None):
        self._url = url
        self._storage_options = storage_options
        self._retry_policy = retry_policy

    def __call__(self):
        # the workers hand the filesystem to Arrow C++ (make_fragment), which
        # takes no python HA proxy
        def resolve():
            return as_arrow_filesystem(
                _resolve_single(self._url, self._storage_options)[0])
        if self._retry_policy is None:
            return resolve()
        from petastorm_tpu_torch.resilience import run_with_retry
        filesystem, _ = run_with_retry(resolve, self._retry_policy)
        return filesystem


class GivenFilesystemFactory(object):
    """The worker-side factory of a caller's own ``filesystem=``: hands back
    that filesystem (pickled with the factory), unwrapped for Arrow C++. The
    port's picklable stand-in for the JAX reader's lambda."""

    def __init__(self, filesystem):
        self._filesystem = filesystem

    def __call__(self):
        return as_arrow_filesystem(self._filesystem)


def make_filesystem_factory(url, storage_options=None, retry_policy=None):
    """A picklable zero-argument factory resolving ``url``'s filesystem;
    ``retry_policy`` retries the resolution's transient failures."""
    return FilesystemFactory(url, storage_options, retry_policy=retry_policy)
