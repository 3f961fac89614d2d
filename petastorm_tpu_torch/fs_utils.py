"""Filesystem resolution: dataset URL -> (pyarrow filesystem, path).

This slice reads local paths and ``file://`` URLs through
``pyarrow.fs.LocalFileSystem``, or through a ``pyarrow.fs.FileSystem`` the
caller passes (a local one or one wrapping it, such as a ``PyFileSystem``);
HDFS and object stores (``petastorm_tpu``'s namenode resolver and fsspec
bridge) come in a later slice and are refused here with the scheme named.
"""

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


def _local_path(url):
    scheme = _scheme_of(url)
    if scheme == '':
        return url
    if scheme == 'file':
        return urlparse(url).path
    raise ValueError('URL scheme {!r} of {!r} is not supported by this package yet '
                     '(local paths and file:// only)'.format(scheme, url))


def get_filesystem_and_path_or_paths(url_or_urls, filesystem=None):
    """Resolve a URL (or list of URLs) into a pyarrow filesystem (``filesystem``
    when given, else a local one) and path(s)."""
    urls = url_or_urls if isinstance(url_or_urls, (list, tuple)) else [url_or_urls]
    paths = [_local_path(normalize_dataset_url(u)) for u in urls]
    if filesystem is None:
        filesystem = pafs.LocalFileSystem()
    elif not isinstance(filesystem, pafs.FileSystem):
        raise ValueError('filesystem must be a pyarrow.fs.FileSystem, got {!r}'
                         .format(filesystem))
    if isinstance(url_or_urls, (list, tuple)):
        return filesystem, paths
    return filesystem, paths[0]


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
