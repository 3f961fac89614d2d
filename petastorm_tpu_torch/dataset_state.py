"""Dataset identity and local sidecar state: a copy of
``petastorm_tpu.dataset_state``.

The rowgroup cache keys its entries by a *dataset token* (``WorkerSetup``)
and the cost profiler keeps its ledger sidecar in the dataset's *local state
home* (:mod:`~petastorm_tpu_torch.telemetry.cost_model`). This module is the
one definition of both. For the same store and read configuration the token
and the sidecar path equal the JAX package's, so a cost ledger written by one
package is found by the other.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Iterable, Optional, Sequence, Tuple

#: field-spec row: ``(name, numpy_dtype, shape, codec_config)``, stringified
#: by the caller so the token never depends on the repr of live codecs
FieldSpec = Tuple[str, str, str, str]


def derive_dataset_token(dataset_path_or_paths: Any,
                         fields_to_read: Sequence[str],
                         decode: bool,
                         has_transform: bool,
                         field_specs: Iterable[FieldSpec],
                         device_decode_fields: Iterable[str] = ()) -> str:
    """The 16-hex-char identity of one (dataset, read configuration) pair:
    the location, the field set, the decode mode, the transform flag and each
    field's codec (cached values are the decoded output). Two readers that
    differ in any of them never share cache entries or cost sidecars.
    ``device_decode_fields`` is appended only when non-empty."""
    token_parts = '{}|{}|{}|{}|{}'.format(dataset_path_or_paths,
                                          sorted(fields_to_read), decode,
                                          has_transform,
                                          sorted(field_specs))
    device_fields = sorted(device_decode_fields)
    if device_fields:
        token_parts += '|{}'.format(device_fields)
    return hashlib.md5(token_parts.encode('utf-8')).hexdigest()[:16]


def local_state_home(dataset_url_or_path: str,
                     cache_location: Optional[str] = None) -> Optional[str]:
    """The directory holding a dataset's local sidecar state: the disk cache's
    directory when one is configured, else the dataset directory of a LOCAL
    store (``file://`` or a bare path); None for a remote store without a
    cache (the caller must then name a path)."""
    if cache_location:
        return cache_location
    path = dataset_url_or_path
    if path.startswith('file://'):
        path = path[len('file://'):]
    if '://' in path:
        return None
    return path


def sidecar_path(dataset_url_or_path: str, basename: str,
                 cache_location: Optional[str] = None) -> Optional[str]:
    """``local_state_home(...)/basename``, or None when the dataset has no
    local state home."""
    home = local_state_home(dataset_url_or_path, cache_location)
    if home is None:
        return None
    return os.path.join(home, basename)


def cache_state_home(cache: Any) -> Optional[str]:
    """The local-state directory a cache object provides (the disk caches'
    ``state_home``), or None for a cache without one."""
    home = getattr(cache, 'state_home', None)
    if home is None:
        return None
    return str(home)
