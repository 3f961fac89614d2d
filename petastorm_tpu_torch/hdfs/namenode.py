"""Hadoop-config-driven namenode resolution with HA failover: a copy of
``petastorm_tpu.hdfs.namenode`` (which follows petastorm/hdfs/namenode.py).
It imports nothing of the package, and no torch.

``HdfsNamenodeResolver`` parses ``hdfs-site.xml``/``core-site.xml`` found via
``HADOOP_HOME``/``HADOOP_PREFIX``/``HADOOP_INSTALL`` (or an injected configuration dict)
and resolves HA nameservice logical names into concrete namenode URLs.
``HdfsConnector.connect_to_either_namenode`` tries each namenode in order with retries —
the reference's failover contract — over ``pyarrow.fs.HadoopFileSystem``.
"""

import logging
import os
import xml.etree.ElementTree as ET

logger = logging.getLogger(__name__)

_HADOOP_HOME_VARS = ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL')
MAX_NAMENODES = 2

# OSError subclasses that describe the *file*, not the connection — a failover retry
# cannot fix these and must not tear down a healthy namenode connection.
_NON_FAILOVER_ERRORS = (FileNotFoundError, PermissionError, FileExistsError,
                        IsADirectoryError, NotADirectoryError)


def _is_failover_error(exc):
    return isinstance(exc, OSError) and not isinstance(exc, _NON_FAILOVER_ERRORS)


class HdfsConfigError(RuntimeError):
    pass


def _load_hadoop_configuration():
    """Locate and parse hdfs-site.xml + core-site.xml into one {name: value} dict
    (reference: namenode.py:34-65). ``HADOOP_CONF_DIR`` (pointing directly at the conf
    directory, per hadoop convention) wins over the ``HADOOP_HOME``-style roots."""
    conf_dirs = []
    conf_dir_env = os.environ.get('HADOOP_CONF_DIR')
    if conf_dir_env:
        conf_dirs.append(conf_dir_env)
    for var in _HADOOP_HOME_VARS:
        home = os.environ.get(var)
        if home:
            conf_dirs.append(os.path.join(home, 'etc', 'hadoop'))
    for conf_dir in conf_dirs:
        config = {}
        for file_name in ('core-site.xml', 'hdfs-site.xml'):
            path = os.path.join(conf_dir, file_name)
            if os.path.exists(path):
                config.update(_parse_hadoop_xml(path))
        if config:
            return config
    return {}


def _parse_hadoop_xml(path):
    result = {}
    root = ET.parse(path).getroot()
    for prop in root.findall('property'):
        name = prop.findtext('name')
        value = prop.findtext('value')
        if name is not None and value is not None:
            result[name.strip()] = value.strip()
    return result


class HdfsNamenodeResolver(object):
    """Resolve HA nameservice names to namenode host:port lists (reference:
    namenode.py:31-120). An explicit ``configuration`` dict (name -> value, the flattened
    hadoop conf) overrides the environment lookup — the hook the tests use."""

    def __init__(self, configuration=None):
        self._config = configuration if configuration is not None \
            else _load_hadoop_configuration()

    @property
    def configured(self):
        """True when any hadoop configuration was found/injected. When False, the
        resolver cannot distinguish a logical HA nameservice from a physical host —
        callers should defer to libhdfs's own config instead of guessing."""
        return bool(self._config)

    def resolve_default_hdfs_service(self):
        """Return (nameservice, [namenode urls]) for fs.defaultFS (reference:
        namenode.py:110-120)."""
        default_fs = self._config.get('fs.defaultFS', '')
        if not default_fs.startswith('hdfs://'):
            raise HdfsConfigError('fs.defaultFS is not an HDFS URL: {!r}'
                                  .format(default_fs))
        nameservice = default_fs[len('hdfs://'):].split('/')[0]
        return nameservice, self.resolve_hdfs_name_service(nameservice)

    def resolve_hdfs_name_service(self, nameservice):
        """Namenode host:port list for a logical nameservice; a plain host(:port) comes
        back as a single-element list (reference: namenode.py:84-108)."""
        if not nameservice:
            raise HdfsConfigError('Empty nameservice')
        services = self._config.get('dfs.nameservices', '')
        service_names = [s.strip() for s in services.split(',') if s.strip()]
        if nameservice not in service_names:
            # Not a logical service: direct namenode address.
            return [nameservice]
        ha_key = 'dfs.ha.namenodes.{}'.format(nameservice)
        namenode_ids = [s.strip() for s in self._config.get(ha_key, '').split(',')
                        if s.strip()]
        if not namenode_ids:
            raise HdfsConfigError('Nameservice {!r} declared but {} is missing'
                                  .format(nameservice, ha_key))
        if len(namenode_ids) > MAX_NAMENODES:
            logger.warning('Nameservice %r has %d namenodes; only the first %d are used',
                           nameservice, len(namenode_ids), MAX_NAMENODES)
            namenode_ids = namenode_ids[:MAX_NAMENODES]
        addresses = []
        for namenode_id in namenode_ids:
            rpc_key = 'dfs.namenode.rpc-address.{}.{}'.format(nameservice, namenode_id)
            address = self._config.get(rpc_key)
            if not address:
                raise HdfsConfigError('Missing {} for nameservice {!r}'
                                      .format(rpc_key, nameservice))
            addresses.append(address)
        return addresses


class HdfsConnectError(IOError):
    pass


class HdfsConnector(object):
    """Failover connector: try each namenode in order, retrying each (reference:
    namenode.py:123-316)."""

    MAX_ATTEMPTS_PER_NAMENODE = 2

    @classmethod
    def hdfs_connect_namenode(cls, address, user=None):
        """Connect one namenode via pyarrow HadoopFileSystem; override in tests."""
        import pyarrow.fs as pafs
        host, _, port = address.partition(':')
        return pafs.HadoopFileSystem(host or 'default', int(port) if port else 8020,
                                     user=user)

    @classmethod
    def connect_to_either_namenode(cls, namenode_addresses, user=None):
        """Return the first filesystem that connects; raise HdfsConnectError when every
        namenode fails (reference failover loop)."""
        errors = []
        for address in namenode_addresses:
            for attempt in range(cls.MAX_ATTEMPTS_PER_NAMENODE):
                try:
                    return cls.hdfs_connect_namenode(address, user=user)
                except Exception as exc:  # noqa: BLE001 - collect and fail over
                    errors.append('{} (attempt {}): {}'.format(address, attempt + 1, exc))
                    logger.debug('Namenode connect failed: %s', errors[-1])
        raise HdfsConnectError('Could not connect to any namenode of {}:\n{}'
                               .format(list(namenode_addresses), '\n'.join(errors)))

    @classmethod
    def connect_ha(cls, namenode_addresses, user=None):
        """Return a picklable :class:`HAHdfsClient` proxy that fails over between the
        given namenodes on every operation (reference: namenode.py:274-286)."""
        if not namenode_addresses:
            raise HdfsConnectError('Must supply at least one namenode address')
        return HAHdfsClient(cls, list(namenode_addresses), user=user)

    @classmethod
    def _try_next_namenode(cls, index_of_nn, namenode_addresses, user=None):
        """Round-robin connect starting after ``index_of_nn``; return
        ``(new_index, filesystem)`` (reference: namenode.py:288-316)."""
        count = len(namenode_addresses)
        for step in range(1, count + 1):
            idx = (index_of_nn + step) % count
            address = namenode_addresses[idx]
            try:
                return idx, cls.hdfs_connect_namenode(address, user=user)
            except Exception as exc:  # noqa: BLE001 - expected for standby namenodes
                logger.debug('Namenode %s connect failed during failover: %s',
                             address, exc)
        raise HdfsConnectError('Unable to connect to any namenode of {}'
                               .format(list(namenode_addresses)))


class HAHdfsClient(object):
    """High-availability proxy over a live ``pyarrow.fs.HadoopFileSystem``.

    The reference subclasses the legacy python ``HadoopFileSystem`` and decorates every
    public method with ``namenode_failover`` (reference: namenode.py:211-238). Modern
    ``pyarrow.fs`` filesystems are C++ extension classes that cannot be subclassed that
    way, so this is a delegating proxy instead: attribute access forwards to the live
    connection, callables are wrapped so an ``OSError`` triggers a round-robin reconnect
    to the next namenode and a single retry. Picklable via ``__reduce__`` — workers
    re-resolve their own connection (reference: namenode.py:231-233).

    Pass :meth:`unwrap` to APIs that require a real pyarrow filesystem instance
    (e.g. ``pyarrow.dataset``); the proxy itself covers metadata-style calls made
    through it.
    """

    def __init__(self, connector_cls, namenode_addresses, user=None):
        self._connector_cls = connector_cls
        self._namenode_addresses = list(namenode_addresses)
        self._user = user
        self._index_of_nn = -1
        self._do_connect()

    def __reduce__(self):
        return self.__class__, (self._connector_cls, self._namenode_addresses, self._user)

    def _do_connect(self):
        self._index_of_nn, self._filesystem = self._connector_cls._try_next_namenode(
            self._index_of_nn, self._namenode_addresses, user=self._user)

    def reconnect(self):
        """Advance to the next namenode; used by :func:`namenode_failover` retries."""
        self._do_connect()

    def unwrap(self):
        """The live ``pyarrow.fs.HadoopFileSystem`` (reconnects if never connected)."""
        return self._filesystem

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        attr = getattr(self._filesystem, name)
        if not callable(attr):
            return attr

        def call_with_failover(*args, **kwargs):
            try:
                return attr(*args, **kwargs)
            except OSError as exc:
                if not _is_failover_error(exc):
                    raise
                logger.warning('HDFS %s failed; failing over to next namenode', name)
                self.reconnect()
                return getattr(self._filesystem, name)(*args, **kwargs)

        call_with_failover.__name__ = name
        return call_with_failover


def namenode_failover(func):
    """Decorator retrying an HDFS operation once after a connection failure (reference:
    petastorm's namenode_failover decorator). If the bound object exposes
    ``reconnect()``, it is invoked between attempts so the retry actually targets the
    standby namenode; otherwise this only covers transient errors on the existing
    connection."""
    import functools

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except OSError as exc:
            if not _is_failover_error(exc):
                raise
            reconnect = getattr(args[0], 'reconnect', None) if args else None
            if callable(reconnect):
                logger.warning('HDFS operation %s failed; reconnecting and retrying',
                               func.__name__)
                reconnect()
            else:
                logger.warning('HDFS operation %s failed; retrying once on the same '
                               'connection', func.__name__)
            return func(*args, **kwargs)

    return wrapper
