"""The port's HDFS namenode resolution and failover
(``petastorm_tpu_torch.hdfs.namenode`` and ``fs_utils._resolve_hdfs``) held
against the JAX package's with scripted mock connectors, as
``tests/test_hdfs_namenode.py`` drives the JAX one: each case runs on both
packages and the results, connect attempts and raised errors must be equal.
No HDFS cluster is touched. Then an ``hdfs://`` URL read end to end by the
port's ``make_reader`` on a thread pool, through a failover proxy over the
local filesystem."""

import os
import pickle

import numpy as np
import pyarrow.fs as pafs
import pytest

import petastorm_tpu.fs_utils as jax_fs
import petastorm_tpu.hdfs.namenode as jax_nn
import petastorm_tpu_torch.fs_utils as port_fs
import petastorm_tpu_torch.hdfs.namenode as port_nn

PACKAGES = {'port': (port_nn, port_fs), 'jax': (jax_nn, jax_fs)}

HA_CONFIG = {
    'fs.defaultFS': 'hdfs://nameservice1',
    'dfs.nameservices': 'nameservice1,ns2',
    'dfs.ha.namenodes.nameservice1': 'nn1,nn2',
    'dfs.namenode.rpc-address.nameservice1.nn1': 'nn1.example.com:8020',
    'dfs.namenode.rpc-address.nameservice1.nn2': 'nn2.example.com:8020',
    'dfs.ha.namenodes.ns2': 'a,b,c',
    'dfs.namenode.rpc-address.ns2.a': 'a:8020',
    'dfs.namenode.rpc-address.ns2.b': 'b:8020',
    'dfs.namenode.rpc-address.ns2.c': 'c:8020',
}


class MockHdfs(object):
    """A filesystem whose operations fail for the first ``n_failovers`` calls."""

    def __init__(self, n_failovers=0, error=OSError):
        self.n_failovers = n_failovers
        self.error = error
        self.calls = 0
        self.type_name = 'mockhdfs'

    def get_file_info(self, path):
        self.calls += 1
        if self.n_failovers > 0:
            self.n_failovers -= 1
            raise self.error('scripted failure')
        return 'info:{}'.format(path)


def mock_connector(nn, failures=None, error=OSError, n_failovers=0):
    """A subclass of package ``nn``'s HdfsConnector whose connects fail a
    scripted number of times per address and are all recorded."""
    failures = dict(failures or {})

    class Connector(nn.HdfsConnector):
        attempts = []

        @classmethod
        def hdfs_connect_namenode(cls, address, user=None):
            cls.attempts.append((address, user))
            if failures.get(address, 0) > 0:
                failures[address] -= 1
                raise IOError('namenode {} down'.format(address))
            return MockHdfs(n_failovers, error)
    return Connector


def outcome(fn):
    try:
        return ('ok', fn())
    except Exception as exc:  # noqa: BLE001 - the outcome is compared across packages
        return ('raised', type(exc).__name__)


def both(case):
    """``case(nn, fs)`` on each package: the two outcomes, which must match."""
    results = {name: outcome(lambda nn=nn, fs=fs: case(nn, fs))
               for name, (nn, fs) in PACKAGES.items()}
    assert results['port'] == results['jax'], results
    return results['port']


CONFIG_CASES = [
    (HA_CONFIG, 'default', None), ({}, 'default', None),
    ({'fs.defaultFS': 'file:///tmp'}, 'default', None),
    (dict(HA_CONFIG, **{'fs.defaultFS': 'hdfs://nameservice1/user/me'}), 'default', None),
    (HA_CONFIG, 'service', 'nameservice1'), (HA_CONFIG, 'service', 'ns2'),
    (HA_CONFIG, 'service', 'plainhost:9000'), (HA_CONFIG, 'service', ''),
    ({k: v for k, v in HA_CONFIG.items() if k != 'dfs.ha.namenodes.nameservice1'},
     'service', 'nameservice1'),
    ({k: v for k, v in HA_CONFIG.items()
      if k != 'dfs.namenode.rpc-address.nameservice1.nn2'}, 'service', 'nameservice1'),
]


@pytest.mark.parametrize('config,call,arg', CONFIG_CASES)
def test_resolver_matrix_equals_jax(config, call, arg):
    def case(nn, fs):
        resolver = nn.HdfsNamenodeResolver(config)
        if call == 'default':
            return resolver.resolve_default_hdfs_service()
        return resolver.resolve_hdfs_name_service(arg)
    both(case)


def _write_hadoop_conf(conf_dir, core_site=None, hdfs_site=None):
    os.makedirs(conf_dir, exist_ok=True)
    for file_name, properties in (('core-site.xml', core_site), ('hdfs-site.xml', hdfs_site)):
        if properties is None:
            continue
        body = ''.join('<property><name>{}</name><value>{}</value></property>'
                       .format(k, v) for k, v in properties.items())
        with open(os.path.join(conf_dir, file_name), 'w') as f:
            f.write('<?xml version="1.0"?><configuration>{}</configuration>'.format(body))


@pytest.mark.parametrize('layout', ['HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL',
                                    'HADOOP_CONF_DIR', 'conf_dir_wins', 'none'])
def test_config_discovery_equals_jax(tmp_path, monkeypatch, layout):
    for var in ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL', 'HADOOP_CONF_DIR'):
        monkeypatch.delenv(var, raising=False)
    home = tmp_path / 'home'
    _write_hadoop_conf(str(home / 'etc' / 'hadoop'), core_site={'fs.defaultFS': 'hdfs://h'},
                       hdfs_site={'dfs.nameservices': 'h'})
    _write_hadoop_conf(str(tmp_path / 'conf'), core_site={'fs.defaultFS': 'hdfs://c'})
    if layout in ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL'):
        monkeypatch.setenv(layout, str(home))
    elif layout == 'HADOOP_CONF_DIR':
        monkeypatch.setenv('HADOOP_CONF_DIR', str(tmp_path / 'conf'))
    elif layout == 'conf_dir_wins':
        monkeypatch.setenv('HADOOP_HOME', str(home))
        monkeypatch.setenv('HADOOP_CONF_DIR', str(tmp_path / 'conf'))
    result = both(lambda nn, fs: (nn._load_hadoop_configuration(),
                                  nn.HdfsNamenodeResolver().configured))
    assert result[1][1] == (layout != 'none')


@pytest.mark.parametrize('failures,user', [
    ({}, None), ({}, 'alice'), ({'nn1:8020': 1}, None), ({'nn1:8020': 2}, None),
    ({'nn1:8020': 2, 'nn2:8020': 2}, None)])
def test_connect_failover_equals_jax(failures, user):
    def case(nn, fs):
        connector = mock_connector(nn, failures)
        result = connector.connect_to_either_namenode(['nn1:8020', 'nn2:8020'], user=user)
        return type(result).__name__, list(connector.attempts)
    result = both(case)
    if sum(failures.values()) >= 4:
        assert result == ('raised', 'HdfsConnectError')


@pytest.mark.parametrize('start,failures', [(-1, {}), (0, {}), (1, {'nn1:8020': 1}),
                                            (0, {'nn1:8020': 1, 'nn2:8020': 1})])
def test_try_next_namenode_equals_jax(start, failures):
    def case(nn, fs):
        connector = mock_connector(nn, failures)
        index, _ = connector._try_next_namenode(start, ['nn1:8020', 'nn2:8020'])
        return index, list(connector.attempts)
    both(case)


@pytest.mark.parametrize('n_failovers,error', [
    (0, OSError), (1, OSError), (2, OSError), (1, FileNotFoundError), (1, ValueError)])
def test_ha_client_failover_equals_jax(n_failovers, error):
    def case(nn, fs):
        connector = mock_connector(nn, n_failovers=n_failovers, error=error)
        client = connector.connect_ha(['nn1:8020', 'nn2:8020'])
        assert isinstance(client, nn.HAHdfsClient)
        try:
            answer = client.get_file_info('/p')
        except Exception as exc:  # noqa: BLE001 - compared across packages
            answer = type(exc).__name__
        return answer, client.type_name, list(connector.attempts)
    both(case)


class PicklableConnector(port_nn.HdfsConnector):
    @classmethod
    def hdfs_connect_namenode(cls, address, user=None):
        return MockHdfs()


def test_ha_client_pickles_unwraps_and_hides_private_names():
    client = PicklableConnector.connect_ha(['nn1:8020', 'nn2:8020'])
    restored = pickle.loads(pickle.dumps(client))
    assert restored._namenode_addresses == ['nn1:8020', 'nn2:8020']
    assert isinstance(port_fs.as_arrow_filesystem(client), MockHdfs)
    with pytest.raises(AttributeError):
        client._private
    with pytest.raises(port_nn.HdfsConnectError):
        port_nn.HdfsConnector.connect_ha([])


@pytest.mark.parametrize('attempts_to_fail,error', [(1, OSError), (2, OSError),
                                                    (1, FileNotFoundError)])
def test_failover_decorator_equals_jax(attempts_to_fail, error):
    def case(nn, fs):
        class Client(object):
            reconnects = 0
            attempts = 0

            def reconnect(self):
                self.reconnects += 1

            @nn.namenode_failover
            def op(self):
                self.attempts += 1
                if self.attempts <= attempts_to_fail:
                    raise error('down')
                return 'ok'

        client = Client()
        return outcome(client.op), client.reconnects, client.attempts
    both(case)


@pytest.mark.parametrize('url,configured', [
    ('hdfs://somehost:9000/ds', True), ('hdfs://routed/ds', True), ('hdfs:///ds', True),
    ('hdfs://lonehost/ds', True), ('hdfs:///ds', False), ('hdfs://logicalns/ds', False)])
def test_hdfs_url_routing_equals_jax(tmp_path, monkeypatch, url, configured):
    for var in ('HADOOP_PREFIX', 'HADOOP_INSTALL', 'HADOOP_CONF_DIR'):
        monkeypatch.delenv(var, raising=False)
    conf = str(tmp_path / 'etc' / 'hadoop')
    _write_hadoop_conf(conf, core_site={'fs.defaultFS': 'hdfs://routed'}, hdfs_site={
        'dfs.nameservices': 'routed', 'dfs.ha.namenodes.routed': 'nn1,nn2',
        'dfs.namenode.rpc-address.routed.nn1': 'r1:8020',
        'dfs.namenode.rpc-address.routed.nn2': 'r2:8020'})
    monkeypatch.setenv('HADOOP_HOME', str(tmp_path) if configured else '/nonexistent')
    calls = []
    monkeypatch.setattr(pafs, 'HadoopFileSystem',
                        lambda host, port, user=None, **kw: calls.append(
                            ('direct', host, port)) or 'direct')
    for nn, _ in PACKAGES.values():
        monkeypatch.setattr(nn.HdfsConnector, 'connect_to_either_namenode', classmethod(
            lambda cls, nodes, user=None: calls.append(('single', list(nodes))) or 'single'))
        monkeypatch.setattr(nn.HdfsConnector, 'connect_ha', classmethod(
            lambda cls, nodes, user=None: calls.append(('ha', list(nodes))) or 'ha'))
    ours = port_fs._resolve_hdfs(url)
    port_calls, calls[:] = list(calls), []
    assert (ours, port_calls) == (jax_fs._resolve_hdfs(url), calls)


def test_hdfs_url_reads_through_a_failover_proxy(tmp_path, monkeypatch):
    """``make_reader('hdfs://routed/<path>')`` on a thread pool: the URL
    resolves to the HA proxy (over the local filesystem here), the dataset
    open unwraps it, and each worker rebuilds it through its factory."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('S', [UnischemaField('id', np.int64, (), ScalarCodec(), False)])
    path = str(tmp_path / 'ds')
    write_rows('file://' + path, schema, [{'id': i} for i in range(20)], rows_per_file=5)
    _write_hadoop_conf(str(tmp_path / 'etc' / 'hadoop'), hdfs_site={
        'dfs.nameservices': 'routed', 'dfs.ha.namenodes.routed': 'nn1,nn2',
        'dfs.namenode.rpc-address.routed.nn1': 'r1:8020',
        'dfs.namenode.rpc-address.routed.nn2': 'r2:8020'})
    for var in ('HADOOP_PREFIX', 'HADOOP_INSTALL', 'HADOOP_CONF_DIR'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('HADOOP_HOME', str(tmp_path))
    connects = []
    monkeypatch.setattr(port_nn.HdfsConnector, 'hdfs_connect_namenode', classmethod(
        lambda cls, address, user=None: connects.append(address) or pafs.LocalFileSystem()))
    with make_reader('hdfs://routed' + path, reader_pool_type='thread', workers_count=2,
                     hdfs_driver='libhdfs') as reader:
        assert sorted(int(row.id) for row in reader) == list(range(20))
    # the reader's own open and at least one worker's factory
    assert len(connects) >= 2 and set(connects) == {'r1:8020'}
