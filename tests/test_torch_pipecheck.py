"""The JAX package's static data-plane analyzer (``run_pipecheck``) reports
no finding over ``petastorm_tpu_torch/``, every suppression there carries its
reason, and the fault it found in the process pool stays fixed: a consumer that
calls ``get_results`` while ``join`` drains the workers gets its
``EmptyResultError`` at once instead of waiting out the drain for the pool's
receive lock."""

import os
import re
import threading
import time

import numpy as np
import pytest

from petastorm_tpu.analysis import run_pipecheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'petastorm_tpu_torch')
#: opens of the part file by the reader's construction in this process (its
#: dataset discovery and footer reads); the next open is the worker's
PARENT_OPENS = 2
DIRECTIVE = re.compile(r'#\s*pipecheck:\s*disable=([A-Za-z0-9_,-]+)\s*(?:--\s*(\S.*))?')


def test_the_port_is_clean_under_the_jax_analyzer():
    report = run_pipecheck(paths=[PORT])
    assert report.files > 80
    assert report.findings == [], [finding.format() for finding in report.findings]
    assert report.clean and report.by_rule() == {}
    directives = []
    for root, _, names in os.walk(PORT):
        for name in names:
            if name.endswith('.py'):
                with open(os.path.join(root, name)) as f:
                    directives.extend(DIRECTIVE.findall(f.read()))
    assert len(directives) == report.suppressed >= 1
    assert all(reason.strip() for _rule, reason in directives)


def test_get_results_during_join_answers_at_once(tmp_path):
    """The worker sleeps 3 s in its rowgroup open, so ``join``'s drain lasts
    until it wakes; ``get_results`` meanwhile must not wait for the lock."""
    from petastorm_tpu.test_util.fault_injection import (FaultRule, FaultSchedule,
                                                         fault_injecting_filesystem)
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.workers import EmptyResultError
    from petastorm_tpu_torch.workers.process_pool import ProcessPool
    url = 'file://' + str(tmp_path / 'store')
    write_rows(url, Unischema('Join', [UnischemaField('id', np.int64, (), ScalarCodec(),
                                                      False)]),
               [{'id': i} for i in range(8)])
    faulty = fault_injecting_filesystem(FaultSchedule(str(tmp_path / 'faults'), [
        FaultRule('.parquet', kind='latency', latency_s=3.0, after=PARENT_OPENS, times=1)]))
    pool = ProcessPool(1)
    reader = make_reader(url, reader_pool=pool, filesystem=faulty, shuffle_row_groups=False)
    consumer = threading.Thread(target=_consume, args=(pool,), daemon=True)
    consumer.start()
    deadline = time.monotonic() + 60
    while not pool._assigned and time.monotonic() < deadline:
        time.sleep(0.02)   # the consumer dispatches the item to the spawned worker
    assert pool._assigned, 'the item never reached the worker'
    reader.stop()
    consumer.join(timeout=5)
    assert not consumer.is_alive()
    joiner = threading.Thread(target=reader.join, daemon=True)
    joiner.start()
    time.sleep(0.2)
    start = time.monotonic()
    with pytest.raises(EmptyResultError):
        pool.get_results()
    waited = time.monotonic() - start
    draining = joiner.is_alive()
    joiner.join(timeout=30)
    assert not joiner.is_alive()
    assert draining, 'join() ended before the check: the drain was not under way'
    assert waited < 0.5, 'get_results waited {:.2f} s behind join()'.format(waited)


def _consume(pool):
    from petastorm_tpu_torch.workers import EmptyResultError
    try:
        pool.get_results()
    except EmptyResultError:
        pass
