"""The port's resilience primitives against the JAX package's
(``petastorm_tpu.resilience``): the same seeded backoff, the same retry
sequences and classifications, the same breaker transitions and ``as_dict``
under one injected clock, and the same quarantine records. All exact."""

import pickle

import pytest

from petastorm_tpu import errors as jax_errors
from petastorm_tpu import resilience as jax_res
from petastorm_tpu_torch import errors as port_errors
from petastorm_tpu_torch import resilience as port_res

POLICIES = [dict(), dict(seed=7, jitter_fraction=0.5),
            dict(seed=3, backoff_base_s=0.01, backoff_multiplier=3.0, max_backoff_s=0.2),
            dict(jitter_fraction=0.0, backoff_base_s=0.2)]


@pytest.mark.parametrize('kwargs', POLICIES)
def test_backoff_is_the_jax_sequence(kwargs):
    port = port_res.RetryPolicy(**kwargs)
    jax = jax_res.RetryPolicy(**kwargs)
    got = [port.backoff_s(attempt, key=key) for key in (0, 1, 17) for attempt in range(1, 7)]
    want = [jax.backoff_s(attempt, key=key) for key in (0, 1, 17) for attempt in range(1, 7)]
    assert got == want
    assert len(set(got)) > 1


@pytest.mark.parametrize('bad', [dict(max_attempts=0), dict(backoff_base_s=-1),
                                 dict(jitter_fraction=1.5)])
def test_policy_validation_matches(bad):
    with pytest.raises(ValueError):
        jax_res.RetryPolicy(**bad)
    with pytest.raises(ValueError):
        port_res.RetryPolicy(**bad)


class _Clock(object):
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def _retry_trace(res, errors, failures, policy_kwargs, exc_kind='transient'):
    """``(outcome, retries or error type, [(attempt, delay)])`` of one
    run_with_retry over a function that fails ``failures`` times."""
    clock = _Clock()
    calls = []
    retries = []

    def fn():
        calls.append(clock.now)
        clock.now += 0.01
        if len(calls) <= failures:
            if exc_kind == 'transient':
                raise errors.TransientIOError('down')
            raise ValueError('corrupt')
        return 'ok'

    try:
        result, used = res.run_with_retry(
            fn, res.RetryPolicy(**policy_kwargs), key=5, sleep=clock.sleep, clock=clock,
            on_retry=lambda attempt, exc, delay: retries.append((attempt, delay)))
        return (result, used, retries, calls)
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        return ('raised', type(exc).__name__, retries, calls)


@pytest.mark.parametrize('failures,policy_kwargs,kind', [
    (0, dict(), 'transient'),
    (2, dict(seed=1), 'transient'),
    (5, dict(max_attempts=3), 'transient'),
    (1, dict(), 'permanent'),
    (4, dict(max_attempts=6, total_deadline_s=0.3), 'transient'),
    (3, dict(max_attempts=6, per_attempt_deadline_s=0.005), 'transient'),
])
def test_run_with_retry_is_the_jax_sequence(failures, policy_kwargs, kind):
    got = _retry_trace(port_res, port_errors, failures, policy_kwargs, kind)
    want = _retry_trace(jax_res, jax_errors, failures, policy_kwargs, kind)
    assert got == want


def test_transient_classifier_matches():
    cases = [port_errors.TransientIOError('x'), jax_errors.TransientIOError('x'),
             OSError('reset'), TimeoutError(), ConnectionResetError(),
             FileNotFoundError(), PermissionError(), IsADirectoryError(), ValueError(),
             KeyError('k'), RuntimeError()]
    got = [port_res.is_transient_error(exc) for exc in cases]
    assert got == [jax_res.is_transient_error(exc) for exc in cases]
    assert got[:5] == [True] * 5 and not any(got[5:])


@pytest.mark.parametrize('on_error', ['raise', 'retry', 'skip'])
def test_resolve_retry_policy_matches(on_error):
    given = port_res.RetryPolicy(max_attempts=5)
    for policy in (None, given):
        port = port_res.resolve_retry_policy(on_error, policy)
        jax = jax_res.resolve_retry_policy(
            on_error, None if policy is None else jax_res.RetryPolicy(max_attempts=5))
        assert (port is None) == (jax is None)
        if port is not None:
            assert vars(port) == vars(jax)
    with pytest.raises(ValueError, match='on_error'):
        port_res.check_on_error('explode')


def _breaker_walk(res):
    """Every step's ``(allow, state, as_dict)`` of one scripted walk through
    closed -> open -> half-open -> open -> half-open -> closed, and the
    transitions the callback saw."""
    clock = _Clock()
    seen = []
    brk = res.CircuitBreaker('fs:x', failure_threshold=3, recovery_timeout_s=10.0,
                             clock=clock, on_transition=lambda *t: seen.append(t))
    steps = []
    script = ['fail', 'fail', 'ok', 'fail', 'fail', 'fail', 'allow', ('tick', 5), 'allow',
              ('tick', 5), 'allow', 'fail', 'allow', ('tick', 10), 'state', 'ok', 'allow',
              'fail', 'reset']
    for op in script:
        if op == 'fail':
            brk.record_failure()
        elif op == 'ok':
            brk.record_success()
        elif op == 'reset':
            brk.reset()
        elif isinstance(op, tuple):
            clock.now += op[1]
        allowed = brk.allow() if op == 'allow' else None
        steps.append((op, allowed, brk.tripped, brk.as_dict()))
    return steps, seen


def test_breaker_transitions_and_as_dict_match():
    got = _breaker_walk(port_res)
    assert got == _breaker_walk(jax_res)
    states = [step[3]['state'] for step in got[0]]
    assert {'closed', 'open', 'half_open'} <= set(states)
    assert ('fs:x', 'half_open', 'closed') in got[1]


def test_call_with_breaker_fails_fast_and_counts_only_classified_failures():
    outcomes = []
    for res, errors in ((port_res, port_errors), (jax_res, jax_errors)):
        clock = _Clock()
        brk = res.CircuitBreaker('b', failure_threshold=2, recovery_timeout_s=1.0,
                                 clock=clock)
        log = []
        for fn in (lambda: 1 / 0, _raise(errors.TransientIOError('x')),
                   _raise(errors.TransientIOError('x')), lambda: 'never'):
            try:
                log.append(res.call_with_breaker(fn, brk))
            except Exception as exc:  # noqa: BLE001 - the outcome is compared
                log.append(type(exc).__name__)
        clock.now += 1.0
        log.append(res.call_with_breaker(lambda: 'probe', brk))
        log.append(brk.as_dict())
        outcomes.append(log)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][:5] == ['ZeroDivisionError', 'TransientIOError', 'TransientIOError',
                               'TransientIOError', 'probe']


def _raise(exc):
    def fn():
        raise exc
    return fn


def test_board_snapshot_and_pickled_breaker_match():
    port_board, jax_board = port_res.BreakerBoard(), jax_res.BreakerBoard()
    for board in (port_board, jax_board):
        board.breaker('healthy')
        board.breaker('sick', failure_threshold=1).record_failure()
        assert board.breaker('sick') is board.breaker('sick')
    assert port_board.snapshot(only_tripped=True) == jax_board.snapshot(only_tripped=True)
    assert port_board.snapshot() == jax_board.snapshot()
    brk = port_res.CircuitBreaker('p', on_transition=print)
    brk.record_failure()
    copy = pickle.loads(pickle.dumps(brk))
    assert copy.as_dict() == brk.as_dict() and copy._on_transition is None


def test_quarantine_records_and_ledger_match():
    exc = port_errors.TransientIOError('x' * 600)
    port = port_res.QuarantineRecord.from_exception(exc, 3, '/a/part_1.parquet', 0, 3,
                                                    epoch=2)
    jax = jax_res.QuarantineRecord.from_exception(exc, 3, '/a/part_1.parquet', 0, 3, epoch=2)
    assert port.as_dict() == jax.as_dict()
    assert len(port.error) == 500 and port.reason == 'error'
    ledger = port_res.QuarantineLedger()
    assert not ledger
    ledger.raise_if_any()
    ledger.add(port)
    ledger.add(port_res.QuarantineRecord(**dict(port.as_dict(), reason='hang')))
    assert len(ledger) == 2 and [r['reason'] for r in ledger.as_dicts()] == ['error', 'hang']
    with pytest.raises(port_errors.QuarantinedRowGroupError, match='2 rowgroup') as info:
        ledger.raise_if_any()
    assert (info.value.piece_index, info.value.attempts) == (3, 3)
