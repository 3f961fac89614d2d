"""Deterministic fault injection for resilience tests: a pyarrow-FS wrapper that fails,
delays, or kills the calling worker on a schedule. A copy of
``petastorm_tpu.test_util.fault_injection``: the same rules, marker files and
pickling, raising the port's :class:`~petastorm_tpu_torch.errors.TransientIOError`.

Every recovery behavior of the reader (retry, skip-with-quarantine, worker
respawn) is tested against this filesystem rather than against real network flakiness:
the schedule is explicit and the trigger state lives in ``state_dir`` as atomically
created marker files, so "fail the first N opens of path X" means the first N opens
**globally** — across every thread pool worker, every spawned process-pool worker, and
every respawned replacement — regardless of interleaving. That is what makes
fail-once-then-succeed deterministic on all three pools.

Usage::

    schedule = FaultSchedule(state_dir, [
        FaultRule('part_0', times=1, kind='fail'),          # first open of part_0 fails
        FaultRule('part_1', kind='latency', latency_s=0.2), # every open is slow
        FaultRule('part_2', kind='kill'),                   # SIGKILL the opening process
        FaultRule('part_3', kind='hang', times=1),          # opener sleeps "forever"
        FaultRule('part_4', kind='corrupt', times=1),       # bit-flip the file first
        FaultRule('part_5', kind='latency', latency_s=0.01, # p99-style tail: every
                  tail_latency_s=0.5, tail_every_n=10),     # 10th open/read stalls
    ])
    fs = fault_injecting_filesystem(schedule)               # wraps LocalFileSystem
    make_reader('file:///data', filesystem=fs, on_error='retry', ...)

``kind='hang'`` models the two real hang shapes the watchdog distinguishes: ``hang_mode='sleep'`` blocks only the opening thread
(GIL released — heartbeats keep flowing; only the per-item deadline catches
it), ``hang_mode='stop'`` SIGSTOPs the whole process (heartbeats stall — the
staleness reap catches it; the watchdog's SIGKILL terminates a stopped
process). ``kind='corrupt'`` damages the target FILE in place before the open
proceeds (``corrupt_mode='flip'`` bit-flips the middle byte,
``'truncate'`` halves it) — deterministic bit-rot for self-heal tests.

``kind='latency'`` with ``tail_every_n > 0`` models a latency *distribution*
rather than a constant: every matching open AND every read on the opened file
claims a marker-file sequence number and sleeps ``latency_s``, with
``tail_latency_s`` added on every ``tail_every_n``-th event globally. That is
a reproducible p99 tail — the storage engine's hedging tests assert that hedged fetches
beat it deterministically. ``tail_every_n == 0`` (the default) preserves the
original open-only constant sleep exactly.

The wrapper is picklable (ships to process-pool workers through their bootstrap) and
rebuilds its wrapped filesystem on unpickle.
"""

import os
import time

import pyarrow.fs as pafs

from petastorm_tpu_torch.errors import TransientIOError

_FAULT_KINDS = ('fail', 'latency', 'kill', 'hang', 'corrupt')
_HANG_MODES = ('sleep', 'stop')
_CORRUPT_MODES = ('flip', 'truncate')


class FaultRule(object):
    """One injection rule, matched against the path of every intercepted open.

    :param path_substring: rule applies to paths containing this substring.
    :param kind: ``'fail'`` raises ``exception_type``; ``'latency'`` sleeps
        ``latency_s`` then proceeds; ``'kill'`` SIGKILLs the calling process (worker
        respawn tests — only ever schedule this against process-pool workers).
    :param times: trigger at most this many times globally (None = every time).
    :param after: skip the first ``after`` matching opens before triggering
        (``after=n-1, times=1`` = classic fail-Nth-open).
    :param latency_s: sleep duration for ``'latency'``.
    :param tail_latency_s: for ``'latency'``: extra sleep added on every
        ``tail_every_n``-th matching event (opens and reads share one global
        counter), turning the constant delay into a distribution with a
        deterministic tail.
    :param tail_every_n: for ``'latency'``: 0 (default) keeps the original
        open-only constant sleep; N > 0 also intercepts reads on the opened
        file and fires the tail on every N-th event.
    :param exception_type: exception class for ``'fail'`` — default
        :class:`TransientIOError` (retryable); pass e.g. ``ValueError`` to model a
        permanent fault.
    :param hang_mode: for ``'hang'``: ``'sleep'`` (block only the opening thread
        for ``hang_s`` — a GIL-releasing stall, caught by the per-item deadline)
        or ``'stop'`` (SIGSTOP the whole process — a process-wide wedge, caught
        by heartbeat staleness).
    :param hang_s: sleep duration for ``hang_mode='sleep'`` (default: effectively
        forever relative to any test deadline).
    :param corrupt_mode: for ``'corrupt'``: ``'flip'`` (XOR the middle byte of
        the target file) or ``'truncate'`` (halve it) before the open proceeds.
    """

    def __init__(self, path_substring, kind='fail', times=None, after=0,
                 latency_s=0.0, exception_type=TransientIOError,
                 hang_mode='sleep', hang_s=3600.0, corrupt_mode='flip',
                 tail_latency_s=0.0, tail_every_n=0):
        if kind not in _FAULT_KINDS:
            raise ValueError('kind must be one of {}, got {!r}'.format(_FAULT_KINDS, kind))
        if times is not None and times < 1:
            raise ValueError('times must be >= 1 or None')
        if after < 0:
            raise ValueError('after must be >= 0')
        if hang_mode not in _HANG_MODES:
            raise ValueError('hang_mode must be one of {}, got {!r}'
                             .format(_HANG_MODES, hang_mode))
        if corrupt_mode not in _CORRUPT_MODES:
            raise ValueError('corrupt_mode must be one of {}, got {!r}'
                             .format(_CORRUPT_MODES, corrupt_mode))
        if tail_every_n < 0:
            raise ValueError('tail_every_n must be >= 0')
        if tail_latency_s < 0:
            raise ValueError('tail_latency_s must be >= 0')
        self.path_substring = path_substring
        self.kind = kind
        self.times = times
        self.after = after
        self.latency_s = latency_s
        self.exception_type = exception_type
        self.hang_mode = hang_mode
        self.hang_s = hang_s
        self.corrupt_mode = corrupt_mode
        self.tail_latency_s = tail_latency_s
        self.tail_every_n = tail_every_n

    def matches(self, path):
        return self.path_substring in path


class FaultSchedule(object):
    """Ordered rules plus the shared trigger state. ``state_dir`` must be a local
    directory reachable by every worker process; marker files created with
    ``O_CREAT|O_EXCL`` make each trigger decision an atomic, once-only global event."""

    def __init__(self, state_dir, rules):
        self.state_dir = str(state_dir)
        self.rules = list(rules)
        os.makedirs(self.state_dir, exist_ok=True)

    def _claim(self, prefix):
        """Atomically claim the next slot for ``prefix``; returns the 0-based global
        sequence number this caller won (creation races retry on the next slot)."""
        index = 0
        while True:
            marker = os.path.join(self.state_dir, '{}.{}'.format(prefix, index))
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                index += 1
                continue
            os.close(fd)
            return index

    def on_open(self, path):
        """Run every matching rule for one open call; raises / sleeps / kills per the
        schedule. Called by the wrapper before delegating to the real filesystem."""
        for rule_index, rule in enumerate(self.rules):
            if not rule.matches(path):
                continue
            seq = self._claim('calls-{}'.format(rule_index))
            if seq < rule.after:
                continue
            if rule.times is not None and seq >= rule.after + rule.times:
                continue
            if rule.kind == 'latency':
                self._latency_sleep(rule, seq)
            elif rule.kind == 'kill':
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            elif rule.kind == 'hang':
                if rule.hang_mode == 'stop':
                    import signal
                    # process-wide wedge: every thread (heartbeat included)
                    # freezes; only the watchdog's SIGKILL ends it
                    os.kill(os.getpid(), signal.SIGSTOP)
                else:
                    time.sleep(rule.hang_s)
            elif rule.kind == 'corrupt':
                corrupt_file(path, rule.corrupt_mode)
            else:
                raise rule.exception_type(
                    'injected fault #{} for {!r} (rule {}: open of {})'
                    .format(seq + 1, rule.path_substring, rule_index, path))

    @staticmethod
    def _latency_sleep(rule, seq):
        """Sleep per the rule's latency distribution: the base delay always,
        plus the tail on every ``tail_every_n``-th global event (1-based, so
        ``tail_every_n=10`` stalls events 10, 20, ...)."""
        delay = rule.latency_s
        if rule.tail_every_n and (seq + 1) % rule.tail_every_n == 0:
            delay += rule.tail_latency_s
        if delay > 0:
            time.sleep(delay)

    def wants_read_latency(self, path):
        """True when some latency rule with a tail distribution matches ``path``
        — the wrapper then intercepts reads on the opened file too."""
        return any(rule.kind == 'latency' and rule.tail_every_n and
                   rule.matches(path) for rule in self.rules)

    def on_read(self, path):
        """Run the read-side of every tail-distribution latency rule for one
        read call. Reads claim from the SAME marker prefix as opens, so the
        every-N-th-event tail is global across both — what makes the injected
        p99 reproducible regardless of open/read interleaving."""
        for rule_index, rule in enumerate(self.rules):
            if rule.kind != 'latency' or not rule.tail_every_n:
                continue
            if not rule.matches(path):
                continue
            seq = self._claim('calls-{}'.format(rule_index))
            if seq < rule.after:
                continue
            if rule.times is not None and seq >= rule.after + rule.times:
                continue
            self._latency_sleep(rule, seq)

    def trigger_count(self, rule_index=None):
        """Opens observed so far (for a single rule, or summed) — lets tests assert the
        schedule actually fired."""
        counts = []
        for index in range(len(self.rules)):
            count = 0
            while os.path.exists(os.path.join(self.state_dir,
                                              'calls-{}.{}'.format(index, count))):
                count += 1
            counts.append(count)
        return counts[rule_index] if rule_index is not None else sum(counts)


def corrupt_file(path, corrupt_mode='flip'):
    """THE repo-wide file-damage model (rule ``kind='corrupt'``, and called
    directly by corruption tests so every self-heal test exercises identical
    damage): ``'flip'`` XORs the middle byte in place, ``'truncate'`` halves
    the file but never below 24 bytes — a leading magic/header stays intact, so
    the damage lands in the BODY that only a checksum can defend. Local paths
    only (the wrapper normalizes them before the base open)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return  # nothing to corrupt; let the real open report the miss
    if size == 0:
        return
    with open(path, 'r+b') as f:
        if corrupt_mode == 'truncate':
            f.truncate(max(24, size // 2))
        else:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))


class _TailLatencyFile(object):
    """File-like over an opened NativeFile that runs the schedule's read-side
    latency distribution before every read — the injected "slow GET" the
    storage engine's hedging races against. Wrapped in ``pa.PythonFile`` by
    the handler so pyarrow sees a normal random-access input file."""

    def __init__(self, raw, schedule, path):
        self._raw = raw
        self._schedule = schedule
        self._path = path

    def read(self, nbytes=None):
        self._schedule.on_read(self._path)
        if nbytes is None:
            return self._raw.read()
        return self._raw.read(nbytes)

    def seek(self, position, whence=0):
        return self._raw.seek(position, whence)

    def tell(self):
        return self._raw.tell()

    def readable(self):
        return True

    def seekable(self):
        return True

    def writable(self):
        return False

    def flush(self):
        pass

    def close(self):
        self._raw.close()

    @property
    def closed(self):
        return self._raw.closed


class FaultInjectingHandler(pafs.FileSystemHandler):
    """pyarrow FileSystemHandler delegating everything to a wrapped C++ filesystem,
    with the schedule's faults injected on input opens (the calls Parquet reads make)."""

    def __init__(self, schedule, base_filesystem=None):
        self._schedule = schedule
        self._base = base_filesystem if base_filesystem is not None \
            else pafs.LocalFileSystem()

    # -------------------------------------------------------------- intercepted
    def open_input_file(self, path):
        self._schedule.on_open(path)
        raw = self._base.open_input_file(path)
        if self._schedule.wants_read_latency(path):
            import pyarrow as pa
            return pa.PythonFile(_TailLatencyFile(raw, self._schedule, path),
                                 mode='r')
        return raw

    def open_input_stream(self, path):
        self._schedule.on_open(path)
        return self._base.open_input_stream(path)

    # -------------------------------------------------------------- delegation
    def get_type_name(self):
        return 'fault-injecting+{}'.format(self._base.type_name)

    def get_file_info(self, paths):
        return self._base.get_file_info(paths)

    def get_file_info_selector(self, selector):
        return self._base.get_file_info(selector)

    def create_dir(self, path, recursive):
        self._base.create_dir(path, recursive=recursive)

    def delete_dir(self, path):
        self._base.delete_dir(path)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self._base.delete_dir_contents(path, missing_dir_ok=missing_dir_ok)

    def delete_root_dir_contents(self):
        self._base.delete_dir_contents('/', accept_root_dir=True)

    def delete_file(self, path):
        self._base.delete_file(path)

    def move(self, src, dest):
        self._base.move(src, dest)

    def copy_file(self, src, dest):
        self._base.copy_file(src, dest)

    def open_output_stream(self, path, metadata):
        return self._base.open_output_stream(path, metadata=metadata)

    def open_append_stream(self, path, metadata):
        return self._base.open_append_stream(path, metadata=metadata)

    def normalize_path(self, path):
        return self._base.normalize_path(path)

    def __eq__(self, other):
        return isinstance(other, FaultInjectingHandler) and \
            self._schedule is other._schedule

    def __ne__(self, other):
        return not self.__eq__(other)


def fault_injecting_filesystem(schedule, base_filesystem=None):
    """A ``pyarrow.fs.FileSystem`` (PyFileSystem-wrapped) that injects ``schedule``'s
    faults in front of ``base_filesystem`` (default: LocalFileSystem). Feed it to
    ``make_reader(..., filesystem=...)``."""
    return pafs.PyFileSystem(FaultInjectingHandler(schedule, base_filesystem))


class FaultInjectingFilesystemFactory(object):
    """Picklable zero-arg factory (the shape worker processes ship, mirroring
    ``fs_utils.FilesystemFactory``): rebuilds the fault-injecting filesystem from the
    schedule inside each worker. The schedule's file-based state keeps trigger counts
    global across the processes that rebuild it."""

    def __init__(self, schedule, base_filesystem=None):
        self._schedule = schedule
        self._base = base_filesystem

    def __call__(self):
        return fault_injecting_filesystem(self._schedule, self._base)
