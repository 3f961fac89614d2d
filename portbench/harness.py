"""One run of one cell of ``BENCHMARK.json``.

Set-up (``setup_s``, from the process's start): the cell's data, the port's
program built from the configuration and the workload with weights made on
the card from the seed, the reader filled, and the first steps trained
through the same loader and step as the window: the first
``FOLLOWED_STEPS`` are the ones the output check follows, then
``WARM_STEPS`` more; then a synchronize.

The window: steps run back to back with no synchronize; each ends at a CUDA
event recorded after the optimizer's step. The window spans from the event
recorded at its start to the last step end within ``--seconds``; the host
stops issuing once a finished event lies past that. Rates count the work of
the steps that ended in the window over its span; ``step_ms_p95`` is the
95th percentile of the intervals between consecutive step ends.

With ``--trace 1`` the same window also takes deltas of the program's
stage spans and loader counters, and is followed by ``TRACE_STEPS`` steps
under the profiler. Then the device's peak memory is read, the program is
stopped and freed, and the reference decides ``correct``.
"""

import importlib.util
import json
import math
import os
import sys
import time
import traceback

import torch

from portbench import devicetrace

FOLLOWED_STEPS = 3
WARM_STEPS = 2
TRACE_STEPS = 12
#: top-level modules that must never be loaded: JAX and the JAX package
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'optax', 'petastorm_tpu')
CACHE_DIR = 'portbench_cache'


class Cell(object):
    """A cell of ``BENCHMARK.json`` with its configuration, its workload and
    the metrics it reports (``config`` and ``workload`` given replace the
    files', as the tests do at a small size)."""

    def __init__(self, repo, name, config=None, workload=None):
        self.repo = repo
        with open(os.path.join(repo, 'BENCHMARK.json')) as f:
            bench = json.load(f)
        cells = {c['name']: c for c in bench['workloads']}
        if name not in cells:
            raise KeyError('no workload {!r} in BENCHMARK.json (has {})'.format(
                name, sorted(cells)))
        self.name = name
        self.entry = cells[name]
        if config is None:
            configs = {c['name']: c for c in bench['configs']}
            with open(os.path.join(repo, configs[self.entry['config']]['file'])) as f:
                config = json.load(f)
        if workload is None:
            with open(os.path.join(repo, 'portbench', 'workloads',
                                   self.entry['traffic'] + '.json')) as f:
                workload = json.load(f)
        self.config = config
        self.workload = dict(workload, name=self.entry['traffic'])
        self.end_to_end = [m for m in bench['end_to_end'] if self._reports(m)]
        self.per_layer = [m for m in bench['per_layer'] if self._reports(m)]

    def _reports(self, metric):
        return self.name in metric.get('workloads', [self.name])


def read_metric(repo, name, record):
    """``portbench/metrics/<name>.py``'s ``read(record)``."""
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + name.replace('.', '_'),
        os.path.join(repo, 'portbench', 'metrics', name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


class Clock(object):
    """Step-end marks: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def done(self, mark):
        return mark.query() if self.cuda else True

    def ms(self, start, end):
        return start.elapsed_time(end) if self.cuda else (end - start) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def pipeline_snapshot(program):
    """The loader's and the reader's stage spans and the loader's counters."""
    return {'loader': program.loader.telemetry.snapshot().get('histograms', {}),
            'reader': program.reader.telemetry_snapshot().get('histograms', {}),
            'stats': program.loader.stats.as_dict()}


def _delta(after, before):
    spans = {}
    for side in ('loader', 'reader'):
        spans[side] = {
            stage: {'sum': value['sum'] - before[side].get(stage, {}).get('sum', 0.0),
                    'count': value['count'] - before[side].get(stage, {}).get('count', 0)}
            for stage, value in after[side].items()}
    stats = {name: after['stats'][name] - before['stats'][name]
             for name in ('batches', 'rows', 'wait_time_s', 'total_time_s')}
    return spans, stats


def quantile(values, q):
    """The ``q`` quantile by linear interpolation between order statistics."""
    ordered = sorted(values)
    position = (len(ordered) - 1) * q
    low = int(math.floor(position))
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (position - low)


def window(program, seconds, clock):
    """Steps until a finished step end lies ``seconds`` past the window's
    start; returns the steps that ended within it."""
    works, losses, marks = [], [], []
    start = clock.mark()
    host_start = time.perf_counter()
    finished = -1
    while True:
        batch = next(program.batches)
        losses.append(program.step(batch))
        works.append(program.work(batch))
        marks.append(clock.mark())
        if time.perf_counter() - host_start < seconds:
            continue
        while finished + 1 < len(marks) and clock.done(marks[finished + 1]):
            finished += 1
        if finished >= 0 and clock.ms(start, marks[finished]) >= seconds * 1e3:
            break
    clock.sync()
    ends = [clock.ms(start, mark) for mark in marks]
    steps = sum(1 for end in ends if end <= seconds * 1e3)
    if steps == 0:
        raise RuntimeError('no step ended within the {} s window (the first took {:.1f} ms)'
                           .format(seconds, ends[0]))
    ends = ends[:steps]
    intervals = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    failed = int((~torch.isfinite(torch.stack(losses[:steps]).float())).sum())
    return {'steps': steps, 'seconds': ends[-1] / 1e3, 'intervals_ms': intervals,
            'failed': failed, 'totals': program.totals(works[:steps])}


def traced_steps(program, steps, device):
    """``steps`` more steps under the profiler: its summary and each step's
    facts for the per-layer readers."""
    facts = []

    def run_steps():
        for _ in range(steps):
            batch = next(program.batches)
            program.step(batch)
            facts.append(program.trace_fact(batch))

    if torch.device(device).type != 'cuda':
        run_steps()
        summary = None
    else:
        prof, _ = devicetrace.profile_steps(run_steps)
        summary = devicetrace.summarize(prof)
        del prof
    host_facts = [{name: value.to('cpu').numpy() if torch.is_tensor(value) else value
                   for name, value in fact.items()} for fact in facts]
    return summary, host_facts


def first_steps(program):
    """The program's readings of its first ``FOLLOWED_STEPS`` steps, each
    batch kept for the check: each step's loss, the first gradient's norm
    and the change's norm after the last, per leaf."""
    readings = {'losses': []}
    for index in range(FOLLOWED_STEPS):
        batch = next(program.batches)
        program.capture(batch)
        readings['losses'].append(float(program.step(batch, capture=index == 0)))
        if index == 0:
            readings['grad_norms'] = program.first_grad_norms()
    readings['change_norms'] = program.change_norms()
    return readings


def program_class_of(config):
    return importlib.import_module('portbench.tasks.' + config['task']).Program


def run_cell(cell, seed, seconds, trace, device='cuda', started=None, program_class=None):
    """One run of ``cell``; returns ``(result, checks)``: the result line's
    object without its checks, and ``{name: (value, limit)}``."""
    started = time.perf_counter() if started is None else started
    clock = Clock(device)
    program_class = program_class or program_class_of(cell.config)
    cache_root = data_cache(cell.repo)
    program = program_class(cell.config, cell.workload, seed, device, cache_root)
    readings = first_steps(program)
    for _ in range(WARM_STEPS):
        program.step(next(program.batches))
    clock.sync()
    cuda = torch.device(device).type == 'cuda'
    record = {'setup_s': time.perf_counter() - started,
              'card': torch.cuda.get_device_name(0) if cuda else 'cpu'}
    before = pipeline_snapshot(program) if trace else None
    record['window'] = window(program, seconds, clock)
    if trace:
        record['spans'], record['stats'] = _delta(pipeline_snapshot(program), before)
        record['trace'], record['facts'] = traced_steps(program, TRACE_STEPS, device)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    program.close()
    if cuda:
        torch.cuda.empty_cache()
    values = program.judge(readings, device)
    limits = cell.workload['limits']
    checks = {name: (float(values[name]), float(limits[name])) for name in sorted(limits)}
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(cell.repo, metric['name'], record)
        if value is not None:
            metrics[metric['name']] = {'value': value, 'unit': metric['unit']}
    result = {
        'correct': all(value <= limit for value, limit in checks.values()),
        'attempted': record['window']['steps'],
        'failed': record['window']['failed'],
        'metrics': metrics,
        'device': {'platform': 'gpu' if cuda else 'cpu',
                   'kind': record['card'],
                   'count': 1, 'memory_peak_bytes': memory_peak}}
    summary = record.get('trace')
    if summary is not None:
        result['device'].update(busy_s=summary['busy_s'], window_s=summary['window_s'])
        result['breakdown'] = {'device_ops': summary['device_ops'],
                               'idle_gaps': summary['idle_gaps']}
    return result, checks


def data_cache(repo):
    path = os.path.join(repo, CACHE_DIR, 'data')
    os.makedirs(path, exist_ok=True)
    return path


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def main(args, started):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = Cell(repo, args.workload)
    chips = cell.entry['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('portbench: the cell needs {} CUDA device(s); torch.cuda.is_available() is {} '
              'and {} are visible'.format(chips, torch.cuda.is_available(),
                                          torch.cuda.device_count()), file=sys.stderr)
        return 2
    try:
        result, checks = run_cell(cell, args.seed, args.seconds, args.trace, 'cuda', started)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print('portbench: modules of JAX or the JAX package were loaded: {}'.format(
            ', '.join(found)), file=sys.stderr)
        return 3
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, (value, limit) in checks.items()}
    sys.stdout.write(json.dumps(result) + '\n')
    sys.stdout.flush()
    for name, (value, limit) in checks.items():
        print('check {} {!r} limit {!r} {}'.format(name, value, limit,
                                                   'ok' if value <= limit else 'FAILED'),
              file=sys.stderr)
    return 0
