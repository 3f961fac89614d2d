"""Reading a ``torch.profiler`` trace of a stretch of steps.

:func:`profile_steps` runs steps under the profiler (host operators and the
card's activity, through CUPTI) inside one named range that starts and ends
on an idle card, and :func:`summarize` reduces the trace to: the range's
length, the time the card was busy (the union of its kernels, copies and
fills within the range), each device operation's count and time, and the
gaps in which the card was idle, each named by the innermost host operator
of the training loop's thread that was running at its middle. Host ranges
(``record_function``) that the profiler mirrors onto the device's timeline
are not device work and are left out.
"""

import bisect

import torch

RANGE = 'portbench.traced_window'
#: characters of an operation's name kept
NAME_CHARS = 120


def profile_steps(run_steps):
    """``run_steps()`` under the profiler, after a synchronize, ending in one."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(RANGE):
            facts = run_steps()
            torch.cuda.synchronize()
    return prof, facts


def _events(prof):
    """[(name, on_device, start_ns, end_ns, thread)] of every event."""
    out = []
    for event in prof.profiler.kineto_results.events():
        start = event.start_ns()
        out.append((event.name(), 'CUDA' in str(event.device_type()), start,
                    start + event.duration_ns(), event.start_thread_id()))
    return out


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(prof, top=10):
    """``{'window_s', 'busy_s', 'ops': {name: [count, seconds]}, 'device_ops':
    [[name, seconds]] (the ``top`` largest), 'idle_gaps': [[host op,
    seconds]] (the ``top`` longest)}``; None when the trace holds no device
    activity in the range."""
    events = _events(prof)
    ranges = [e for e in events if e[0] == RANGE and not e[1]]
    if not ranges:
        return None
    _, _, start, end, thread = ranges[0]
    # a host range (record_function) is mirrored on the device's timeline:
    # it is no device work
    host_names = {name for name, on_device, _, _, _ in events if not on_device}
    ops = {}
    device = []
    for name, on_device, s, e, _ in events:
        if not on_device or name in host_names or e <= start or s >= end:
            continue
        s, e = max(s, start), min(e, end)
        device.append((s, e))
        name = name[:NAME_CHARS]
        count, seconds = ops.get(name, (0, 0.0))
        ops[name] = (count + 1, seconds + (e - s) / 1e9)
    if not device:
        return None
    busy = _union(device)
    gaps = []
    previous = start
    for s, e in busy + [[end, end]]:
        if s > previous:
            gaps.append((s - previous, previous))
        previous = max(previous, e)
    host = sorted((s, e, name) for name, on_device, s, e, t in events
                  if not on_device and t == thread and name != RANGE and s < end and e > start)
    starts = [h[0] for h in host]
    idle = []
    for length, gap_start in sorted(gaps, reverse=True)[:top]:
        middle = gap_start + length / 2
        label = 'no host operator'
        # the innermost operator running at the middle started last
        for index in range(bisect.bisect_right(starts, middle) - 1, -1, -1):
            if host[index][1] > middle:
                label = host[index][2][:NAME_CHARS]
                break
        idle.append([label, length / 1e9])
    return {'window_s': (end - start) / 1e9,
            'busy_s': sum(e - s for s, e in busy) / 1e9,
            'ops': {name: list(value) for name, value in ops.items()},
            'device_ops': sorted(([name, value[1]] for name, value in ops.items()),
                                 key=lambda item: -item[1])[:top],
            'idle_gaps': idle}


def kernel_time(summary, fragment):
    """``(launches, seconds)`` of the device operations whose name holds
    ``fragment``."""
    count, seconds = 0, 0.0
    for name, (n, s) in summary['ops'].items():
        if fragment in name:
            count += n
            seconds += s
    return count, seconds
