"""The profiler reader on a hand-made timeline."""

import pytest

from portbench import devicetrace


class Event(object):

    def __init__(self, name, device, start, end, thread=1):
        self._v = (name, device, start, end, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[1] else 'DeviceType.CPU'

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def start_thread_id(self):
        return self._v[4]


class Profile(object):

    def __init__(self, events):
        results = type('Results', (), {'events': lambda self: events})()
        self.profiler = type('Profiler', (), {'kineto_results': results})()


def test_busy_time_gaps_and_their_host_operators():
    events = [
        Event(devicetrace.RANGE, False, 0, 100),
        Event(devicetrace.RANGE, True, 0, 100),          # the range mirrored: no work
        Event('aten::conv', False, 5, 40),
        Event('aten::relu', False, 60, 98),
        Event('other thread op', False, 40, 60, thread=2),
        Event('kernel_a', True, 10, 30),
        Event('kernel_b', True, 20, 35),                  # overlaps a
        Event('kernel_a', True, 70, 90),
        Event('before the range', True, -10, -5),
    ]
    summary = devicetrace.summarize(Profile(events))
    assert summary['window_s'] == pytest.approx(100e-9)
    assert summary['busy_s'] == pytest.approx(45e-9)
    assert summary['ops']['kernel_a'] == [2, pytest.approx(40e-9)]
    assert devicetrace.RANGE not in summary['ops']
    gaps = summary['idle_gaps']
    # the gaps: 0-10, 35-70 and 90-100; the longest has no operator of the
    # loop's thread at its middle (52.5), the others are inside conv and relu
    assert gaps[0] == ['no host operator', pytest.approx(35e-9)]
    assert sorted(g[0] for g in gaps[1:]) == ['aten::conv', 'aten::relu']
    assert devicetrace.kernel_time(summary, 'kernel_') == (3, pytest.approx(55e-9))


def test_no_device_activity_reads_as_nothing():
    events = [Event(devicetrace.RANGE, False, 0, 100), Event('aten::add', False, 1, 2)]
    assert devicetrace.summarize(Profile(events)) is None
