"""The trace reader on a hand-made Chrome trace."""
from __future__ import annotations

import pytest

from portbench import trace


def ev(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


def test_busy_idle_and_gaps():
    events = [ev(trace.WINDOW, 'user_annotation', 100, 100),
              ev('k1', 'kernel', 90, 20),           # clipped to 100..110
              ev('k2', 'kernel', 105, 10),          # overlaps k1
              ev('copy', 'gpu_memcpy', 150, 10),
              ev('cudaGraphLaunch', 'cuda_runtime', 112, 30),
              ev('outside', 'kernel', 300, 10)]
    t = trace.parse(events)
    # from the first device operation in the range to the end of the last
    assert t['window_s'] == pytest.approx(60e-6)    # 100..160
    assert t['busy_s'] == pytest.approx(25e-6)      # 100..115, 150..160
    # one gap, 115..150, under a graph launch; none after the copy
    assert [g[0] for g in t['gaps']] == ['cudaGraphLaunch']
    assert [g[1] for g in t['gaps']] == [pytest.approx(35e-6)]
    assert trace.top_ops(t['kernels'])[0] == ['k1', pytest.approx(10e-6)]
    assert trace.device_s(t['kernels'], ('k',)) == pytest.approx(20e-6)


def test_window_starts_at_the_first_device_operation():
    """A late first operation (the drain and the profiler's start before
    it) is not idle time of the program."""
    events = [ev(trace.WINDOW, 'user_annotation', 0, 1000),
              ev('k', 'kernel', 600, 100), ev('k', 'kernel', 700, 100)]
    t = trace.parse(events)
    assert t['window_s'] == pytest.approx(200e-6)
    assert t['busy_s'] == pytest.approx(200e-6)
    assert t['gaps'] == []


def test_a_range_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        trace.parse([ev(trace.WINDOW, 'user_annotation', 0, 1000)])
