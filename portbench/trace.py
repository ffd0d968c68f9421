"""Reading a torch.profiler trace of part of the window: the device's
operations and busy time, its idle gaps, and what the host was doing in
each gap.

The traced part runs inside a `record_function` range named WINDOW that
starts after the device has drained and ends with a synchronise, so every
device operation of the traced calls lies inside it.  The traced window
runs from the first device operation inside the range to the end of the
last: the drain and the profiler's start before it, and the synchronise
after it, are the instrument's and not the program's.  The trace is
written as Chrome trace JSON to a temporary file (in TMPDIR), read and
deleted.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

WINDOW = 'portbench.traced_window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# a run on the CPU (the tests) reads its operators in the device's place
CPU_CATS = ('cpu_op',)
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def read(prof, cats=DEVICE_CATS) -> dict:
    """{'window_s', 'busy_s', 'kernels': [(name, start_us, dur_us)],
    'gaps': [(host activity, seconds)]} of a finished profiler, the
    operations of the categories `cats` counted as the device's."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    finally:
        os.remove(path)
    return parse(events, cats)


def parse(events, cats=DEVICE_CATS) -> dict:
    win = [e for e in events if e.get('name') == WINDOW
           and e.get('ph') == 'X' and e.get('cat') != 'gpu_user_annotation']
    if not win:
        raise RuntimeError('the trace holds no traced window')
    t0 = float(win[0]['ts'])
    t1 = t0 + float(win[0]['dur'])
    kernels = []
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in cats:
            a = max(float(e['ts']), t0)
            b = min(float(e['ts']) + float(e.get('dur', 0.0)), t1)
            if b > a:
                kernels.append((e.get('name', '?'), a, b - a))
    kernels.sort(key=lambda k: k[1])
    if not kernels:
        raise RuntimeError('no device operation ran in the traced window')
    t0 = kernels[0][1]
    t1 = max(a + d for _, a, d in kernels)
    busy, gaps, end = 0.0, [], t0
    for _, a, d in kernels:
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, a + d - max(a, end))
        end = max(end, a + d)
    host = sorted(((float(e['ts']), float(e['ts']) + float(e.get('dur', 0)),
                    e.get('name', '?')) for e in events
                   if e.get('ph') == 'X' and e.get('cat') in HOST_CATS
                   and e.get('name') != WINDOW), key=lambda h: h[0])
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        over = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost host range over the gap's middle
        what = (min(over, key=lambda h: h[1] - h[0])[2] if over
                else 'host: no traced call')
        named.append((what, 1e-6 * (b - a)))
    return {'window_s': 1e-6 * (t1 - t0), 'busy_s': 1e-6 * busy,
            'kernels': kernels, 'gaps': named}


def top_ops(kernels, n=10):
    """[[name, seconds]] of the `n` device operations that took most time,
    summed by name."""
    total = defaultdict(float)
    for name, _, d in kernels:
        total[name] += d
    return [[k, 1e-6 * v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def device_s(kernels, patterns) -> float:
    """Seconds of the device operations whose name holds any pattern."""
    return 1e-6 * sum(d for name, _, d in kernels
                      if any(p in name for p in patterns))
