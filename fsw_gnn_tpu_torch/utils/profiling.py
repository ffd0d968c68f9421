"""Profiling helpers: named ranges, a section timer, a trace.

Counterpart of `fsw_gnn_tpu/utils/profiling.py`.  `named_scope` marks a
stage of the pipeline (`fsw_embed_graph` marks 'fsw_project' and
'fsw_segcumsum', as the JAX embedding does); a range costs nothing while
no profiler runs, and `torch.export` leaves it out of an exported program.
`SectionTimer` times sections on the host clock, waiting for the card
where the results live there.  `trace` records the CPU, and the card where
there is one, with `torch.profiler` and writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch
from torch.utils._pytree import tree_leaves

named_scope = torch.profiler.record_function  # annotate pipeline stages


def _wait_for(result) -> None:
    """Wait for the card on every CUDA device that holds a tensor of
    `result` (any nesting of lists, tuples and dicts); tensors on the CPU
    are ready already."""
    devices = {t.device for t in tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.device.type == 'cuda'}
    for dev in devices:
        torch.cuda.synchronize(dev)


class SectionTimer:
    """Wall-clock section timer that waits for the results it is given."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        """Time the block; with `result`, wait for its tensors' devices
        before the clock stops."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            _wait_for(result)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), timed until its output is ready."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait_for(out)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.records.items():
            out[k] = {'n': len(v), 'total_s': sum(v),
                      'mean_ms': 1e3 * sum(v) / len(v),
                      'min_ms': 1e3 * min(v)}
        return out


@contextlib.contextmanager
def trace(trace_dir: str, device=None):
    """Record the block with `torch.profiler` (the CPU, and CUDA where a
    card is present, or only where `device` is a CUDA device when one is
    given) and write a Chrome trace to `trace_dir/trace.json` (view it in
    chrome://tracing or Perfetto).  Yields the profiler, whose
    `key_averages()` the caller may read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == 'cuda')
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, 'trace.json'))
