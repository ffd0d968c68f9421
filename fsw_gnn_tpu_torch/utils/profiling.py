"""Profiling helpers: spans and counters, a section timer, a trace.

Counterpart of `fsw_gnn_tpu/utils/profiling.py`, with a recorder of its
own.

Spans.  `span(name, **attrs)` marks a stage of the program on the host
(`named_scope` is the same function, the JAX package's name for it).  A
span is on while a `torch.profiler` records, or inside `recording()`.  An
open span enters a record-function range of its name, so it lands in the
profiler's trace as a `cpu_op` event (torch's `_RecordFunctionFast`, the
range torch's compiled code opens: about 2 us under the profiler, against
15 for `torch.profiler.record_function`, on a CPU; the attributes are the
range's args, which a trace shows with `record_shapes=True`).  On closing
it appends `Span(name, parent, step, t0_ns, t1_ns, attrs)` to a buffer in
memory that keeps the newest MAX_SPANS (65536) spans.  `parent` is the
name of the enclosing open span of the same thread (None at the top);
`step` is the Trainer's `step_count` for every span inside one
`fsw.train.step`, else None.  Off, a span costs one check of the
profiler's state and enters no range; `torch.export` leaves spans out of
an exported program.  The set-up spans (`fsw.setup.*`) run once a process
and are kept always, whether or not recording is on.

The stamps are `time.time_ns()`, the clock of the profiler's Chrome trace:
an event's `ts` plus the trace's `baseTimeNanoseconds` / 1000 is in the
same microseconds, so a span's `t0_ns / 1000` and `t1_ns / 1000` lie just
inside its event (`t0` is taken after the range opens, `t1` before it
closes).

The program's spans:

    fsw.train.step       Trainer.train_epoch, the whole step (step)
      fsw.train.forward, .loss, .backward, .optimizer, .readback
                         the step's parts; .readback is the loss's .item(),
                         which waits for the card
    fsw.wait.<what>      any other call inside a step that waits for the card
    fsw.gnn.layer        FSWGNN.forward, one a conv (layer)
    fsw.conv             FSWConv.forward
    fsw.embed            FSWEmbedding.forward
    fsw.embed.multi_table, fsw.embed.table, fsw.embed.graph
                         each route's entry; fsw.embed.table carries its
                         route ('rank_proj', 'rank' or 'sort'), B and R
    fsw.gather           a table's gather (`gather_rows`, the unfused
                         route's Xp[table.idx])
    fsw.mlp_head         the MLP head
    fsw.setup.first_op   the process's first call into the port's
                         `torch.library` ops (op): the dispatcher's first
                         pass, which later calls skip (`first_op`)
    fsw.setup.kernel_load
                         a kernel library loaded, or built first (library,
                         built)
    fsw_project, fsw_segcumsum
                         the CSR route's two stages (the JAX embedding's
                         named scopes)

Counters are host integers, counted whether or not recording is on, and
not while the current stream captures a CUDA graph (a capture runs
nothing, and a replay passes through no Python).  `count(name, n)` adds,
`gauge_max(name, v)` keeps the largest value.  The program's:

    gather.entries       table entries gathered
    gather.pad_entries   of them, padding (the table's precomputed count)
    gather.hot_row_entries
                         the most entries one sender row takes in a single
                         gather whose source autograd differentiates: the
                         longest run of the index backward's atomics
    launch.<kernel>      the kernels' launch counters (`ops.launch_counts`)

Readers: `spans()` (every recorded span, by start) and `counters()` (one
snapshot of all the counters); `reset()` empties the
buffer and the counters (not the set-up spans, nor the launch counters,
which `ops.reset_launches` resets).  To record outside a profiler:

    with recording():
        trainer.train_epoch()
    steps = [s for s in spans() if s.name == 'fsw.train.step']

`SectionTimer` times sections on the host clock, waiting for the card
where the results live there.  `trace` records the CPU, and the card where
there is one, with `torch.profiler` and writes a Chrome trace.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves

MAX_SPANS = 1 << 16
SETUP = 'fsw.setup.'


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    step: Optional[int]
    t0_ns: int
    t1_ns: int
    attrs: dict


_recording = False
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_setup_spans: List[Span] = []
_open = threading.local()
_counts: Dict[str, int] = {}
_gauges: Dict[str, int] = {}
_profiler_enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The span that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """An open span: a record-function range when `profiled`, and a
    `Span` in memory when it closes."""
    __slots__ = ('name', 'attrs', 'profiled', 'step', 'parent', 'rf', 't0')

    def __init__(self, name, attrs, profiled):
        self.name, self.profiled = name, profiled
        self.step = attrs.pop('step', None)
        self.attrs = attrs

    def __enter__(self):
        stack = _open.__dict__.setdefault('stack', [])
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.step is None and outer is not None:
            self.step = outer.step
        self.rf = None
        if self.profiled:
            # the inputs' list must be given with the keyword values
            self.rf = _range(self.name, [], self.attrs)
            self.rf.__enter__()
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _open.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        done = Span(self.name, self.parent, self.step, self.t0, t1,
                    self.attrs)
        if self.name.startswith(SETUP):
            _setup_spans.append(done)
        else:
            _buffer.append(done)
        return False


def span(name: str, **attrs):
    """A context manager marking a stage (module docstring); `step=` sets
    the step of the span and of every span inside it."""
    on = _recording or _profiler_enabled()
    if on or name.startswith(SETUP):
        return _On(name, attrs, on)
    return _OFF


named_scope = span  # annotate pipeline stages (the JAX package's name)


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording(on: bool = True):
    """Record spans inside the block (or, with on=False, only while a
    profiler records); the previous setting afterwards."""
    global _recording
    before, _recording = _recording, bool(on)
    try:
        yield
    finally:
        _recording = before


def spans() -> List[Span]:
    """The set-up spans and the buffer's, in the order they started."""
    return sorted(_setup_spans + list(_buffer), key=lambda s: s.t0_ns)


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`, unless a CUDA graph is being captured."""
    if not _capturing():
        _counts[name] = _counts.get(name, 0) + int(n)


def gauge_max(name: str, value: int) -> None:
    """Keep the largest value given to `name`, unless a CUDA graph is
    being captured."""
    if not _capturing() and (name not in _gauges or value > _gauges[name]):
        _gauges[name] = int(value)


def counters() -> Dict[str, int]:
    """One snapshot of every counter and gauge, and the kernels' launch
    counters as `launch.<kernel>`."""
    from ..ops import launch_counts
    out = dict(_counts)
    out.update(_gauges)
    out.update((f'launch.{k}', v) for k, v in launch_counts().items())
    return out


def reset() -> None:
    """Empty the span buffer and the counters (module docstring)."""
    _buffer.clear()
    _counts.clear()
    _gauges.clear()


_first_op_done = False


def first_op(op, *args):
    """op(*args); the process's first call runs inside
    `fsw.setup.first_op`, every later one after a flag check.  The public
    functions of `ops/` call their `torch.library` ops through it."""
    global _first_op_done
    if _first_op_done:
        return op(*args)
    _first_op_done = True
    with span(SETUP + 'first_op', op=getattr(op, '_qualname', str(op))):
        return op(*args)


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
