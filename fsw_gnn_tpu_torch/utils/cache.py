"""One CUDA graph per route and input shape, with a monotone count; and
where the kernels' builds persist.

Counterpart of `CountingJit` (fsw_gnn_tpu/utils/cache.py), which compiles
one XLA executable per (structure, shapes, dtypes) key and counts its own
compiles.  Here the unit of reuse is a captured `torch.cuda.CUDAGraph`:
the whole forward of one route is enqueued once, at capture, and every
later call replays it with one launch from the host.

`enable_compilation_cache` is the counterpart of the JAX package's
persistent XLA cache: it moves the kernels' hash-named builds (nvcc's and
the host compiler's) from the package's `_build/` to a directory of the
caller's, for a read-only install.  It is also exposed as `cli train
--compilation-cache DIR` and `TrainConfig(compilation_cache=...)`.
"""
from __future__ import annotations

import gc
import os
import threading

import torch


class _Captured:
    """One route's graph over static input and output buffers."""

    def __init__(self, fn, args, device, stream):
        self.stream = stream
        self.inputs = [torch.empty_like(a, device=device) for a in args]
        self._copy_in(args)
        # warm up on the capture stream: lazy set-up (libraries, handles,
        # K3's workspace for this stream) must happen outside the capture
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        # a cyclic garbage collection inside the capture may destroy an
        # older graph, whose destructor calls into CUDA and so invalidates
        # the capture in progress: collect first, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.output = fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        if not isinstance(self.output, torch.Tensor):
            raise TypeError('a captured function must return one tensor')

    def _copy_in(self, args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src, non_blocking=True)

    def __call__(self, args):
        self._copy_in(args)
        self.graph.replay()
        # the output buffer is rewritten by the next replay
        return self.output.clone()


class CountingGraph:
    """Runs `fns[route](*tensors)` with one capture per (route, input
    shapes and dtypes) key, and counts the captures in `num_compiles`
    (monotone: one more on each new key, never less).

    On the card the first call of a key warms the function up once on a
    side stream of this object (its kernel launches run and count there),
    captures a `torch.cuda.CUDAGraph` of it on that stream over static
    input buffers, and keeps it; every call of the key copies its inputs
    into those buffers (a host tensor, pinned, without blocking), replays
    the graph on the current stream and returns a copy of the output
    buffer, which the next replay rewrites.  A capture that fails raises:
    nothing falls back to running eagerly.  Calls are serialised by a lock
    (the buffers are shared), and two threads racing a cold key capture it
    once.  The graphs of one object share K3's workspace of its stream,
    which is safe for any order of replays that do not overlap.

    On the CPU, and with capture=False on the card, every call runs
    `fns[route]` eagerly on its inputs moved to `device` and counts the
    same keys, so `num_compiles` reads as it does with graphs."""

    def __init__(self, fns: dict, device, capture: bool = True):
        self._fns = dict(fns)
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == 'cuda'
        self._graphs = {}
        self._stream = None
        self._lock = threading.Lock()
        self.num_compiles = 0

    @staticmethod
    def _key(route, args):
        return route, tuple((tuple(a.shape), a.dtype) for a in args)

    def __call__(self, route, *args):
        key = self._key(route, args)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(route, args)
                self._graphs[key] = entry
                self.num_compiles += 1
            return entry(args)

    def _capture(self, route, args):
        fn = self._fns[route]
        if not self.capture:
            return lambda a: fn(*(t.to(self.device, non_blocking=True)
                                  for t in a))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return _Captured(fn, args, self.device, self._stream)


def enable_compilation_cache(path: str = '~/.cache/fsw_gnn_tpu_torch/build'
                             ) -> str:
    """Build and load the kernels' libraries (`kernels.build`, `load`,
    `load_host`) in `path` (created if missing) from now on, instead of
    the package's `_build/`: each library's file name carries a hash of
    its sources and flags, so a build made there once serves every later
    process.  Libraries already loaded stay loaded.  Returns the resolved
    path."""
    from pathlib import Path

    from .. import kernels

    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    kernels.BUILD_DIR = Path(path)      # read by every build and load
    return path
