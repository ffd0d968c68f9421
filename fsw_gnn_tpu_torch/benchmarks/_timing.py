"""The timing protocol of the port's benchmark scripts: the counterpart of
benchmarks/_timing.py.

Every timed region starts from a drained stream (`torch.cuda.synchronize()`)
and is timed with CUDA events recorded on the stream around `iters`
back-to-back calls; a time is the median over `reps` such windows.  A
sleep kernel queued before the first event keeps the card busy while the
host enqueues the window (three times the host's time for its calls, at
least 2 ms, at most SLEEP_MAX_S), so no call waits for the host and a
kernel shorter than its Python call is timed, not the host.  The
JAX protocol ends each region with a value readback because a TPU's
`block_until_ready` could return before the work retired; on the card an
event's `elapsed_time` is read only after `synchronize()` on the end
event, which returns once every kernel queued before it has finished, so
no readback is needed.  Functions compared are timed in one process in
turns (A B B A a rep for two: `aba_ms`), the only comparison that two
separate runs, which may land on different cards, cannot spoil.

On the CPU (`--device cpu`) the same functions time with the host clock;
the scripts then print those times as `cpu_ms`, never as a device time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

SLEEP_HZ = 2e9          # cycles a second: at least the SM clock
SLEEP_MAX_S = 1.0


def parse_device(argv=None, description: str = '') -> torch.device:
    """The script's `--device` (default: the card).  Asking for the card
    where there is none raises."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         '(the plain versions of the kernels)')
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass --device '
                               'cpu to run the plain versions on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


_CARD: dict = {}


def smi_line():
    """The first card's 'name, power.limit' line as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints it, or None
    where nvidia-smi does not answer."""
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return smi[0].strip() if smi else None


def card(dev: torch.device) -> dict:
    """{'device': the card's name, 'power_limit': nvidia-smi's limit} (on
    the CPU: 'cpu' and None), looked up once."""
    if dev.type != 'cuda':
        return {'device': 'cpu', 'power_limit': None}
    if not _CARD:
        line = smi_line()
        _CARD.update(device=torch.cuda.get_device_name(dev),
                     power_limit=line.split(',')[-1].strip() if line
                     else None)
    return dict(_CARD)


def time_key(dev: torch.device) -> str:
    """'ms' for the card's times, 'cpu_ms' for the host's."""
    return 'ms' if dev.type == 'cuda' else 'cpu_ms'


def emit(dev: torch.device, **fields):
    """Print one JSON line with the card's name and power limit."""
    print(json.dumps({**fields, **card(dev)}), flush=True)


def announce(dev: torch.device, script: str):
    """The first line: which device runs, and on the CPU that the plain
    versions stand in for the kernels."""
    if dev.type == 'cuda':
        emit(dev, script=script, runs='the CUDA kernels on the card')
    else:
        emit(dev, script=script,
             runs='the plain PyTorch versions on the CPU (no kernel); '
                  'times are the host clock (cpu_ms)')


def drain(dev: torch.device):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _host_s(fn) -> float:
    """The host's seconds for one call of fn (its enqueue on the card)."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _window_ms(fn, iters: int, dev: torch.device, host_s: float = 0.0
               ) -> float:
    if dev.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_HZ * min(max(2e-3, 3 * iters * host_s),
                                         SLEEP_MAX_S)))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _cpu_window(dev, iters, reps):
    """On the CPU a run checks the control flow, not a speed: one window
    of at most two calls."""
    return (iters, reps) if dev.type == 'cuda' else (min(iters, 2), 1)


def windows_ms(fn, dev: torch.device, iters: int = 20, reps: int = 5
               ) -> list:
    """The mean ms of `iters` calls of fn in each of `reps` windows, each
    window from a drained stream, after one warm-up call."""
    iters, reps = _cpu_window(dev, iters, reps)
    fn()
    host = _host_s(fn)
    ts = []
    for _ in range(reps):
        drain(dev)
        ts.append(_window_ms(fn, iters, dev, host))
    return ts


def median_ms(fn, dev: torch.device, iters: int = 20, reps: int = 5) -> float:
    """Median over `reps` windows of the mean ms of `iters` calls of fn
    (`windows_ms`)."""
    return median(windows_ms(fn, dev, iters, reps))


def aba_ms(fns: dict, dev: torch.device, iters: int = 20,
           reps: int = 5) -> dict:
    """{name: [ms of each turn]} of functions timed in turns, forward then
    back a rep (A B B A for two, A B C C B A for three), each window from a
    drained stream, after one warm-up call each."""
    order = list(fns.items())
    iters, reps = _cpu_window(dev, iters, reps)
    for _, fn in order:
        fn()
    host = {name: _host_s(fn) for name, fn in order}
    out = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in order + order[::-1]:
            drain(dev)
            out[name].append(_window_ms(fn, iters, dev, host[name]))
    return out


def enqueue_ms(fn, dev: torch.device, reps: int = 5) -> float:
    """The host clock's median ms to issue one call of fn on a drained
    stream: its enqueue, not its run.  A window's sleep kernel lets the
    host run ahead of the card only as far as the card's launch queue
    holds: a call whose enqueue exceeds its device time keeps a
    device-timed window while the window's launches fit in that queue;
    beyond it the window reads the host's rate in part."""
    ts = []
    for _ in range(reps):
        drain(dev)
        ts.append(1e3 * _host_s(fn))
    drain(dev)
    return median(ts)


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def host_ms(fn, dev: torch.device, reps: int) -> list:
    """The host clock's ms of each of `reps` calls of fn, each ended by a
    synchronize (on the card), after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        drain(dev)
        t0 = time.perf_counter()
        fn()
        drain(dev)
        ts.append(1e3 * (time.perf_counter() - t0))
    return ts


def spread(ts) -> dict:
    """{p50, p90, min, max}_ms of a list of times (ms): p50 the element at
    n // 2 and p90 at int(0.9 n) of the sorted list, as the JAX serving
    scripts take them."""
    ts = sorted(ts)
    return {'p50_ms': ts[len(ts) // 2], 'p90_ms': ts[int(len(ts) * 0.9)],
            'min_ms': ts[0], 'max_ms': ts[-1]}
