"""The cartesian with_dw backward at the widths above the TPU's cap.

Counterpart of benchmarks/probe_cart_dw_frontier.py.  The JAX script timed
the Mosaic compile of the split with_dw backward at B = 48 and 64, each in
a child process under a wall-clock bound.  K4 has no compile a width: B is
a runtime argument of one built library, and one block of K4b with with_dw
needs `smem_bytes('fsw_rank_cart_bwd', B, F, True)` of shared memory
(21376 bytes at B = 48, 26624 at 64 with F = 8), far under the 232448 a
block can have.  So each child here times its first call (the library's
load and the first launch) and then one forward + backward of
sum(sin(K4(...))) in all four inputs against the sort route
(`bucket_quadrature(..., 'sort')`), ms a step by CUDA events over
CART_STEPS steps.  Each width is reported against the H100's cap of 128 on
the rank route (`embedding._RANK_RULES_BY_KIND`), and with the kernels'
launches in the child; `main` returns the lines and, under 'launches',
the children's launches summed.

Each width runs in its own child process, forked from a fresh server
process (multiprocessing's 'forkserver'), so that neither a CUDA context
nor a thread pool of this process passes into it (a child forked from a
process whose CPU thread pool has run, or that holds a CUDA context, can
hang or fail); a launch that hangs cannot wedge the probe: the parent
waits at most PROBE_TIMEOUT_S and kills the child by its exact PID.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_cart_dw_frontier [--device cpu]

Knobs (the JAX script's, with its defaults): CART_R 8192, CART_S 128,
CART_F 8, CART_BS 48,64, PROBE_TIMEOUT_S 1200, CART_STEPS 10.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time

import numpy as np

from . import _timing

R = int(os.environ.get('CART_R', 8192))
S = int(os.environ.get('CART_S', 128))
F = int(os.environ.get('CART_F', 8))
BUCKETS = [int(b) for b in os.environ.get('CART_BS', '48,64').split(',')]
PROBE_TIMEOUT_S = float(os.environ.get('PROBE_TIMEOUT_S', 1200))
STEPS = int(os.environ.get('CART_STEPS', 10))
H100_CAP = 128


def frontier_args(rng, R, B, S, F):
    """The JAX script's (P, wn, pad, freqs) in float32 (its own draw: the
    frequencies cast after the + 0.1)."""
    P = rng.standard_normal((R, B, S)).astype(np.float32)
    w = np.abs(rng.standard_normal((R, B))).astype(np.float32)
    w *= rng.random((R, B)) < 0.8
    ws = np.maximum(w.sum(1), 1.0)
    wn = w / ws[:, None]
    pad = np.maximum(1.0 - w.sum(1), 0.0) / ws
    fq = (np.abs(rng.standard_normal((S, F))) + 0.1).astype(np.float32)
    return P, wn, pad, fq


def setup(dev, B, R=R, S=S, F=F):
    """One width's arguments (default_rng(0), as each JAX child draws
    them), on `dev`."""
    from .bench_cart_dw import on
    return on(dev, frontier_args(np.random.default_rng(0), R, B, S, F))


def attempt(B, device, q):
    """The child: first call, then a step of K4 and of the sort route."""
    from ..device import resolve_device
    from ..ops import launch_counts, reset_launches
    from ..ops.fsw_rank import smem_bytes
    from .bench_cart_dw import ALL, cart_cfg, kernel, sort_route, step_fn
    dev = resolve_device(device)
    args = setup(dev, B)
    cfg = cart_cfg(S, F)
    key = _timing.time_key(dev)
    reset_launches()
    k4 = step_fn(kernel(True), args, cfg, ALL)
    t0 = time.perf_counter()
    k4()
    _timing.drain(dev)
    q.put({'B': B, 'stage': 'first call',
           'first_call_s': time.perf_counter() - t0,
           'smem_bytes': smem_bytes('fsw_rank_cart_bwd', B, F, True),
           'h100_cap': H100_CAP, 'within_cap': B <= H100_CAP})
    turns = _timing.aba_ms({'k4': k4,
                            'sort': step_fn(sort_route, args, cfg, ALL)},
                           dev, iters=STEPS, reps=1)
    q.put({'B': B, 'stage': 'ran',
           f'step_{key}': _timing.median(turns['k4']),
           f'sort_step_{key}': _timing.median(turns['sort']),
           'launches': {k: v for k, v in launch_counts().items() if v}})


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_cart_dw_frontier')
    ctx = mp.get_context('forkserver')
    msgs = []
    for B in BUCKETS:
        q = ctx.Queue()
        p = ctx.Process(target=attempt, args=(B, dev.type, q))
        p.start()
        deadline = time.time() + PROBE_TIMEOUT_S
        done = False
        while time.time() < deadline and not done:
            try:
                msg = q.get(timeout=1.0)
            except queue_mod.Empty:
                if not p.is_alive():
                    break
                continue
            _timing.emit(dev, **msg)
            msgs.append(msg)
            done = msg.get('stage') == 'ran'
        if not done and p.is_alive():
            p.kill()                               # exact PID, own child
            msg = {'B': B, 'stage': 'TIMEOUT', 'bound_s': PROBE_TIMEOUT_S}
            _timing.emit(dev, **msg)
            msgs.append(msg)
        p.join()
        if not done:
            raise RuntimeError(f'B = {B}: the child did not finish (exit '
                               f'code {p.exitcode})')
    launches = {}
    for msg in msgs:
        for k, v in msg.get('launches', {}).items():
            launches[k] = launches.get(k, 0) + v
    return {'widths': msgs, 'launches': launches}


if __name__ == '__main__':
    main()
