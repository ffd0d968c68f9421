"""The cartesian backward with the weights' gradient (with_dw) on the card.

Counterpart of benchmarks/bench_cart_dw.py.  The JAX script measured a
backward split into two pallas_calls (a dc producer and a mask consumer)
to keep its compile short; K4b has no such split: it is one entry kernel
(`rank_bwd_entry_kernel<NF, DW>`, csrc/fsw_rank_common.cuh), the transposed
term a suffix sum in sorted order, and the width a runtime argument.  So:

  1+2) at a small shape (R 64, B 16, S 8, F 4) the gradients of
       sum(sin(K4(P, wn, pad, freqs))) in all four inputs (K4f / K4b with
       with_dw) against the sort route's (`bucket_quadrature(..., 'sort')`)
       on the card, each within TOL_REL of its scale (the script raises
       after the lines otherwise), and the seconds of that first call
       (the kernels' library load);
  3)   forward + backward at the production shape (CART_R rows, CART_B
       entries, CART_S slices, CART_F frequencies; P normal, a fifth of
       the weights zero) of three variants: K4 with with_dw (gradients of
       all four inputs), K4 without (P and the frequencies), the sort
       route (all four); ms by CUDA events, the median of CART_CALLS
       windows of CART_STEPS steps (the JAX script's scan).

    python -m fsw_gnn_tpu_torch.benchmarks.bench_cart_dw [--device cpu]

Knobs (the JAX script's, with its defaults): CART_R 8192, CART_B 32,
CART_S 128, CART_F 8, CART_STEPS 10, CART_CALLS 3.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..embedding import FSWConfig, bucket_quadrature
from ..ops.fsw_rank import fsw_rank_aggregate_cart
from . import _timing

R = int(os.environ.get('CART_R', 8192))
B = int(os.environ.get('CART_B', 32))
S = int(os.environ.get('CART_S', 128))
F = int(os.environ.get('CART_F', 8))
STEPS = int(os.environ.get('CART_STEPS', 10))
CALLS = int(os.environ.get('CART_CALLS', 3))
SMALL = (64, 16, 8, 4)
TOL_REL = 1e-4
NAMES = ('dP', 'dwn', 'dpad', 'dfreqs')


def cart_args(rng, R, B, S, F):
    """The JAX scripts' (P, wn, pad, freqs) in float32: P normal (R, B, S),
    weights |normal| with a fifth zeroed, normalized by max(total, 1), the
    phantom mass, freqs |normal| + 0.1 (S, F)."""
    P = rng.standard_normal((R, B, S)).astype(np.float32)
    w = np.abs(rng.standard_normal((R, B))).astype(np.float32)
    w *= rng.random((R, B)) < 0.8
    ws = w.sum(1)
    wsp = np.maximum(ws, 1.0)
    wn = w / wsp[:, None]
    pad = np.maximum(1.0 - ws, 0.0) / wsp
    freqs = np.abs(rng.standard_normal((S, F))).astype(np.float32) + 0.1
    return P, wn, pad, freqs


def cart_cfg(S, F):
    return FSWConfig(d_in=4, n_slices=S, n_freqs=F, enable_bias=False)


def on(dev, arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def setup(dev, small=SMALL, shape=None):
    """The JAX script's draws from default_rng(0): the small check's
    arguments, then the production shape's, on `dev`."""
    rng = np.random.default_rng(0)
    small_args = on(dev, cart_args(rng, *small))
    big = on(dev, cart_args(rng, *(shape or (R, B, S, F))))
    return small_args, big


def kernel(with_dw):
    def fn(P, wn, pad, fq, cfg):
        return fsw_rank_aggregate_cart(P, wn, pad, fq, with_dw=with_dw)
    return fn


def sort_route(P, wn, pad, fq, cfg):
    return bucket_quadrature(P, wn, pad, fq, cfg, 'sort')


def grads(fn, args, cfg, which):
    """The gradients of sum(sin(fn(*args))) in the inputs `which` (indices
    into (P, wn, pad, freqs))."""
    a = [t.detach().requires_grad_(i in which) for i, t in enumerate(args)]
    loss = torch.sin(fn(*a, cfg)).sum()
    return torch.autograd.grad(loss, [a[i] for i in which])


def step_fn(fn, args, cfg, which):
    return lambda: grads(fn, args, cfg, which)


ALL, P_AND_F = (0, 1, 2, 3), (0, 3)
VARIANTS = (('kernel with_dw=True (one entry kernel)', kernel(True), ALL),
            ('kernel with_dw=False', kernel(False), P_AND_F),
            ('sort path (all grads)', sort_route, ALL))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_cart_dw')
    key = _timing.time_key(dev)
    small, big = setup(dev)
    cfg_s = cart_cfg(SMALL[2], SMALL[3])
    t0 = time.perf_counter()
    gk = grads(kernel(True), small, cfg_s, ALL)
    _timing.drain(dev)
    _timing.emit(dev, stage='small-shape with_dw first call',
                 seconds=time.perf_counter() - t0)
    gs = grads(sort_route, small, cfg_s, ALL)
    bad = []
    errs = {}
    for n, a, b in zip(NAMES, gk, gs):
        err = float((a - b).abs().max() / (1e-6 + b.abs().max()))
        errs[n] = err
        _timing.emit(dev, grad=n, rel_err_vs_sort=err, tol_rel=TOL_REL,
                     ok=err < TOL_REL)
        if not err < TOL_REL:
            bad.append(n)
    if bad:
        raise RuntimeError(f'K4b gradients {bad} differ from the sort route '
                           f'by more than {TOL_REL} of their scale')
    cfg = cart_cfg(S, F)
    rows = {'rel_err_vs_sort': errs}
    for name, fn, which in VARIANTS:
        ms = _timing.median_ms(step_fn(fn, big, cfg, which), dev,
                               iters=STEPS, reps=CALLS)
        rows[name] = ms
        _timing.emit(dev, variant=name, **{f'fwd_bwd_{key}': ms})
    return rows


if __name__ == '__main__':
    main()
