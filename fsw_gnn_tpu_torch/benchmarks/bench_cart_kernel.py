"""Cartesian aggregation: the rank kernel K4 against the sort route.

Counterpart of benchmarks/bench_cart_kernel.py.  K4
(`fsw_rank_aggregate_cart`: K4f, K4b) ranks each slice's B entries once and
serves all F frequencies from that; the sort route
(`bucket_quadrature(..., 'sort')`) sorts along B and runs an (R, S, B, F)
quadrature.  At CART_R rows of CART_B entries (P normal, a fifth of the
weights zero; seed 0) and (S, F) in (16, 8), (16, 16), (32, 8), a step is
the forward and the gradient of sum(sin(out)) in P; ms a step by CUDA
events, the median of CART_CALLS windows of CART_STEPS steps (the JAX
script's scan of STEPS steps a call), then the sort route over K4.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_cart_kernel [--device cpu]

Knobs (the JAX script's, with its defaults): CART_R 8192, CART_B 32,
CART_STEPS 20, CART_CALLS 3.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import _timing
from .bench_cart_dw import cart_args, cart_cfg, kernel, on, sort_route

R = int(os.environ.get('CART_R', 8192))
B = int(os.environ.get('CART_B', 32))
STEPS = int(os.environ.get('CART_STEPS', 20))
CALLS = int(os.environ.get('CART_CALLS', 3))
CONFIGS = [(16, 8), (16, 16), (32, 8)]      # (S, F)


def setup(dev, R=R, B=B, configs=CONFIGS):
    """The JAX script's draws from default_rng(0), one config after the
    other: {(S, F): (P, wn, pad, freqs) on `dev`}."""
    rng = np.random.default_rng(0)
    return {(S, F): on(dev, cart_args(rng, R, B, S, F)) for S, F in configs}


def step(fn, args, cfg):
    """The forward and the gradient of sum(sin(out)) in P."""
    P, wn, pad, fq = args

    def run():
        Pc = P.detach().requires_grad_(True)
        out = fn(Pc, wn, pad, fq, cfg)
        return torch.autograd.grad(torch.sin(out).sum(), Pc)[0]
    return run


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_cart_kernel')
    key = _timing.time_key(dev)
    results = {}
    for (S, F), args in setup(dev).items():
        cfg = cart_cfg(S, F)
        for name, fn in (('rank', kernel(True)), ('sort', sort_route)):
            ms = _timing.median_ms(step(fn, args, cfg), dev, iters=STEPS,
                                   reps=CALLS)
            results[f'S={S} F={F} {name}'] = ms
            _timing.emit(dev, S=S, F=F, impl=name, **{f'fwd_bwd_{key}': ms})
    for S, F in CONFIGS:
        a, b = (results[f'S={S} F={F} {name}'] for name in ('rank', 'sort'))
        results[f'S={S} F={F} speedup'] = b / a
        _timing.emit(dev, S=S, F=F, speedup_rank_vs_sort=b / a)
    return results


if __name__ == '__main__':
    main()
