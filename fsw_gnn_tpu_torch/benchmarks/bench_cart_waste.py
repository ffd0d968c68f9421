"""Cartesian K4 against the sort route at narrow slice counts.

Counterpart of benchmarks/bench_cart_waste.py.  On the TPU a slice count S
below 128 wasted lanes of the kernel's tiles ('waste' = 128 / S); K4 on the
card runs a block per row and slice tile with no lane padding, so the
waste column is kept only to name the JAX script's cells.  At each S in
CART_S_LIST (CART_R rows of CART_B entries, CART_F frequencies; P normal,
a fifth of the weights zero; seed 0), forward + backward of
sum(sin(out)) in three variants: K4 with with_dw (gradients of P, the
weights, the phantom mass, the frequencies), K4 without (P and the
frequencies), the sort route (all four); ms by CUDA events, the median of
CART_CALLS windows of CART_STEPS steps.  bench_cart_dw gives the S = 128
point.

CART_DIFF=1 asked the JAX script for an N-against-1 differenced time, to
cancel each call's dispatch over the TPU's link; CUDA events time the
card's work alone, so it does not apply and prints a line saying so.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_cart_waste [--device cpu]

Knobs (the JAX script's, with its defaults): CART_R 8192, CART_B 32,
CART_F 8, CART_STEPS 10, CART_CALLS 3, CART_S_LIST 16,48, CART_DIFF
(unset).
"""
from __future__ import annotations

import os

import numpy as np

from . import _timing
from .bench_cart_dw import (ALL, P_AND_F, cart_args, cart_cfg, kernel, on,
                            sort_route, step_fn)

R = int(os.environ.get('CART_R', 8192))
B = int(os.environ.get('CART_B', 32))
F = int(os.environ.get('CART_F', 8))
STEPS = int(os.environ.get('CART_STEPS', 10))
CALLS = int(os.environ.get('CART_CALLS', 3))
S_LIST = [int(s) for s in os.environ.get('CART_S_LIST', '16,48').split(',')]
DIFF = os.environ.get('CART_DIFF') == '1'
VARIANTS = (('kernel dw', kernel(True), ALL),
            ('kernel nodw', kernel(False), P_AND_F),
            ('sort', sort_route, ALL))


def setup(dev, s_list=S_LIST, R=R, B=B, F=F):
    """The JAX script's draws from default_rng(0), one S after the other:
    {S: (P, wn, pad, freqs) on `dev`}."""
    rng = np.random.default_rng(0)
    return {S: on(dev, cart_args(rng, R, B, S, F)) for S in s_list}


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_cart_waste')
    key = _timing.time_key(dev)
    if DIFF:
        _timing.emit(dev, knob='CART_DIFF', applies=False,
                     why='CUDA events time the card alone; there is no '
                         "per-call dispatch to difference away")
    rows = {}
    for S, args in setup(dev).items():
        cfg = cart_cfg(S, F)
        for name, fn, which in VARIANTS:
            ms = _timing.median_ms(step_fn(fn, args, cfg, which), dev,
                                   iters=STEPS, reps=CALLS)
            rows[f'S={S} {name}'] = ms
            _timing.emit(dev, S=S, waste=128 / S, variant=name,
                         **{f'fwd_bwd_{key}': ms})
    return rows


if __name__ == '__main__':
    main()
