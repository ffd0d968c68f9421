"""K2 (the rank kernels on pre-gathered projections) against the sort route,
forward and forward + backward.

Counterpart of benchmarks/bench_rank_kernel.py.  On P (R, B, S) normal,
weights |normal| normalized by max(total, 1) and the phantom mass:

    kernel_fwd, kernel_fwd_bwd   `fsw_rank_aggregate` (K2f, K2b)
    sort_fwd, sort_fwd_bwd       the JAX script's `xla_fwd`: a stable sort
                                 of P along B carrying the weights
                                 (`ops.segment.sort_pairs_fused`), the
                                 cumsum, the shift and the quadrature

The backward takes the gradients of P and the frequencies of sum(out * V),
and of the weights and the phantom mass too with BRK_DW=1.  A last line
times K2's forward + backward with those gradients against without them in
turns in one process (`kernel_fwd_bwd_dw_aba`, A B B A a window), the pair
that separate runs cannot order.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_rank_kernel [--device cpu]

Knobs (the JAX script's, with its defaults): BRK_R 8192, BRK_B 32,
BRK_S 128, BRK_STEPS 20 (calls a timing window), BRK_CALLS 3 (windows;
the median is kept), BRK_DW 1, BRK_TILE (read; K2's blocks have one row).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..ops.fsw_rank import fsw_rank_aggregate
from ..ops.segment import sort_pairs_fused
from . import _timing

R = int(os.environ.get('BRK_R', 8192))
B = int(os.environ.get('BRK_B', 32))
S = int(os.environ.get('BRK_S', 128))
STEPS = int(os.environ.get('BRK_STEPS', 20))
CALLS = int(os.environ.get('BRK_CALLS', 3))
TILE = os.environ.get('BRK_TILE')
TILE = int(TILE) if TILE else None
WITH_DW = os.environ.get('BRK_DW', '1') != '0'


def sort_fwd(P, wn, pad, freqs):
    """The JAX script's `xla_fwd`."""
    keys = P.transpose(1, 2)
    ps, ws = sort_pairs_fused(keys, wn[:, None, :].expand(keys.shape))
    c = torch.cumsum(ws, dim=2) + pad[:, None, None] * (ps > 0)
    f = freqs[None, :, None]
    sd = 2.0 * ws * torch.sinc(f * ws) * torch.cos(
        math.pi * f * (2.0 * c - ws))
    return (1.0 + freqs) * torch.sum(ps * sd, dim=2)


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_rank_kernel')
    key = _timing.time_key(dev)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    P = t(rng.standard_normal((R, B, S)))
    w = np.abs(rng.standard_normal((R, B))).astype(np.float32)
    w_sum = w.sum(1)
    wn = t(w / np.maximum(w_sum, 1.0)[:, None])
    pad = t(np.maximum(1.0 - w_sum, 0.0) / np.maximum(w_sum, 1.0))
    freqs = t(np.abs(rng.standard_normal(S)) + 0.1)
    V = t(rng.standard_normal((R, S)))

    def krn_fwd(P, wn, pad, freqs):
        return fsw_rank_aggregate(P, wn, pad, freqs, with_dw=WITH_DW)

    with torch.no_grad():
        err = float((krn_fwd(P, wn, pad, freqs)
                     - sort_fwd(P, wn, pad, freqs)).abs().max())
    _timing.emit(dev, fwd_max_abs_diff_kernel_vs_sort=err, with_dw=WITH_DW,
                 tile_not_used=TILE)

    grads = [P, freqs] + ([wn, pad] if WITH_DW else [])
    leaves = {id(x): x.clone().requires_grad_(True) for x in grads}

    def arg(x):
        return leaves.get(id(x), x)

    def run(fn, grad):
        if not grad:
            return lambda: fn(P, wn, pad, freqs)
        args = [arg(x) for x in (P, wn, pad, freqs)]
        return lambda: torch.autograd.grad((fn(*args) * V).sum(),
                                           list(leaves.values()))

    results = {}
    for name, fn, grad in (('kernel_fwd', krn_fwd, False),
                           ('kernel_fwd_bwd', krn_fwd, True),
                           ('sort_fwd', sort_fwd, False),
                           ('sort_fwd_bwd', sort_fwd, True)):
        with torch.set_grad_enabled(grad):
            ms = _timing.median_ms(run(fn, grad), dev, iters=STEPS,
                                   reps=CALLS)
        results[name] = ms
        fields = {'case': name, 'R': R, 'B': B, 'S': S, 'with_dw': WITH_DW,
                  key: ms}
        if dev.type == 'cuda':
            fields['entries_per_s'] = R * B / (ms * 1e-3)
        _timing.emit(dev, **fields)

    def fwd_bwd(with_dw):
        xs = [x.clone().requires_grad_(x is P or x is freqs or with_dw)
              for x in (P, wn, pad, freqs)]
        need = [x for x in xs if x.requires_grad]
        return lambda: torch.autograd.grad(
            (fsw_rank_aggregate(*xs, with_dw=with_dw) * V).sum(), need)

    turns = _timing.aba_ms({'dw': fwd_bwd(True), 'nodw': fwd_bwd(False)},
                           dev, iters=STEPS, reps=CALLS)
    results.update({f'kernel_fwd_bwd_{k}_aba': _timing.median(ts)
                    for k, ts in turns.items()})
    _timing.emit(dev, case='kernel_fwd_bwd_dw_aba', R=R, B=B, S=S,
                 **{f'{k}_{key}': _timing.median(ts) for k, ts in
                    turns.items()},
                 **{f'all_{k}_{key}': ts for k, ts in turns.items()})
    return results


if __name__ == '__main__':
    main()
