"""K1 (the fused-projection rank kernels) against the unfused route (the
projection, the gather of P, K2), forward and forward + backward with the
gather's adjoint.

Counterpart of benchmarks/bench_rank_proj.py:

    unfused:  Xp = X V;  P = Xp[idx] (T, S);  K2f / K2b on P   (S-wide IO)
    fused:    Z = X[idx] (T, D);  K1f / K1b on Z and V          (D-wide IO)

The backward takes the gradients of X and V of sum(out * G), through the
gather's adjoint (PyTorch's index backward), which is what the fused route
targets.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_rank_proj [--device cpu]

Knobs (the JAX script's, with its defaults): BRP_N 8192, BRP_R 8192,
BRP_B 32, BRP_D 64, BRP_S 128, BRP_STEPS 20 (calls a timing window),
BRP_CALLS 3 (windows; the median is kept).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.fsw_rank import fsw_rank_aggregate, fsw_rank_aggregate_proj
from . import _timing

N = int(os.environ.get('BRP_N', 8192))
R = int(os.environ.get('BRP_R', 8192))
B = int(os.environ.get('BRP_B', 32))
D = int(os.environ.get('BRP_D', 64))
S = int(os.environ.get('BRP_S', 128))
STEPS = int(os.environ.get('BRP_STEPS', 20))
CALLS = int(os.environ.get('BRP_CALLS', 3))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_rank_proj')
    key = _timing.time_key(dev)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    X = t(rng.standard_normal((N, D)))
    V = t(rng.standard_normal((D, S)))
    idx = torch.from_numpy(rng.integers(0, N, (R, B))).to(dev)
    w = np.abs(rng.standard_normal((R, B))).astype(np.float32)
    w_sum = w.sum(1)
    wn = t(w / np.maximum(w_sum, 1.0)[:, None])
    pad = t(np.maximum(1.0 - w_sum, 0.0) / np.maximum(w_sum, 1.0))
    freqs = t(np.abs(rng.standard_normal(S)) + 0.1)
    G = t(rng.standard_normal((R, S)))
    flat = idx.reshape(-1)

    def unfused(X, V):
        P = (X @ V)[flat].reshape(R, B, S)
        return fsw_rank_aggregate(P, wn, pad, freqs)

    def fused(X, V):
        Z = X[flat].reshape(R, B, D)
        return fsw_rank_aggregate_proj(Z, wn, pad, freqs, V)

    with torch.no_grad():
        diff = float((unfused(X, V) - fused(X, V)).abs().max())
    _timing.emit(dev, fwd_max_abs_diff_fused_vs_unfused=diff)

    Xg, Vg = X.clone().requires_grad_(True), V.clone().requires_grad_(True)

    def run(fn, grad):
        if grad:
            return lambda: torch.autograd.grad((fn(Xg, Vg) * G).sum(),
                                               (Xg, Vg))
        return lambda: fn(X, V)

    results = {}
    for name, fn, grad in (('unfused_fwd', unfused, False),
                           ('fused_fwd', fused, False),
                           ('unfused_fwd_bwd', unfused, True),
                           ('fused_fwd_bwd', fused, True)):
        with torch.set_grad_enabled(grad):
            ms = _timing.median_ms(run(fn, grad), dev, iters=STEPS,
                                   reps=CALLS)
        results[name] = ms
        _timing.emit(dev, case=name, N=N, R=R, B=B, D=D, S=S, **{key: ms})
    return results


if __name__ == '__main__':
    main()
