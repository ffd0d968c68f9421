"""Batched point-cloud embedding, forward and forward + backward.

Counterpart of benchmarks/bench_multiset.py: FSW_MS_BATCH multisets of
FSW_MS_N points of dimension FSW_MS_D (normal; weights |normal| + 0.1, or
none with FSW_MS_UNITW=1), FSW_MS_EMBED slices and frequencies, no bias
(seed 0), through `fsw_embed_multiset(..., aggregate=FSW_MS_AGG)`:

    multiset_fwd       the forward (sum of the output)
    multiset_fwd_bwd   the gradients of the output's sum in X and W (X only
                       without weights)

ms by CUDA events (the median of 5 windows of FSW_MS_ITERS calls; the JAX
script's scan of ITERS steps differenced against one), points/s and
embeddings/s.  On the card 'auto' takes a rank kernel (K2) only up to the
H100's width 128 (`embedding._RANK_RULES_BY_KIND`), so at the default
n = 256 it sorts; FSW_MS_AGG=rank runs K2f / K2b at n = 256 (their
shared memory holds it) and 'sort' the sort route.  The first line names
the route taken.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_multiset [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_MS_BATCH 64, FSW_MS_N
256, FSW_MS_D 32, FSW_MS_EMBED 512, FSW_MS_ITERS 20, FSW_MS_AGG auto
(auto | sort | rank), FSW_MS_UNITW 0.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..embedding import FSWConfig, _resolve_aggregate, fsw_embed_multiset
from . import _timing
from .bench_csr_vs_table import freqs32, normal32

BATCH = int(os.environ.get('FSW_MS_BATCH', 64))
N = int(os.environ.get('FSW_MS_N', 256))
D = int(os.environ.get('FSW_MS_D', 32))
EMBED = int(os.environ.get('FSW_MS_EMBED', 512))
ITERS = int(os.environ.get('FSW_MS_ITERS', 20))
AGG = os.environ.get('FSW_MS_AGG', 'auto')
UNIT_W = os.environ.get('FSW_MS_UNITW', '0') == '1'


def setup(dev, batch=BATCH, n=N, d=D, embed=EMBED):
    """The JAX script's X, W, slices and frequencies (default_rng(0)), on
    `dev` (W drawn even where FSW_MS_UNITW drops it)."""
    rng = np.random.default_rng(0)
    cfg = FSWConfig(d_in=d, d_out=embed, enable_bias=False)
    X = normal32(rng, (batch, n, d))
    W = (np.abs(rng.standard_normal((batch, n))) + 0.1).astype(np.float32)
    proj = normal32(rng, (cfg.nSlices, d))
    freqs = freqs32(rng, cfg.nFreqs)
    put = lambda a: torch.from_numpy(a).to(dev)
    return cfg, put(X), put(W), put(proj), put(freqs)


def cases(cfg, X, W, proj, freqs, agg=AGG, unit_w=UNIT_W):
    W = None if unit_w else W

    def embed(x, w):
        return fsw_embed_multiset(x, w, proj, freqs, cfg, aggregate=agg)

    def fwd():
        return embed(X, W).sum()

    def fwd_bwd():
        x = X.detach().requires_grad_(True)
        if W is None:
            return torch.autograd.grad(embed(x, None).sum(), x)[0].sum()
        w = W.detach().requires_grad_(True)
        gx, gw = torch.autograd.grad(embed(x, w).sum(), (x, w))
        return gx.sum() + gw.sum()

    return {'multiset_fwd': fwd, 'multiset_fwd_bwd': fwd_bwd}


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_multiset')
    key = _timing.time_key(dev)
    cfg, X, W, proj, freqs = setup(dev)
    route = _resolve_aggregate(AGG, cfg, N, weights_grad=not UNIT_W,
                               device=dev)
    _timing.emit(dev, aggregate=AGG, route=route, unit_w=UNIT_W,
                 shape=[BATCH, N, D], embed=EMBED)
    points = BATCH * N
    rows = {}
    for name, fn in cases(cfg, X, W, proj, freqs).items():
        ms = _timing.median_ms(fn, dev, iters=ITERS, reps=5)
        rows[name] = {'case': name, key: ms, 'route': route}
        if dev.type == 'cuda':
            rows[name].update(points_per_s=points / (ms * 1e-3),
                              embeddings_per_s=BATCH / (ms * 1e-3))
        _timing.emit(dev, **rows[name])
    return rows


if __name__ == '__main__':
    main()
