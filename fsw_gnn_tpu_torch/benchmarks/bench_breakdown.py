"""The CSR embedding step by stages.

Counterpart of benchmarks/bench_breakdown.py, on its random graph (seed 0;
FSW_BD_NODES nodes, FSW_BD_DEG draws an edge a node, self loops dropped),
d_in FSW_BD_DIN, FSW_BD_EMBED slices, no bias:

    proj_gather        X @ proj^T, gathered to the edges (E, S)
    proj_gather_sort   + each slice's column sorted within the recipients'
                       segments, the weights carried (`segment_argsort` on
                       the (S, E) rows: one int64-key sort)
    embed_fwd          the whole `fsw_embed_graph` forward
    embed_fwd_bwd      its forward and backward in X

Differences between stages price each piece.  `segment_cumsum`'s route on
the card is K3's: the forward's cumulative weights are one call of its row
form (`segcumsum_rows`: the (S, E) rows over the graph's end mask); the
backward in X alone needs no reverse scan (the weights take no gradient).
Each stage's line names its K3 form and counts K3's launches in one call
(`segcumsum.launches`; 0 on the CPU, where the plain version runs).  ms by
CUDA events (median of 5 windows of FSW_BD_ITERS calls), edges/s.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_breakdown [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_BD_NODES 8192,
FSW_BD_DEG 16, FSW_BD_DIN 64, FSW_BD_EMBED 128, FSW_BD_ITERS 10.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..embedding import FSWConfig, fsw_embed_graph
from ..ops.segcumsum import segcumsum
from ..ops.segment import segment_argsort
from . import _timing
from .bench_csr_vs_table import freqs32, normal32, random_graph

N_NODES = int(os.environ.get('FSW_BD_NODES', 8192))
AVG_DEG = int(os.environ.get('FSW_BD_DEG', 16))
D_IN = int(os.environ.get('FSW_BD_DIN', 64))
EMBED = int(os.environ.get('FSW_BD_EMBED', 128))
ITERS = int(os.environ.get('FSW_BD_ITERS', 10))
K3_FORM = {'proj_gather': 'none',
           'proj_gather_sort': 'none (the sort only)',
           'embed_fwd': 'row form (segcumsum_rows over the end mask)',
           'embed_fwd_bwd': 'row form in the forward; no reverse scan '
                            '(no weight gradient)'}


def setup(dev, n_nodes=N_NODES, avg_deg=AVG_DEG, d_in=D_IN, embed=EMBED):
    """The JAX script's graph, features, slices and frequencies
    (default_rng(0)), on `dev`."""
    rng = np.random.default_rng(0)
    g = random_graph(rng, n_nodes, avg_deg)
    X = normal32(rng, (n_nodes, d_in))
    cfg = FSWConfig(d_in=d_in, d_out=embed, enable_bias=False)
    proj = normal32(rng, (cfg.nSlices, d_in))
    freqs = freqs32(rng, cfg.nFreqs)
    put = lambda a: torch.from_numpy(a).to(dev)
    return g.to(dev), put(X), cfg, put(proj), put(freqs)


def stages(g, proj, freqs, cfg):
    """The four stages as functions of X (each returns what it computed)."""
    def proj_gather(X):
        return (X @ proj.t()).index_select(0, g.src)

    def proj_gather_sort(X):
        P = proj_gather(X).t()                          # (S, E)
        perm = segment_argsort(P, g.dst)
        ps = torch.gather(P, 1, perm)
        ws = g.weight[perm]
        return ps.sum() + ws.sum()

    def embed_fwd(X):
        return fsw_embed_graph(X, g, proj, freqs, cfg).sum()

    def embed_fwd_bwd(X):
        X = X.detach().requires_grad_(True)
        return torch.autograd.grad(
            fsw_embed_graph(X, g, proj, freqs, cfg).sum(), X)[0]

    return {'proj_gather': proj_gather, 'proj_gather_sort': proj_gather_sort,
            'embed_fwd': embed_fwd, 'embed_fwd_bwd': embed_fwd_bwd}


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_breakdown')
    key = _timing.time_key(dev)
    g, X, cfg, proj, freqs = setup(dev)
    rows = {}
    for name, fn in stages(g, proj, freqs, cfg).items():
        before = segcumsum.launches
        fn(X)
        k3 = segcumsum.launches - before
        ms = _timing.median_ms(lambda: fn(X), dev, iters=ITERS, reps=5)
        rows[name] = {'stage': name, key: ms, 'k3_form': K3_FORM[name],
                      'k3_launches_a_call': k3}
        if dev.type == 'cuda':
            rows[name]['edges_per_s'] = g.num_edges / (ms * 1e-3)
        _timing.emit(dev, **rows[name])
    return rows


if __name__ == '__main__':
    main()
