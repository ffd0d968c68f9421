"""The MultiTable embedding step (the headline path) by stages.

Counterpart of benchmarks/bench_table_breakdown.py, on its random graph
(seed 0; FSW_BD_NODES nodes, FSW_BD_DEG draws an edge a node, self loops
dropped) in the degree-class `MultiTable` layout, d_in FSW_BD_DIN,
FSW_BD_EMBED slices (unit rows), no bias:

    a_gather           every class's raw rows X[idx] (R, B, D)
    b_gather_rank_fwd  + `fsw_rank_aggregate_proj` forward on each class
                       (K1f; with_dw off, as the production path)
    c_embed_fwd        the whole `fsw_embed_multi_table` forward
                       (weights_grad=False)
    d_embed_fwd_bwd    its forward and backward in X of sum(sin(out))
                       (K1b)
    e_conv_step        FSWConv(D, D, mlp_layers=3) forward, backward of
                       sum(out^2) and an SGD(1e-3) step

Differences between consecutive stages price each piece.  Each stage is
timed by CUDA events over windows of FSW_BD_STEPS calls (the JAX script's
scan of STEPS steps, differenced against one), the median of FSW_BD_CALLS
windows.  On the card each stage's line also gives every window and
`host_enqueue_ms`, the host's time to issue one call (`_timing.enqueue_ms`):
a stage whose enqueue exceeds its device time and whose window holds more
launches than the card's launch queue (the FSWConv step's many short
kernels) is host-bound: its windows read the host's rate in part and
move with the host's load.  This is a breakdown, not the benchmark:
(e) prints beside the others and has no `vs_baseline`.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_table_breakdown [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_BD_NODES 8192,
FSW_BD_DEG 16, FSW_BD_DIN 64, FSW_BD_EMBED 128, FSW_BD_STEPS 20,
FSW_BD_CALLS 3.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..conv import FSWConv
from ..embedding import FSWConfig, fsw_embed_multi_table, lowclamp
from ..graph import to_multi_table
from ..ops.fsw_rank import fsw_rank_aggregate_proj
from . import _timing
from .bench_csr_vs_table import freqs32, normal32, random_graph

N_NODES = int(os.environ.get('FSW_BD_NODES', 8192))
AVG_DEG = int(os.environ.get('FSW_BD_DEG', 16))
D_IN = int(os.environ.get('FSW_BD_DIN', 64))
EMBED = int(os.environ.get('FSW_BD_EMBED', 128))
STEPS = int(os.environ.get('FSW_BD_STEPS', 20))
CALLS = int(os.environ.get('FSW_BD_CALLS', 3))


def setup(dev, n_nodes=N_NODES, avg_deg=AVG_DEG, d_in=D_IN, embed=EMBED):
    """The JAX script's graph, MultiTable, features, unit slice rows and
    frequencies (default_rng(0)), on `dev`."""
    rng = np.random.default_rng(0)
    g = random_graph(rng, n_nodes, avg_deg)
    mt = to_multi_table(g)
    X = normal32(rng, (n_nodes, d_in))
    cfg = FSWConfig(d_in=d_in, d_out=embed, enable_bias=False)
    proj = normal32(rng, (cfg.nSlices, d_in))
    proj = proj / np.linalg.norm(proj, axis=1, keepdims=True)
    freqs = freqs32(rng, cfg.nSlices)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return g, mt.to(dev), put(X), cfg, put(proj), put(freqs)


def stages(mt, X, cfg, proj, freqs):
    """The first four stages as functions of no argument."""
    D = X.shape[1]
    V = proj.t().contiguous()
    th = cfg.total_mass_pad_thresh

    def gather_all(X):
        return [X.index_select(0, t.idx.reshape(-1)).reshape(
            t.idx.shape + (D,)) for t in mt.tables]

    def agg_fwd(X):
        outs = []
        for t, Z in zip(mt.tables, gather_all(X)):
            w = t.weight
            w_sum = w.sum(-1)
            wsp = lowclamp(w_sum, th)
            pad = lowclamp(th - w_sum, 0.0) / wsp
            outs.append(fsw_rank_aggregate_proj(
                Z, (w / wsp[:, None]).contiguous(), pad.contiguous(), freqs,
                V, uniform_w=False, with_dw=False))
        return outs

    def embed_fwd(X):
        return fsw_embed_multi_table(X, mt, proj, freqs, cfg,
                                     weights_grad=False)

    def embed_fwd_bwd():
        Xg = X.detach().requires_grad_(True)
        return torch.autograd.grad(torch.sin(embed_fwd(Xg)).sum(), Xg)[0]

    return {'a_gather': lambda: gather_all(X),
            'b_gather_rank_fwd': lambda: agg_fwd(X),
            'c_embed_fwd': lambda: embed_fwd(X),
            'd_embed_fwd_bwd': embed_fwd_bwd}


def conv_step(mt, X, dev):
    """(e): FSWConv(D, D, mlp_layers=3) forward + backward of sum(out^2)
    + SGD(1e-3), as a function of no argument."""
    D = X.shape[1]
    model = FSWConv(D, D, mlp_layers=3, minimize_slice_coherence=False,
                    device=dev, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        out = model(X, mt)
        (out * out).sum().backward()
        opt.step()
    return step


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_table_breakdown')
    key = _timing.time_key(dev)
    g, mt, X, cfg, proj, freqs = setup(dev)
    fns = stages(mt, X, cfg, proj, freqs)
    fns['e_conv_step'] = conv_step(mt, X, dev)
    results = {}
    for name, fn in fns.items():
        ts = _timing.windows_ms(fn, dev, iters=STEPS, reps=CALLS)
        results[name] = _timing.median(ts)
        extra = {}
        if dev.type == 'cuda':
            extra = {'windows_ms': ts,
                     'host_enqueue_ms': _timing.enqueue_ms(fn, dev)}
        _timing.emit(dev, stage=name, **{key: results[name]}, **extra)
    _timing.emit(dev, edges=g.num_edges,
                 classes=[int(t.bucket_size) for t in mt.tables],
                 **{f'stages_{key}': results})
    return results


if __name__ == '__main__':
    main()
