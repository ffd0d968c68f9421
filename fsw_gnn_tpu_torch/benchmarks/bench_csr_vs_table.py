"""Forward + backward of the CSR path against the bucketed table paths.

Counterpart of benchmarks/bench_csr_vs_table.py, on its random graph (8192
nodes, 16 draws an edge a node, self loops dropped; seed 0), d_in 64,
d_out 128 (128 slices and frequencies, no bias), gradients of the sum of
the output in X and the slice vectors:

    csr_fwd_bwd           `fsw_embed_graph` on the CSR Graph: the projections
                          gathered to the edges, the int64-key segmented
                          sort, K3 (the row form) and the trig
    table_fwd_bwd         `fsw_embed_table` on one table as wide as the
                          largest in-degree
    multi_table_fwd_bwd   `fsw_embed_multi_table` on the degree classes

(the JAX script's docstring names the CSR path, its cases only the two
table paths; here all three run).  On the card the tables take the route
'auto' picks (K1f / K1b on these classes).  Each case: ms (CUDA events,
median of 5 windows of FSW_CT_ITERS calls) and edges/s.  Then the CSR and the
`multi` outputs, and the gradients, against each other: the output must
agree within TOL_REL of its scale (the script raises after the line); the
gradients' largest differences are printed (a near-tie that the two
routes order apart moves a gradient entry, not the output).

    python -m fsw_gnn_tpu_torch.benchmarks.bench_csr_vs_table [--device cpu]

The JAX script has no knobs; FSW_CT_ITERS (10, the JAX script's count)
sets the calls a window here.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..embedding import (FSWConfig, fsw_embed_graph, fsw_embed_multi_table,
                         fsw_embed_table)
from ..graph import from_edge_index, to_multi_table, to_neighbor_table
from . import _timing

N_NODES, AVG_DEG = 8192, 16
ITERS = int(os.environ.get('FSW_CT_ITERS', 10))
D_IN, D_OUT = 64, 128
TOL_REL = 1e-4


def random_edges(rng, n, avg_deg):
    """The JAX scripts' random edges: n * avg_deg (src, dst) draws, self
    loops dropped; (2, E)."""
    E0 = n * avg_deg
    src = rng.integers(0, n, E0)
    dst = rng.integers(0, n, E0)
    keep = src != dst
    return np.stack([src[keep], dst[keep]])


def random_graph(rng, n, avg_deg, dtype=np.float32):
    """`random_edges` as a CSR Graph."""
    return from_edge_index(random_edges(rng, n, avg_deg), n, dtype=dtype)


def normal32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def freqs32(rng, n):
    """|normal| + 0.1 in float32 arithmetic, as jnp.abs(f32) + 0.1."""
    return np.abs(normal32(rng, n)) + np.float32(0.1)


def setup(dev):
    """The JAX script's graph (N_NODES, AVG_DEG, read at call time),
    table, MultiTable, features, slices and frequencies (default_rng(0)),
    on `dev`."""
    rng = np.random.default_rng(0)
    g = random_graph(rng, N_NODES, AVG_DEG)
    t = to_neighbor_table(g)
    X = normal32(rng, (N_NODES, D_IN))
    cfg = FSWConfig(d_in=D_IN, d_out=D_OUT, enable_bias=False)
    proj = normal32(rng, (cfg.nSlices, D_IN))
    freqs = freqs32(rng, cfg.nFreqs)
    mt = to_multi_table(g)
    put = lambda a: torch.from_numpy(a).to(dev)
    return g.to(dev), t.to(dev), mt.to(dev), put(X), cfg, put(proj), \
        put(freqs)


def fwd_bwd(embed):
    """(output, dX, dproj) of embed(X, proj).sum()."""
    def run(X, proj):
        X = X.detach().requires_grad_(True)
        proj = proj.detach().requires_grad_(True)
        out = embed(X, proj)
        dX, dp = torch.autograd.grad(out.sum(), (X, proj))
        return out.detach(), dX, dp
    return run


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_csr_vs_table')
    key = _timing.time_key(dev)
    g, t, mt, X, cfg, proj, freqs = setup(dev)
    _timing.emit(dev, multi_classes=[int(tb.bucket_size) for tb in mt.tables],
                 rows=[int(tb.num_recipients) for tb in mt.tables],
                 table_bucket=int(t.bucket_size), edges=g.num_edges)
    cases = {
        'csr_fwd_bwd': fwd_bwd(lambda x, p: fsw_embed_graph(
            x, g, p, freqs, cfg)),
        'table_fwd_bwd': fwd_bwd(lambda x, p: fsw_embed_table(
            x, t, p, freqs, cfg)),
        'multi_table_fwd_bwd': fwd_bwd(lambda x, p: fsw_embed_multi_table(
            x, mt, p, freqs, cfg)),
    }
    outs, rows = {}, {}
    for name, fn in cases.items():
        outs[name] = fn(X, proj)
        ms = _timing.median_ms(lambda: fn(X, proj), dev, iters=ITERS, reps=5)
        rows[name] = {'case': name, key: ms}
        if dev.type == 'cuda':
            rows[name]['edges_per_s'] = g.num_edges / (ms * 1e-3)
        _timing.emit(dev, **rows[name])
    a, b = outs['csr_fwd_bwd'], outs['multi_table_fwd_bwd']
    rel = [float((u - v).abs().max() / (1e-6 + v.abs().max()))
           for u, v in zip(a, b)]
    ok = rel[0] < TOL_REL
    check = {'csr_vs_multi_rel_err': rel[0], 'tol_rel': TOL_REL, 'ok': ok,
             'dX_rel_diff': rel[1], 'dproj_rel_diff': rel[2]}
    if dev.type == 'cuda':
        check['csr_over_multi'] = (rows['csr_fwd_bwd'][key]
                                   / rows['multi_table_fwd_bwd'][key])
    _timing.emit(dev, **check)
    if not ok:
        raise RuntimeError(f'the CSR and multi-table outputs differ by '
                           f'{rel[0]:.3e} of the scale (tolerance {TOL_REL})')
    rows['check'] = check
    return rows


if __name__ == '__main__':
    main()
