"""Kernel A1 (the sorting-network table forward) against the port's CSR
forward and the table forward on the sort route.

Counterpart of benchmarks/bench_fused_table.py.  On a random graph (seed
0; self loops dropped) whose bucket width B is the max in-degree rounded up
to a power of two, forward only:

    fused_table_fwd   Xp = X proj^T, then A1 (`attic.fsw_table`)
    csr_fwd           `fsw_embed_graph` on the CSR Graph
    table_sort_fwd    `fsw_embed_table(..., aggregate='sort')`

one line each with ms and edges/s, then the three max-abs differences, as
the JAX script prints them.  A1 must agree with the sort route within
RTOL |ref| + ATOL_REL max |ref|, on the graph and at every sweep width,
else the script raises after the line.  Then a sweep of the hub-style widths B = 256,
512 and 1024 at S = 128, R = 2^17 / B rows (the autotune's K2-against-sort
cells; a fifth of the weights zero): A1 against the sort route's
quadrature (`embedding.bucket_quadrature(..., 'sort')`) on the same P, and
against K2f where K2f holds the width.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_fused_table [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_FT_NODES 8192,
FSW_FT_DEG 16, FSW_FT_DIN 64, FSW_FT_EMBED 129 (the slices: 129),
FSW_FT_ITERS 20 (calls a timing window), FSW_FT_INTERPRET 0 (1: the
plain versions stand in for the kernels on any device, the counterpart of
interpret mode).  FSW_FT_TILE_R and FSW_FT_TILE_S are read and do not
apply: A1's block is one row and a slice tile of its own choosing.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..embedding import FSWConfig, bucket_quadrature, fsw_embed_graph, \
    fsw_embed_table, lowclamp
from ..graph import from_edge_index, to_neighbor_table
from ..ops.fsw_rank import fsw_rank_aggregate, misfit
from . import _timing
from .attic.fsw_table import (fsw_table_forward, fsw_table_forward_plain,
                              fsw_table_sort, fsw_table_sort_plain)

N_NODES = int(os.environ.get('FSW_FT_NODES', 8192))
AVG_DEG = int(os.environ.get('FSW_FT_DEG', 16))
D_IN = int(os.environ.get('FSW_FT_DIN', 64))
EMBED = int(os.environ.get('FSW_FT_EMBED', 129))
TILE_R = int(os.environ.get('FSW_FT_TILE_R', 16))
TILE_S = int(os.environ.get('FSW_FT_TILE_S', 128))
ITERS = int(os.environ.get('FSW_FT_ITERS', 20))
INTERPRET = os.environ.get('FSW_FT_INTERPRET', '0') == '1'
SWEEP_B, SWEEP_S, SWEEP_ZERO = (256, 512, 1024), 128, 0.2
SWEEP_ENTRIES = 1 << 17
RTOL, ATOL_REL = 1e-5, 2e-5


def agree(label, got, want):
    """Raise when got is not within RTOL |want| + ATOL_REL max |want| of
    want."""
    tol = RTOL * want.abs() + ATOL_REL * want.abs().max()
    if not bool(torch.all((got - want).abs() <= tol)):
        raise RuntimeError(f'{label}: max abs difference '
                           f'{float((got - want).abs().max()):.3e} above '
                           f'{RTOL} |ref| + {ATOL_REL} max |ref|')


def setup(dev, n_nodes=N_NODES, avg_deg=AVG_DEG, d_in=D_IN, embed=EMBED):
    """The JAX script's graph, table, features, slices and frequencies (seed
    0), and the table's normalized weights and phantom mass."""
    rng = np.random.default_rng(0)
    E0 = n_nodes * avg_deg
    src = rng.integers(0, n_nodes, E0)
    dst = rng.integers(0, n_nodes, E0)
    keep = src != dst
    g = from_edge_index(np.stack([src[keep], dst[keep]]), n_nodes,
                        dtype=np.float32)
    max_deg = int(np.diff(np.asarray(g.row_ptr)).max())
    B = 2
    while B < max_deg:
        B *= 2
    t = to_neighbor_table(g, bucket_size=B)
    X = torch.from_numpy(rng.standard_normal((n_nodes, d_in)).astype(
        np.float32)).to(dev)
    cfg = FSWConfig(d_in=d_in, d_out=embed, enable_bias=False)
    S = cfg.nSlices
    proj = torch.from_numpy(rng.standard_normal((S, d_in)).astype(
        np.float32)).to(dev)
    freqs = torch.from_numpy((np.abs(rng.standard_normal(S)) + 0.1).astype(
        np.float32)).to(dev)
    g, t = g.to(dev), t.to(dev)
    w_sum = t.weight.sum(dim=1)
    w_sum_padded = lowclamp(w_sum, 1.0)
    pad_norm = (lowclamp(1.0 - w_sum, 0.0) / w_sum_padded).contiguous()
    wn = (t.weight / w_sum_padded[:, None]).contiguous()
    return g, t, X, cfg, proj, freqs, wn, pad_norm


def sweep_inputs(B, dev, S=SWEEP_S, seed: int = 0):
    """P (R, B, S) normal, R = 2^17 / B on the card (one row on the CPU,
    where the sweep checks the control flow), a fifth of the weights zero,
    the rest |normal| normalized by max(total, 1), frequencies |normal| +
    0.1."""
    R = max(SWEEP_ENTRIES // B, 1) if dev.type == 'cuda' else 1
    rng = np.random.default_rng(seed + B)
    P = rng.standard_normal((R, B, S)).astype(np.float32)
    w = np.abs(rng.standard_normal((R, B))) * (rng.random((R, B))
                                              >= SWEEP_ZERO)
    w_sum = w.sum(1)
    wn = w / np.maximum(w_sum, 1.0)[:, None]
    pad = np.maximum(1.0 - w_sum, 0.0) / np.maximum(w_sum, 1.0)
    freqs = np.abs(rng.standard_normal(S)) + 0.1
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (P, wn, pad, freqs))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_fused_table')
    key = _timing.time_key(dev)
    g, t, X, cfg, proj, freqs, wn, pad_norm = setup(dev)
    _timing.emit(dev, bucket_size=t.bucket_size, R=t.num_recipients,
                 E_real=g.num_edges, tile_r_tile_s_not_used=[TILE_R, TILE_S],
                 plain=INTERPRET)
    table = fsw_table_forward_plain if INTERPRET else fsw_table_forward

    def fused():
        return table(t.idx, wn, pad_norm, (X @ proj.t()).contiguous(), freqs)

    def csr():
        return fsw_embed_graph(X, g, proj, freqs, cfg)

    def table_sort():
        return fsw_embed_table(X, t, proj, freqs, cfg, aggregate='sort')

    outs = {}
    with torch.no_grad():
        for name, f in (('fused_table_fwd', fused), ('csr_fwd', csr),
                        ('table_sort_fwd', table_sort)):
            outs[name] = f()
            ms = _timing.median_ms(f, dev, iters=ITERS, reps=3)
            rate = ({'edges_per_s': g.num_edges / (ms * 1e-3)}
                    if dev.type == 'cuda' else {})
            _timing.emit(dev, case=name, **{key: ms}, **rate)
        a, b, c = (outs[k] for k in ('fused_table_fwd', 'csr_fwd',
                                     'table_sort_fwd'))
        _timing.emit(dev, fused_vs_csr=float((a - b).abs().max()),
                     fused_vs_table_sort=float((a - c).abs().max()),
                     table_sort_vs_csr=float((c - b).abs().max()))
        agree('A1 against the sort route on the graph', a, c)
        sweep(dev, key)
    return outs


def sweep(dev, key, widths=SWEEP_B, S=SWEEP_S):
    """A1 against the sort route's quadrature and K2f on the hub-style
    widths: ms each, and A1's largest difference from the sort route."""
    cfg = FSWConfig(d_in=1, d_out=S, enable_bias=False)
    table = fsw_table_sort_plain if INTERPRET else fsw_table_sort
    rows = []
    for B in widths:
        P, wn, pad, freqs = sweep_inputs(B, dev, S)
        cases = {'a1': lambda: table(P, wn, pad, freqs),
                 'sort_route': lambda: bucket_quadrature(P, wn, pad, freqs,
                                                         cfg, 'sort')}
        if misfit(('fsw_rank_fwd',), B) is None:
            cases['k2f'] = lambda: fsw_rank_aggregate(P, wn, pad, freqs,
                                                      with_dw=False)
        a1 = cases['a1']()
        ref = cases['sort_route']()
        fields = {'sweep_B': B, 'R': P.shape[0], 'S': S,
                  'a1_vs_sort_route': float((a1 - ref).abs().max()),
                  'sort_route_scale': float(ref.abs().max())}
        for name, f in cases.items():
            fields[f'{name}_{key}'] = _timing.median_ms(f, dev, iters=5,
                                                        reps=3)
        _timing.emit(dev, **fields)
        agree(f'A1 against the sort route at B = {B}', a1, ref)
        rows.append(fields)
        del P, wn, pad, freqs
    return rows


if __name__ == '__main__':
    main()
