"""One FSW graph-convolution layer on a random graph, on the CSR path.

Counterpart of examples/demo_conv.py: an Erdos-Renyi graph of 100 nodes
(edge probability 0.2, no self loops; seed 0) with 50 vertex and 11 edge
features, `FSWConv(50, 35, edgefeat_dim=11, mlp_layers=3,
learnable_embedding=True)` with its other arguments at their defaults, so
the slice vectors' coherence minimizer runs (`ops/coherence.py`).  The JAX
demo lets `auto_layout` pick degree-bucketed tables; here the layer runs
on the CSR `Graph` itself, the path of K3 (the segmented cumsum) on the
card.

    python -m fsw_gnn_tpu_torch.examples.demo_conv [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..conv import FSWConv
from ..device import resolve_device
from ..graph import from_edge_index
from ._args import parser

NUM_NODES, VERTEX_DIM, EDGE_DIM, OUT_DIM, EDGE_PROB = 100, 50, 11, 35, 0.2


def inputs(num_nodes=NUM_NODES):
    """The JAX demo's draws from default_rng(0): (edge_index, node features
    (float32), edge features (float64))."""
    rng = np.random.default_rng(0)
    A = rng.random((num_nodes, num_nodes)) < EDGE_PROB
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    edge_index = np.stack([src, dst])
    X = rng.standard_normal((num_nodes, VERTEX_DIM)).astype(np.float32)
    E = rng.standard_normal((edge_index.shape[1], EDGE_DIM))
    return edge_index, X, E


def make_conv(dev, generator=None):
    return FSWConv(in_channels=VERTEX_DIM, out_channels=OUT_DIM,
                   edgefeat_dim=EDGE_DIM, mlp_layers=3,
                   learnable_embedding=True, device=dev,
                   generator=generator)


def main(argv=None, conv=None):
    """Runs the layer; `conv` replaces the freshly built one (for instance
    one that `bridge.fswconv_from_jax` built).  Returns the output."""
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    edge_index, X, E = inputs()
    graph = from_edge_index(edge_index, NUM_NODES, edge_features=E,
                            dtype=np.float32).to(dev)
    conv = make_conv(dev) if conv is None else conv.to(dev)
    with torch.no_grad():
        out = conv(torch.from_numpy(X).to(dev), graph)
    print(f'graph: {NUM_NODES} nodes, {edge_index.shape[1]} edges '
          f'(layout: {type(graph).__name__}, device: {dev})')
    print(f'input features: {tuple(X.shape)}, edge features: '
          f'{tuple(E.shape)}')
    finite = bool(torch.isfinite(out).all())
    print(f'output vertex features: {tuple(out.shape)}  (finite: {finite})')
    if not finite:
        raise RuntimeError('the output is not finite')
    return out


if __name__ == '__main__':
    main()
