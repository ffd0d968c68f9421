"""A full-graph FSW-GNN train step at ogbn-arxiv's scale on one card.

Counterpart of benchmarks/bench_arxiv_scale.py: a random graph of
FSW_AX_NODES nodes (169343, arxiv's count) and FSW_AX_DEG draws an edge a
node (self loops dropped; seed 0), d_in FSW_AX_DIN, `FSWGNN(hidden_dims=
(HIDDEN, 40), embed_dim=EMBED)` (random weights, seed 0) in the layout
`auto_layout` picks, Adam(1e-3), the mean of
`parallel.dist.masked_softmax_cross_entropy` over every node.  The JAX
script runs STEPS steps in one jitted scan; here STEPS eager steps: one
run of STEPS steps first (the kernels' first calls), then one timed run,
host clock with a synchronize at its end (and CUDA events around it).
Printed: ms a step (`ms_per_step`, the host clock as the JAX script's;
`device_ms_per_step`, CUDA events), edges/s, the final loss, and the peak
`torch.cuda.max_memory_allocated` over the timed run beside them.

On the card `embedding._k1_faster` sends every degree class here (D = 128
inputs, about 7 entries a node) to the rank route's K2f / K2b, not K1;
the tables' gather backward (`indexing_backward_kernel`, the padded
entries all on sender 0) dominates the step (ROADMAP §2, G1).

    python -m fsw_gnn_tpu_torch.benchmarks.bench_arxiv_scale [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_AX_NODES 169343,
FSW_AX_DEG 7, FSW_AX_DIN 128, FSW_AX_HIDDEN 64, FSW_AX_EMBED 65,
FSW_AX_STEPS 5.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..graph import auto_layout
from ..models import FSWGNN
from ..parallel.dist import masked_softmax_cross_entropy
from . import _timing
from .bench_csr_vs_table import normal32, random_graph

N_NODES = int(os.environ.get('FSW_AX_NODES', 169_343))
AVG_DEG = int(os.environ.get('FSW_AX_DEG', 7))
D_IN = int(os.environ.get('FSW_AX_DIN', 128))
HIDDEN = int(os.environ.get('FSW_AX_HIDDEN', 64))
N_CLASSES = 40
EMBED = int(os.environ.get('FSW_AX_EMBED', 65))
STEPS = int(os.environ.get('FSW_AX_STEPS', 5))


def setup(dev, n_nodes=N_NODES, avg_deg=AVG_DEG, d_in=D_IN):
    """The JAX script's graph, features and labels (default_rng(0)): (the
    CSR Graph, its auto_layout on `dev`, X, y, mask)."""
    rng = np.random.default_rng(0)
    g = random_graph(rng, n_nodes, avg_deg)
    gl = auto_layout(g)
    X = normal32(rng, (n_nodes, d_in))
    y = rng.integers(0, N_CLASSES, n_nodes)
    put = lambda a: torch.from_numpy(a).to(dev)
    return (g, gl.to(dev), put(X), put(y).long(),
            torch.ones(n_nodes, dtype=torch.float32, device=dev))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_arxiv_scale')
    g, gl, X, y, mask = setup(dev)
    model = FSWGNN(in_channels=D_IN, hidden_dims=(HIDDEN, N_CLASSES),
                   embed_dim=EMBED, minimize_slice_coherence=False,
                   device=dev, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def run(steps):
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            s, c = masked_softmax_cross_entropy(model(X, gl), y, mask)
            loss = s / c
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    t0 = time.perf_counter()
    run(STEPS)
    _timing.drain(dev)
    first_s = time.perf_counter() - t0
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    losses = run(STEPS)
    if dev.type == 'cuda':
        b.record()
    _timing.drain(dev)
    dt = (time.perf_counter() - t0) / STEPS
    row = {'nodes': g.num_nodes, 'edges': g.num_edges,
           'layout': type(gl).__name__, 'first_run_s': first_s,
           'ms_per_step': 1e3 * dt, 'edges_per_s': g.num_edges / dt,
           'final_loss': float(losses[-1])}
    if dev.type == 'cuda':
        row.update(device_ms_per_step=a.elapsed_time(b) / STEPS,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f'a loss is not finite: {losses.tolist()}')
    _timing.emit(dev, **row)
    return row


if __name__ == '__main__':
    main()
