"""The edge-partitioned FSW-GNN step over P processes, with each of the
three boundary exchanges; they must agree.

Counterpart of examples/demo_distributed.py, whose 8-device mesh becomes
`--nproc` processes started by `parallel.launch` (one a device: NCCL with
rank r on cuda:r, so P is at most the cards present; gloo on the CPU with
`--device cpu`).  A random graph of 512 nodes (8 draws an edge a node,
self loops dropped; seed 0), 16 features, 4 classes,
`FSWGNN(hidden_dims=(32, 4))` (random weights, seed 0), Adam(1e-2); each
rank runs 5 steps of `make_distributed_train_step` with each exchange:

  * all_gather: every rank's sender rows;
  * all_to_all: only the boundary rows each peer references;
  * overlap:    the features stay local and each layer's sender
                projections are exchanged slice chunk by slice chunk
                behind the aggregation (parallel/overlap.py).

The three 5-step losses must agree within 1e-4 of max(1, |loss|), as the
JAX demo asserts.  `main` returns rank 0's losses and its kernel launches
(counted in its process).

    python -m fsw_gnn_tpu_torch.examples.demo_distributed [--nproc 1]
    python -m fsw_gnn_tpu_torch.examples.demo_distributed --device cpu \
        --nproc 2
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ._args import parser

EXCHANGES = ('all_gather', 'all_to_all', 'overlap')
N, D_IN, N_CLASSES, STEPS = 512, 16, 4, 5


def problem():
    """The JAX demo's draws from default_rng(0): (edge_index, X, y)."""
    rng = np.random.default_rng(0)
    E = N * 8
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    keep = src != dst
    X = rng.standard_normal((N, D_IN)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, N)
    return np.stack([src[keep], dst[keep]]), X, y


def rank_losses(device):
    """One rank: each exchange's loss after 5 steps from the same initial
    model, this rank's shard sizes and its kernel launches."""
    from ..graph import from_edge_index
    from ..models import FSWGNN
    from ..ops import launch_counts, reset_launches
    from ..parallel import (make_distributed_train_step, make_graph_mesh,
                            partition_graph, shard_node_features,
                            shard_recipient_labels)
    mesh = make_graph_mesh(device=device)
    dev = mesh.device
    edge_index, X, y = problem()
    g = from_edge_index(edge_index, N, dtype=np.float32)
    shards = partition_graph(g, mesh.size)
    Xs = shard_node_features(X, shards)
    labels, mask = shard_recipient_labels(y, np.ones(N, np.float32), shards)
    Xl = torch.as_tensor(Xs[mesh.rank]).to(dev)
    lab = torch.as_tensor(labels[mesh.rank]).long().to(dev)
    msk = torch.as_tensor(mask[mesh.rank]).float().to(dev)
    reset_launches()
    losses = {}
    for exchange in EXCHANGES:
        model = FSWGNN(in_channels=D_IN, hidden_dims=(32, N_CLASSES),
                       minimize_slice_coherence=False, device=dev,
                       generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = make_distributed_train_step(model, opt, shards, mesh,
                                           exchange=exchange)
        for _ in range(STEPS):
            loss = step(Xl, lab, msk)
        losses[exchange] = float(loss)
    return {'losses': losses, 'edges': g.num_edges,
            'recipients_per_shard': int(shards.shard_num_recipients),
            'launches': launch_counts()}


def main(argv=None):
    from ..parallel.launch import launch
    ap = parser(__doc__)
    ap.add_argument('--nproc', type=int, default=None,
                    help='processes (default: 1 on the card, 2 on the CPU)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    nproc = args.nproc or (1 if dev.type == 'cuda' else 2)
    reports = launch(nproc, 'fsw_gnn_tpu_torch.examples.demo_distributed:'
                     'rank_losses', {'device': dev.type}, device=dev.type)
    first = reports[0]
    print(f'{N} nodes / {first["edges"]} edges, {nproc} processes on '
          f'{dev.type} ({first["recipients_per_shard"]} recipients per '
          f'shard)')
    losses = first['losses']
    for k, v in losses.items():
        print(f'  exchange={k:<11} {STEPS}-step loss {v:.6f}')
    base = losses['all_gather']
    for r in reports:
        for k, v in r['losses'].items():
            if not abs(v - base) < 1e-4 * max(1.0, abs(base)):
                raise RuntimeError(f'exchange {k}: loss {v} against '
                                   f'all_gather {base}')
    print('all three exchanges agree.')
    return {'losses': losses, 'launches': first['launches']}


if __name__ == '__main__':
    main()
