"""Data-parallel minibatch training, one process per device.

Counterpart of `fsw_gnn_tpu/parallel/dp.py`.  Each rank trains on its own
neighbor-sampled subgraph batch of a wave of D batches; the loss is each
rank's numerator over the wave's seed count (summed over the ranks, no
gradient), the gradients are summed over the ranks before a replicated
optimizer step, so one wave is one full-batch step over the union of its D
batches.  The JAX package stacks a wave's D batches on a leading axis for
one program; here rank r keeps batch r of the wave (`local_batch`), and
`stack_batches` gives the JAX stacking for comparisons.  BatchNorm takes
each rank's own batch statistics, then the running statistics are averaged
over the ranks, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..graph import Graph, stack_graphs
from .collectives import (all_reduce_grads, all_reduce_sum,
                          average_running_stats)
from .dist import masked_softmax_cross_entropy
from .runtime import Mesh, make_data_mesh


def stack_batches(graphs, Xs, labels, masks):
    """D equally shaped batches stacked on a leading axis: (Graph of
    (D, ...) arrays, X (D, n, d), labels (D, n), masks (D, n))."""
    def stack(ts):
        return torch.stack([torch.as_tensor(t) for t in ts])
    return stack_graphs(graphs), stack(Xs), stack(labels), stack(masks)


def local_batch(stacked, rank: int):
    """Batch `rank` of a `stack_batches` stack: (Graph, X, labels, mask)."""
    g, X, labels, masks = stacked
    ef = None if g.edge_feat is None else g.edge_feat[rank]
    local = Graph(src=g.src[rank], dst=g.dst[rank], weight=g.weight[rank],
                  row_ptr=g.row_ptr[rank], in_degrees=g.in_degrees[rank],
                  edge_feat=ef, src_order=g.src_order[rank],
                  src_sorted=g.src_sorted[rank], num_nodes=g.num_nodes,
                  num_recipients=g.num_recipients, num_edges=g.num_edges)
    return local, X[rank], labels[rank], masks[rank]


def make_dp_train_step(model, optimizer, mesh: Mesh = None) -> Callable:
    """One data-parallel step of this rank on its batch of the wave:

        step(graph, Xb, labels, mask, generator=None) -> loss

    graph this rank's batch Graph (tensors on the mesh's device), Xb its
    node features, labels (int64) and mask (float) of its nodes.  Train
    mode, the gradients summed over the ranks (left in `.grad`), one
    optimizer step, the running statistics averaged.  Returns the wave's
    mean loss over every rank's seeds (a device scalar)."""
    mesh = mesh or make_data_mesh()
    params = [p for p in model.parameters() if p.requires_grad]

    def step(graph, Xb, labels, mask, generator=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(Xb, graph, generator=generator)
        s, c = masked_softmax_cross_entropy(logits, labels, mask)
        loss_local = s / torch.clamp(all_reduce_sum(c), min=1.0)
        loss_local.backward()
        all_reduce_grads(params)
        optimizer.step()
        average_running_stats(model)
        return all_reduce_sum(loss_local)
    return step
