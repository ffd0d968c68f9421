"""Distributed FSW-GNN execution: the edge-partitioned full-graph step and
forward, one process per device.

Counterpart of `fsw_gnn_tpu/parallel/dist.py`.  The graph is
edge-partitioned (`partition.partition_graph`): each rank owns a
contiguous range of recipients and all of their in-edges, and holds its
node features in the padded per-shard layout (R_shard, d).  Before every
message-passing layer the sender matrix is assembled by the boundary
exchange:

  * 'all_gather': every rank's rows (`collectives.all_gather_rows`);
  * 'all_to_all': only the rows each peer references
    (`collectives.all_to_all_rows` on the shards' a2a ids);
  * 'overlap': the features stay local and each layer's sender
    projections are exchanged in slice chunks behind the aggregation
    (parallel/overlap.py).

The loss is this rank's numerator over the global mask count (the count
summed over the ranks, no gradient); autograd through the collectives
gives each rank its share of the gradient, and the gradients are summed
over the ranks before a replicated optimizer step.  BatchNorm's running
statistics are averaged over the ranks after the step.  The step and the
forward return this rank's rows; `partition.unshard_recipient_values`
assembles an all-gather of them.
"""
from __future__ import annotations

from typing import Callable

import torch

from .collectives import (all_gather_rows, all_reduce_grads, all_reduce_sum,
                          all_to_all_rows, average_running_stats,
                          start_all_gather)
from .partition import GraphShards, local_graph
from .runtime import Mesh, make_graph_mesh

EXCHANGES = ('all_gather', 'all_to_all', 'overlap')


def masked_softmax_cross_entropy(logits, labels, mask):
    """(sum of cross-entropy over the masked rows, mask count)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, labels[:, None])[:, 0]
    return -torch.sum(ll * mask), torch.sum(mask)


def _a2a_gather_fn(send_idx_local):
    """Send each peer only the rows it references: send_idx_local (P, L),
    MY local rows destined to each peer.  Block q of the received
    (P * L, d) buffer holds the L rows I asked of rank q, which the shards'
    compact sender ids index."""
    def gather(x_local):
        recv = all_to_all_rows(x_local[send_idx_local])        # (P, L, d)
        return recv.reshape(-1, x_local.shape[-1])
    return gather


def _model_exchange_kwargs(exchange: str, mesh: Mesh, shards: GraphShards,
                           overlap_chunks: int) -> dict:
    """The model's keyword arguments for the boundary exchange."""
    if exchange == 'overlap':
        return {'proj_gather_fn': start_all_gather,
                'exchange_chunks': overlap_chunks}
    if exchange == 'all_to_all':
        send = torch.as_tensor(shards.a2a_send_idx[mesh.rank]).long()
        return {'gather_fn': _a2a_gather_fn(send.to(mesh.device))}
    if exchange == 'all_gather':
        return {'gather_fn': all_gather_rows}
    raise ValueError(f'exchange must be one of {EXCHANGES}, got '
                     f'{exchange!r}')


def _local(shards: GraphShards, mesh: Mesh, exchange: str):
    """This rank's layout on its device ('overlap' indexes the
    all-gathered padded-global senders, as 'all_gather')."""
    return local_graph(shards, mesh.rank,
                       'all_gather' if exchange == 'overlap'
                       else exchange).to(mesh.device)


def make_distributed_train_step(model, optimizer, shards: GraphShards,
                                mesh: Mesh = None,
                                exchange: str = 'all_gather',
                                overlap_chunks: int = 4) -> Callable:
    """One full-graph node-classification step of this rank:

        step(X_local, labels, mask, generator=None) -> loss

    X_local (R_shard, d_in) this rank's features in the shard layout,
    labels (R_shard,) int64 and mask (R_shard,) float of its recipients
    (`partition.shard_recipient_labels`), tensors on the mesh's device;
    `generator` draws the dropout masks (fold the rank into its seed).
    The model runs in train mode (dropout on, BatchNorm on batch
    statistics), the gradients are summed over the ranks and left in each
    parameter's `.grad`, `optimizer` steps, and BatchNorm's running
    statistics are averaged over the ranks.  Returns the global mean loss
    (a device scalar, every rank the same)."""
    mesh = mesh or make_graph_mesh()
    graph = _local(shards, mesh, exchange)
    ex_kwargs = _model_exchange_kwargs(exchange, mesh, shards,
                                       overlap_chunks)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(X_local, labels, mask, generator=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(X_local, graph, generator=generator, **ex_kwargs)
        loss_sum, cnt = masked_softmax_cross_entropy(logits, labels, mask)
        # this rank's share of the global mean: the numerator stays local
        cnt_total = all_reduce_sum(cnt)
        loss_local = loss_sum / torch.clamp(cnt_total, min=1.0)
        loss_local.backward()
        all_reduce_grads(params)
        optimizer.step()
        average_running_stats(model)
        return all_reduce_sum(loss_local)
    step.graph = graph
    return step


def make_distributed_forward(model, shards: GraphShards, mesh: Mesh = None,
                             exchange: str = 'all_gather',
                             overlap_chunks: int = 4, graph=None) -> Callable:
    """fwd(X_local) -> this rank's (R_shard, out) rows of the model's
    forward in its current mode (call under `torch.no_grad()` and
    `model.eval()` for inference).  `graph`: this rank's layout on its
    device where the caller holds it already (a train step's `.graph`,
    built for the same exchange), so the shard's tables are not copied
    twice."""
    mesh = mesh or make_graph_mesh()
    if graph is None:
        graph = _local(shards, mesh, exchange)
    ex_kwargs = _model_exchange_kwargs(exchange, mesh, shards,
                                       overlap_chunks)

    def fwd(X_local):
        return model(X_local, graph, **ex_kwargs)
    fwd.graph = graph
    return fwd


def gather_recipient_values(local, shards: GraphShards, mesh: Mesh):
    """Every rank's (R_shard, ...) rows gathered and unpadded: the
    (R, ...) values of every recipient, as numpy, on every rank."""
    from .partition import unshard_recipient_values
    with torch.no_grad():
        stacked = all_gather_rows(local.contiguous())
    stacked = stacked.reshape((mesh.size,) + tuple(local.shape))
    return unshard_recipient_values(stacked.cpu().numpy(), shards)
