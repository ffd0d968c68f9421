"""Neighbor-sampled minibatch training on one device (BASELINE config #4,
ogbn-arxiv style).

Counterpart of the single-device path of `fsw_gnn_tpu/train/minibatch.py`.
Host-side pipeline: `NeighborSampler` (numpy and the native library) draws
fixed-fanout subgraphs around a seed batch; each subgraph is padded to one
shape (max_nodes nodes, max_edges edges), so every batch of an epoch has
the same shapes.  The loss is the cross-entropy of the seed nodes only
(the first `batch_size` local ids).  Evaluation runs on the full graph as
the `Trainer`'s does (layer-wise with `eval_node_chunk`).

Data parallelism over batch waves (`num_devices > 1`) belongs to
"Parallel and the distributed trainer" in ROADMAP.md and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.datasets import NodeClassificationData
from ..data.sampler import NeighborSampler
from ..graph import Graph, from_edge_index
from ..models.gnn import FSWGNN
from .trainer import TrainConfig, Trainer, masked_softmax_cross_entropy


class MinibatchTrainer(Trainer):
    """Minibatch training of an `FSWGNN` on one device (None: the card):
    one optimizer step a batch of `batch_size` seeds, `fanouts` in-neighbors
    sampled a hop.  `model` as the `Trainer`'s."""

    def __init__(self, data: NodeClassificationData, config: TrainConfig,
                 batch_size: int = 512, fanouts: Tuple[int, ...] = (10, 10),
                 *, device=None, model: Optional[FSWGNN] = None):
        if config.num_devices and config.num_devices > 1:
            raise NotImplementedError(
                'num_devices > 1 needs data-parallel batch waves '
                '("Parallel and the distributed trainer" in ROADMAP.md), '
                'which are not ported yet')
        super().__init__(data, config, device=device, model=model)
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts)
        self.sampler = NeighborSampler(data.edge_index, data.num_nodes,
                                       fanouts=self.fanouts, seed=config.seed)
        # shape caps: nodes <= b (1 + f1 + f1 f2 + ...), edges
        # <= b (f1 + f1 f2 + ...)
        nodes_cap, edges_cap, frontier = 1, 0, 1
        for f in self.fanouts:
            frontier *= f
            nodes_cap += frontier
            edges_cap += frontier
        self.max_nodes = batch_size * nodes_cap
        self.max_edges = max(128, -(-batch_size * edges_cap // 128) * 128)
        self.train_seeds = np.nonzero(data.train_mask)[0]
        self._rng = np.random.default_rng(config.seed)

    def _build_batch(self, seeds: np.ndarray):
        """(graph, Xb, labels, mask) of one batch on the device: the
        sampled subgraph as a CSR Graph padded to max_edges, the features
        gathered by node id (padded ids point at node 0), and the labels
        and loss mask of the seeds."""
        batch = self.sampler.sample(seeds, labels=self.data.labels,
                                    max_nodes=self.max_nodes)
        g = from_edge_index(batch.edge_index_local, self.max_nodes,
                            pad_to=self.max_edges, dtype=np.float32)
        # the JAX package pins this static field so that every batch hits
        # one jit cache entry; no step of the port reads it
        g = dataclasses.replace(g, num_edges=self.max_edges)
        dev = self.device
        node_ids = torch.from_numpy(batch.node_ids).to(dev)
        Xb = self.X[node_ids]
        labels = np.zeros(self.max_nodes, np.int64)
        mask = np.zeros(self.max_nodes, np.float32)
        n_seed = batch.num_seeds
        labels[:n_seed] = batch.seed_labels
        mask[:n_seed] = 1.0
        return (g.to(dev), Xb, torch.from_numpy(labels).to(dev),
                torch.from_numpy(mask).to(dev))

    def _updates(self) -> int:
        """Optimizer steps taken so far (the learning-rate schedule's
        count, as optax's), read from the optimizer's state."""
        for state in self.opt.state.values():
            return int(state['step'])
        return 0

    def _mb_step(self, graph: Graph, Xb, labels, mask):
        """One optimizer step on a built batch in train mode; returns the
        loss as a device scalar (no wait for the device)."""
        self.model.train()
        for group in self.opt.param_groups:
            group['lr'] = self.schedule(self._updates())
        self.opt.zero_grad(set_to_none=True)
        logits = self.model(Xb, graph, generator=self.generator)
        s, c = masked_softmax_cross_entropy(logits, labels, mask)
        loss = s / torch.clamp(c, min=1.0)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train_epoch(self) -> float:
        """One pass over the train seeds in a random order, one step a
        batch; the last batch wraps around to the epoch's first seeds.
        Returns the mean loss of the epoch's steps."""
        order = self._rng.permutation(self.train_seeds)
        losses = []
        for i in range(0, len(order), self.batch_size):
            seeds = order[i:i + self.batch_size]
            if len(seeds) < self.batch_size:
                if len(order) < self.batch_size:
                    break  # dataset smaller than one batch
                # keep shapes fixed: wrap around with the epoch's first
                # seeds (seeds stay unique within a batch)
                seeds = np.concatenate(
                    [seeds, order[:self.batch_size - len(seeds)]])
            losses.append(self._mb_step(*self._build_batch(seeds)))
        self.step_count += 1
        if not losses:
            return float('nan')
        # one wait for the device an epoch: the host samples the next batch
        # while the card runs the last step
        return float(np.mean(torch.stack(losses).double().cpu().numpy()))
