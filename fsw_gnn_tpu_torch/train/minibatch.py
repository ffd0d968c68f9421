"""Neighbor-sampled minibatch training on one device (BASELINE config #4,
ogbn-arxiv style).

Counterpart of the single-device path of `fsw_gnn_tpu/train/minibatch.py`.
Host-side pipeline: `NeighborSampler` (numpy and the native library) draws
fixed-fanout subgraphs around a seed batch; each subgraph is padded to one
shape (max_nodes nodes, max_edges edges), so every batch of an epoch has
the same shapes.  The loss is the cross-entropy of the seed nodes only
(the first `batch_size` local ids).  Evaluation runs on the full graph as
the `Trainer`'s does (layer-wise with `eval_node_chunk`).

With `num_devices` D > 1 (or any number inside a started process group)
the trainer goes data-parallel (parallel/dp.py): an epoch runs in waves
of D batches, rank r training on batch w + r of wave w; the gradients are
summed over the ranks and the loss normalised by the wave's seed count,
so one wave is one full-batch step over the union of its D batches.  The
sampler is one random stream: every rank samples all D batches of a wave
in order (the JAX package samples them in one process), keeps its own and
discards the rest, so rank r's batch is the JAX package's batch w + r bit
for bit, at D times the host sampling of one batch.  Evaluation runs on
the full graph on every rank.
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
from ..parallel import make_data_mesh, make_dp_train_step
from ..parallel.runtime import broadcast_module
from .trainer import (TrainConfig, Trainer, is_distributed,
                      masked_softmax_cross_entropy)


class MinibatchTrainer(Trainer):
    """Minibatch training of an `FSWGNN` on one device (None: the card):
    one optimizer step a batch of `batch_size` seeds, `fanouts` in-neighbors
    sampled a hop; or one rank of data-parallel waves (module docstring).
    `model` as the `Trainer`'s."""

    def __init__(self, data: NodeClassificationData, config: TrainConfig,
                 batch_size: int = 512, fanouts: Tuple[int, ...] = (10, 10),
                 *, device=None, model: Optional[FSWGNN] = None):
        # data parallelism over batch waves; the full-graph base class
        # always runs on this rank's device alone
        mesh = None
        if is_distributed(config.num_devices):
            mesh = make_data_mesh(config.num_devices, device)
            device = mesh.device
        super().__init__(data, dataclasses.replace(config, num_devices=None),
                         device=device, model=model)
        self.mesh = mesh    # the ranks of the waves (None: one device)
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
        if self.mesh is not None:
            # the JAX trainer samples a template batch here (its static
            # shapes), which moves the sampler's stream: so does this one
            self.sampler.sample(
                self.train_seeds[:min(batch_size, len(self.train_seeds))],
                labels=data.labels, max_nodes=self.max_nodes)
            broadcast_module(self.model)
            self.generator.manual_seed(
                config.seed + 1 + 1_000_003 * self.mesh.rank)
            self._dp_step = make_dp_train_step(self.model, self.opt,
                                               self.mesh)

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
        self._set_lr()
        self.opt.zero_grad(set_to_none=True)
        logits = self.model(Xb, graph, generator=self.generator)
        s, c = masked_softmax_cross_entropy(logits, labels, mask)
        loss = s / torch.clamp(c, min=1.0)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def _set_lr(self):
        for group in self.opt.param_groups:
            group['lr'] = self.schedule(self._updates())

    def train_epoch(self) -> float:
        """One pass over the train seeds in a random order, one step a
        batch; the last batch wraps around to the epoch's first seeds.
        Returns the mean loss of the epoch's steps."""
        if self.mesh is not None:
            return self._train_epoch_dp()
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

    def _train_epoch_dp(self) -> float:
        """One epoch in waves of D batches, this rank training on its own
        (parallel/dp.py).  Batch k takes a cyclic slice of the epoch's
        permutation (unique seeds while batch_size <= the train seeds);
        the batches fill whole waves."""
        D, rank = self.mesh.size, self.mesh.rank
        order = self._rng.permutation(self.train_seeds)
        if len(order) < self.batch_size:
            self.step_count += 1
            return float('nan')   # dataset smaller than one batch

        def batch_seeds(k):
            start = (k * self.batch_size) % len(order)
            return order[np.arange(start, start + self.batch_size)
                         % len(order)]

        n_batches = -(-len(order) // self.batch_size)
        n_batches = -(-n_batches // D) * D      # full waves only
        losses = []
        for w in range(0, n_batches, D):
            for d in range(D):
                if d == rank:
                    batch = self._build_batch(batch_seeds(w + d))
                else:
                    # the other ranks' batches advance the sampler's
                    # stream alike on every rank
                    self.sampler.sample(batch_seeds(w + d),
                                        labels=self.data.labels,
                                        max_nodes=self.max_nodes)
            self._set_lr()
            losses.append(self._dp_step(*batch, generator=self.generator))
        self.step_count += 1
        return float(np.mean(torch.stack(losses).double().cpu().numpy()))
