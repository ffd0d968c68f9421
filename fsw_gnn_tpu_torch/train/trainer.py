"""Full-graph node-classification trainer, on one device or edge-partitioned
over the ranks of a process group, with checkpoints and metrics.

Counterpart of `fsw_gnn_tpu/train/trainer.py` (BASELINE config #3:
Cora/Citeseer-style full-graph training; #5: a graph edge-partitioned over
N devices with a boundary exchange):

  * Adam, or AdamW when weight_decay > 0, as optax defines them, with an
    optional 'cosine' / 'warmup_cosine' learning-rate schedule that gives
    optax's value at every step;
  * `torch.save` checkpoints of (model state, optimizer state, step),
    written atomically, the newest 3 kept, restored automatically;
  * train/val/test accuracy, early stopping on val accuracy, JSONL
    metrics, and a `torch.profiler` trace for performance work.

The graph is built once on the host and moved to the device; one optimizer
step per epoch.  With `eval_node_chunk` set, `predict` runs exact
layer-wise inference (train/infer.py) on the host CSR graph in recipient
chunks of that size, which caps the device memory of an evaluation.

With `num_devices` P > 1, or any `num_devices` inside a started process
group, the trainer is one rank of the edge-partitioned trainer
(parallel/dist.py): every rank partitions the graph alike and keeps its
shard, the model is rank 0's (broadcast), BatchNorm takes its statistics
over every rank's rows, `exchange` picks the boundary exchange, and
evaluation reduces its counts over the ranks.  The group must hold P
processes (`parallel.runtime.make_graph_mesh` raises otherwise).  Rank 0
alone writes checkpoints and metrics; every rank resumes from the step
rank 0 finds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.datasets import NodeClassificationData
from ..device import resolve_device
from ..graph import auto_layout, from_edge_index
from ..models.gnn import FSWGNN
from ..parallel import (make_distributed_forward,
                        make_distributed_train_step, make_graph_mesh,
                        masked_softmax_cross_entropy, partition_graph,
                        shard_node_features, shard_recipient_labels)
from ..parallel.collectives import all_reduce_sum
from ..parallel.dist import gather_recipient_values
from ..parallel.runtime import broadcast_module, broadcast_object
from ..utils.profiling import span, trace

_KEEP = 3
_CKPT = re.compile(r'^step_(\d+)\.pt$')


@dataclasses.dataclass
class TrainConfig:
    hidden_dims: tuple = (64,)
    embed_dim: Optional[int] = None          # None -> 2 * max(in, out)
    learning_rate: float = 1e-2
    lr_schedule: Optional[str] = None        # None | 'cosine' | 'warmup_cosine'
    warmup_epochs: int = 10
    weight_decay: float = 0.0
    epochs: int = 100
    eval_every: int = 5
    patience: Optional[int] = None          # early stopping on val accuracy
    minimize_slice_coherence: bool = False
    mlp_layers: int = 1
    dropout: float = 0.0
    batchnorm: bool = False
    slice_chunk: Optional[int] = None       # serialize slices to cap memory
    seed: int = 0
    num_devices: Optional[int] = None       # > 1: edge-partitioned ranks
    exchange: str = 'all_gather'   # 'all_gather' | 'all_to_all' | 'overlap'
    overlap_chunks: int = 4        # slice chunks for exchange='overlap'
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    auto_resume: bool = True                # fit() restores the latest
                                            # checkpoint in checkpoint_dir
    metrics_path: Optional[str] = None      # per-epoch metrics as JSON lines
    eval_node_chunk: Optional[int] = None   # layer-wise evaluation in
                                            # recipient chunks of this size
    trace_dir: Optional[str] = None         # torch.profiler trace output
    compilation_cache: Optional[str] = None  # where the kernels' builds
                                             # persist (default _build/)


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f'the cosine schedule needs positive decay_steps, '
                         f'got {decay_steps}')

    def schedule(count):
        count = min(float(count), float(decay_steps))
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * decay + alpha)
    return schedule


def lr_schedule(cfg: TrainConfig):
    """The learning rate as a function of the optimizer step (0 for the
    first update), as the JAX trainer's optax schedule gives it."""
    lr = cfg.learning_rate
    if cfg.lr_schedule is None:
        return lambda count: lr
    if cfg.lr_schedule == 'cosine':
        return _cosine(lr, cfg.epochs)
    if cfg.lr_schedule == 'warmup_cosine':
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, epochs): a
        # linear ramp from 0, then the cosine from lr over the rest
        warmup = cfg.warmup_epochs
        cosine = _cosine(lr, cfg.epochs - warmup)

        def schedule(count):
            if count < warmup:
                return lr * count / warmup
            return cosine(count - warmup)
        return schedule
    raise ValueError(f'unknown lr_schedule {cfg.lr_schedule!r}')


def is_distributed(num_devices: Optional[int]) -> bool:
    """Whether a trainer given `num_devices` runs as a rank of the
    distributed trainer: more than one device, or any number inside a
    started process group (a group of one runs the distributed path on
    one device)."""
    return num_devices is not None and (num_devices > 1
                                        or dist.is_initialized())


class Trainer:
    """Full-graph training of an `FSWGNN` on one device (None: the card),
    or as one rank of the edge-partitioned trainer (module docstring).

    `model` replaces the freshly initialised FSWGNN (for instance one that
    `bridge.fswgnn_from_jax` built); it must have the dims the config and
    the data imply."""

    def __init__(self, data: NodeClassificationData, config: TrainConfig,
                 *, device=None, model: Optional[FSWGNN] = None):
        self.data = data
        self.cfg = config
        if config.compilation_cache:
            from ..utils import enable_compilation_cache
            enable_compilation_cache(config.compilation_cache)
        self.distributed = is_distributed(config.num_devices)
        self.mesh = None
        if self.distributed:
            self.mesh = make_graph_mesh(config.num_devices, device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.graph = from_edge_index(data.edge_index, data.num_nodes,
                                     dtype=np.float32)
        dims = tuple(config.hidden_dims) + (data.num_classes,)
        if model is None:
            model = FSWGNN(
                in_channels=data.features.shape[1], hidden_dims=dims,
                embed_dim=config.embed_dim,
                minimize_slice_coherence=config.minimize_slice_coherence,
                mlp_layers=config.mlp_layers, dropout=config.dropout,
                batchnorm=config.batchnorm,
                # batch statistics over every rank's rows
                bn_axis_name=('graph' if self.distributed
                              and config.batchnorm else None),
                slice_chunk=config.slice_chunk, device=self.device,
                generator=torch.Generator().manual_seed(config.seed))
        elif model.hidden_dims != dims:
            raise ValueError(f'model dims {model.hidden_dims} != {dims}')
        self.model = model.to(self.device)
        dev = self.device
        if self.distributed:
            self._init_distributed()
        else:
            self.compute_graph = auto_layout(self.graph).to(dev)
            self.X = torch.as_tensor(data.features, dtype=torch.float32,
                                     device=dev)
            self.labels = torch.as_tensor(data.labels, dtype=torch.long,
                                          device=dev)
            self.train_mask = torch.as_tensor(data.train_mask,
                                              dtype=torch.float32,
                                              device=dev)
        self.schedule = lr_schedule(config)
        params = [p for p in self.model.parameters() if p.requires_grad]
        adam = dict(lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        if config.weight_decay > 0:
            self.opt = torch.optim.AdamW(params, weight_decay=config.weight_decay,
                                         **adam)
        else:
            self.opt = torch.optim.Adam(params, **adam)
        # dropout masks; torch draws other numbers than JAX for a seed.
        # Each rank folds its rank into the seed (JAX folds the device
        # index into the key)
        rank = self.mesh.rank if self.mesh is not None else 0
        self.generator = torch.Generator(device=dev).manual_seed(
            config.seed + 1 + 1_000_003 * rank)
        self.step_count = 0
        self.history: list = []
        self._last_saved_step = None   # steps written by THIS process
        if self.distributed:
            self._step = make_distributed_train_step(
                self.model, self.opt, self.shards, self.mesh,
                exchange=config.exchange,
                overlap_chunks=config.overlap_chunks)
            self.compute_graph = self._step.graph
            self._fwd = make_distributed_forward(
                self.model, self.shards, self.mesh,
                exchange=config.exchange,
                overlap_chunks=config.overlap_chunks,
                graph=self.compute_graph)

    def _init_distributed(self):
        """This rank's shard of the partitioned graph, its features,
        labels and split masks on its device, and rank 0's model."""
        data, dev, rank = self.data, self.device, self.mesh.rank
        broadcast_module(self.model)
        self.shards = partition_graph(self.graph, self.mesh.size)
        self.X = torch.as_tensor(shard_node_features(
            data.features.astype(np.float32), self.shards)[rank], device=dev)
        masks = {}
        for split in ('train', 'val', 'test'):
            labels, m = shard_recipient_labels(
                data.labels, getattr(data, f'{split}_mask'), self.shards)
            masks[split] = torch.as_tensor(m[rank], device=dev)
        self.labels = torch.as_tensor(labels[rank], dtype=torch.long,
                                      device=dev)
        self.train_mask = masks['train']
        self.split_masks = masks

    @property
    def is_main(self) -> bool:
        """Whether this process writes checkpoints, metrics and traces:
        rank 0, or the only process."""
        return self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------------
    def train_epoch(self) -> float:
        """One optimizer step on the masked mean cross-entropy, in train
        mode (dropout on, BatchNorm on batch statistics, updating its
        running ones)."""
        with span('fsw.train.step', step=self.step_count):
            for group in self.opt.param_groups:
                group['lr'] = self.schedule(self.step_count)
            if self.distributed:
                loss = self._step(self.X, self.labels, self.train_mask,
                                  generator=self.generator)
            else:
                self.model.train()
                self.opt.zero_grad(set_to_none=True)
                with span('fsw.train.forward'):
                    logits = self.model(self.X, self.compute_graph,
                                        generator=self.generator)
                with span('fsw.train.loss'):
                    s, c = masked_softmax_cross_entropy(logits, self.labels,
                                                        self.train_mask)
                    loss = s / torch.clamp(c, min=1.0)
                with span('fsw.train.backward'):
                    loss.backward()
                with span('fsw.train.optimizer'):
                    self.opt.step()
            self.step_count += 1
            with span('fsw.train.readback'):
                return loss.item()

    def predict(self) -> np.ndarray:
        """Logits of every node, in eval mode: one forward on the compute
        layout, or layer-wise on the CSR graph with `eval_node_chunk`;
        distributed, every rank's rows gathered (on every rank)."""
        if self.distributed:
            return gather_recipient_values(self._local_logits(),
                                           self.shards, self.mesh)
        if self.cfg.eval_node_chunk:
            from .infer import layerwise_predict
            return layerwise_predict(self.model, self.data.features,
                                     self.graph, self.cfg.eval_node_chunk,
                                     slice_chunk=self.cfg.slice_chunk,
                                     device=self.device)
        self.model.eval()
        with torch.no_grad():
            logits = self.model(self.X, self.compute_graph)
        return logits.cpu().numpy()

    def _local_logits(self):
        self.model.eval()
        with torch.no_grad():
            return self._fwd(self.X)

    def evaluate(self) -> Dict[str, float]:
        if self.distributed:
            # (correct, count) of each split over this rank's rows, summed
            # over the ranks: the logits never leave their rank
            with torch.no_grad():
                ok = (self._local_logits().argmax(-1)
                      == self.labels).to(torch.float64)
                sums = torch.stack([
                    t for split in ('train', 'val', 'test')
                    for t in (torch.sum(ok * self.split_masks[split]),
                              torch.sum(self.split_masks[split].double()))])
            correct_count = all_reduce_sum(sums).tolist()
            return {f'{split}_acc': (correct_count[2 * i]
                                     / correct_count[2 * i + 1]
                                     if correct_count[2 * i + 1]
                                     else float('nan'))
                    for i, split in enumerate(('train', 'val', 'test'))}
        pred = self.predict().argmax(-1)
        y = self.data.labels
        out = {}
        for split, m in [('train', self.data.train_mask),
                         ('val', self.data.val_mask),
                         ('test', self.data.test_mask)]:
            out[f'{split}_acc'] = (float((pred[m] == y[m]).mean())
                                   if m.any() else float('nan'))
        return out

    # ------------------------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.cfg.checkpoint_dir, f'step_{step:08d}.pt')

    def all_steps(self) -> list:
        """Steps of the checkpoints in checkpoint_dir, ascending."""
        d = self.cfg.checkpoint_dir
        if not d or not os.path.isdir(d):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT.match,
                                                   os.listdir(d)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save_checkpoint(self):
        """Write (model state, optimizer state, step) to
        checkpoint_dir/step_<step>.pt through a temporary file and a rename,
        then keep the newest 3.  Distributed, rank 0 writes (the replicas
        hold the same state) and every rank waits for the file."""
        if not self.cfg.checkpoint_dir:
            return
        if self._last_saved_step == self.step_count:
            return  # this step is already on disk (e.g. final save right
                    # after a periodic one).  Tracked in-process, NOT via
                    # latest_step(): a reused checkpoint_dir may hold a
                    # stale entry with the same step number from a previous
                    # run, which the rename below replaces.
        if self.is_main:
            self._write_checkpoint()
        if self.mesh is not None:
            dist.barrier()
        self._last_saved_step = self.step_count

    def _write_checkpoint(self):
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        path = self._ckpt_path(self.step_count)
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save({'model': self.model.state_dict(),
                    'optimizer': self.opt.state_dict(),
                    'step': self.step_count}, tmp)
        os.replace(tmp, path)
        for step in self.all_steps()[:-_KEEP]:
            os.remove(self._ckpt_path(step))

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        if not self.cfg.checkpoint_dir:
            raise ValueError('no checkpoint_dir configured')
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f'no checkpoint in {self.cfg.checkpoint_dir}')
        state = torch.load(self._ckpt_path(step), map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state['model'])
        self.opt.load_state_dict(state['optimizer'])
        # the restored step's file is exactly this state: a same-step save
        # would rewrite identical data
        self._last_saved_step = step
        self.step_count = step
        return step

    # ------------------------------------------------------------------
    def _export_metrics(self, rec):
        if not self.cfg.metrics_path or not self.is_main:
            return
        with open(self.cfg.metrics_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def fit(self, verbose: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        best_val, best_metrics, strikes = -1.0, None, 0
        start_epoch = 1
        latest = self.latest_step() if cfg.auto_resume else None
        if self.mesh is not None:   # every rank resumes from rank 0's step
            latest = broadcast_object(latest)
        verbose = verbose and self.is_main
        if latest is not None:
            # continue a preempted run from its latest checkpoint (one
            # optimizer step per epoch, so step == epoch)
            start_epoch = self.restore_checkpoint(latest) + 1
            if verbose:
                print(f'resumed from checkpoint at epoch {start_epoch - 1}')
        # the epochs in a torch.profiler trace, written to
        # trace_dir/trace.json (the CPU, and the card when it trains there)
        tracing = (trace(cfg.trace_dir, device=self.device)
                   if cfg.trace_dir and self.is_main
                   else contextlib.nullcontext())
        t0 = time.perf_counter()
        with tracing:
            for epoch in range(start_epoch, cfg.epochs + 1):
                loss = self.train_epoch()
                rec = {'epoch': epoch, 'loss': loss}
                if epoch % cfg.eval_every == 0 or epoch == cfg.epochs:
                    rec.update(self.evaluate())
                    if rec['val_acc'] == rec['val_acc']:  # not NaN
                        if rec['val_acc'] > best_val:
                            best_val, best_metrics, strikes = (
                                rec['val_acc'], rec, 0)
                        else:
                            strikes += 1
                    if verbose:
                        print(f"epoch {epoch}: loss={loss:.4f} "
                              f"train={rec.get('train_acc', float('nan')):.3f}"
                              f" val={rec.get('val_acc', float('nan')):.3f}")
                    if cfg.patience and strikes >= cfg.patience:
                        break
                self.history.append(rec)
                self._export_metrics(rec)
                if cfg.checkpoint_dir and epoch % cfg.checkpoint_every == 0:
                    self.save_checkpoint()
            elapsed = time.perf_counter() - t0
        if cfg.checkpoint_dir:
            self.save_checkpoint()
        final = self.evaluate()
        self._export_metrics({'final': final, 'seconds': elapsed})
        return {'final': final, 'best': best_metrics, 'seconds': elapsed,
                'epochs_run': len(self.history)}
