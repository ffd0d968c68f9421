"""Full-graph node-classification trainer on one device, with checkpoints
and metrics.

Counterpart of the single-device path of `fsw_gnn_tpu/train/trainer.py`
(BASELINE config #3: Cora/Citeseer-style full-graph training):

  * Adam, or AdamW when weight_decay > 0, as optax defines them, with an
    optional 'cosine' / 'warmup_cosine' learning-rate schedule that gives
    optax's value at every step;
  * `torch.save` checkpoints of (model state, optimizer state, step),
    written atomically, the newest 3 kept, restored automatically;
  * train/val/test accuracy, early stopping on val accuracy, JSONL
    metrics, and a `torch.profiler` trace for performance work.

The graph is built once on the host and moved to the device; one optimizer
step per epoch.  `num_devices > 1` (the edge-partitioned trainer, item 14 in
ROADMAP.md) and `eval_node_chunk` (layer-wise inference, item 11) raise.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.datasets import NodeClassificationData
from ..device import resolve_device
from ..graph import auto_layout, from_edge_index
from ..models.gnn import FSWGNN

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
    num_devices: Optional[int] = None       # > 1: not ported (item 14)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    auto_resume: bool = True                # fit() restores the latest
                                            # checkpoint in checkpoint_dir
    metrics_path: Optional[str] = None      # per-epoch metrics as JSON lines
    eval_node_chunk: Optional[int] = None   # not ported (item 11)
    trace_dir: Optional[str] = None         # torch.profiler trace output


def masked_softmax_cross_entropy(logits, labels, mask):
    """(sum of cross-entropy over the masked rows, mask count)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, labels[:, None])[:, 0]
    return -torch.sum(ll * mask), torch.sum(mask)


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


class Trainer:
    """Full-graph training of an `FSWGNN` on one device (None: the card).

    `model` replaces the freshly initialised FSWGNN (for instance one that
    `bridge.fswgnn_from_jax` built); it must have the dims the config and
    the data imply."""

    def __init__(self, data: NodeClassificationData, config: TrainConfig,
                 *, device=None, model: Optional[FSWGNN] = None):
        if config.num_devices and config.num_devices > 1:
            raise NotImplementedError(
                'num_devices > 1 needs the edge-partitioned trainer (item 14 '
                'in ROADMAP.md), which is not ported yet')
        if config.eval_node_chunk:
            raise NotImplementedError(
                'eval_node_chunk needs layer-wise inference (train/infer.py, '
                'item 11 in ROADMAP.md), which is not ported yet')
        self.data = data
        self.cfg = config
        self.device = resolve_device(device)
        self.graph = from_edge_index(data.edge_index, data.num_nodes,
                                     dtype=np.float32)
        self.compute_graph = auto_layout(self.graph).to(self.device)
        dims = tuple(config.hidden_dims) + (data.num_classes,)
        if model is None:
            model = FSWGNN(
                in_channels=data.features.shape[1], hidden_dims=dims,
                embed_dim=config.embed_dim,
                minimize_slice_coherence=config.minimize_slice_coherence,
                mlp_layers=config.mlp_layers, dropout=config.dropout,
                batchnorm=config.batchnorm, slice_chunk=config.slice_chunk,
                device=self.device,
                generator=torch.Generator().manual_seed(config.seed))
        elif model.hidden_dims != dims:
            raise ValueError(f'model dims {model.hidden_dims} != {dims}')
        self.model = model.to(self.device)
        dev = self.device
        self.X = torch.as_tensor(data.features, dtype=torch.float32,
                                 device=dev)
        self.labels = torch.as_tensor(data.labels, dtype=torch.long,
                                      device=dev)
        self.train_mask = torch.as_tensor(data.train_mask,
                                          dtype=torch.float32, device=dev)
        self.schedule = lr_schedule(config)
        params = [p for p in self.model.parameters() if p.requires_grad]
        adam = dict(lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)
        if config.weight_decay > 0:
            self.opt = torch.optim.AdamW(params, weight_decay=config.weight_decay,
                                         **adam)
        else:
            self.opt = torch.optim.Adam(params, **adam)
        # dropout masks; torch draws other numbers than JAX for a seed
        self.generator = torch.Generator(device=dev).manual_seed(
            config.seed + 1)
        self.step_count = 0
        self.history: list = []
        self._last_saved_step = None   # steps written by THIS process

    # ------------------------------------------------------------------
    def train_epoch(self) -> float:
        """One optimizer step on the masked mean cross-entropy, in train
        mode (dropout on, BatchNorm on batch statistics, updating its
        running ones)."""
        self.model.train()
        for group in self.opt.param_groups:
            group['lr'] = self.schedule(self.step_count)
        self.opt.zero_grad(set_to_none=True)
        logits = self.model(self.X, self.compute_graph,
                            generator=self.generator)
        s, c = masked_softmax_cross_entropy(logits, self.labels,
                                            self.train_mask)
        loss = s / torch.clamp(c, min=1.0)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        return loss.item()

    def predict(self) -> np.ndarray:
        """Logits of every node, in eval mode."""
        self.model.eval()
        with torch.no_grad():
            logits = self.model(self.X, self.compute_graph)
        return logits.cpu().numpy()

    def evaluate(self) -> Dict[str, float]:
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
        then keep the newest 3."""
        if not self.cfg.checkpoint_dir:
            return
        if self._last_saved_step == self.step_count:
            return  # this step is already on disk (e.g. final save right
                    # after a periodic one).  Tracked in-process, NOT via
                    # latest_step(): a reused checkpoint_dir may hold a
                    # stale entry with the same step number from a previous
                    # run, which the rename below replaces.
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        path = self._ckpt_path(self.step_count)
        tmp = f'{path}.{os.getpid()}.tmp'
        torch.save({'model': self.model.state_dict(),
                    'optimizer': self.opt.state_dict(),
                    'step': self.step_count}, tmp)
        os.replace(tmp, path)
        self._last_saved_step = self.step_count
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
        if not self.cfg.metrics_path:
            return
        with open(self.cfg.metrics_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def fit(self, verbose: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        best_val, best_metrics, strikes = -1.0, None, 0
        start_epoch = 1
        if cfg.auto_resume and self.latest_step() is not None:
            # continue a preempted run from its latest checkpoint (one
            # optimizer step per epoch, so step == epoch)
            start_epoch = self.restore_checkpoint() + 1
            if verbose:
                print(f'resumed from checkpoint at epoch {start_epoch - 1}')
        prof = None
        if cfg.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        for epoch in range(start_epoch, cfg.epochs + 1):
            loss = self.train_epoch()
            rec = {'epoch': epoch, 'loss': loss}
            if epoch % cfg.eval_every == 0 or epoch == cfg.epochs:
                rec.update(self.evaluate())
                if rec['val_acc'] == rec['val_acc']:  # not NaN
                    if rec['val_acc'] > best_val:
                        best_val, best_metrics, strikes = (rec['val_acc'],
                                                           rec, 0)
                    else:
                        strikes += 1
                if verbose:
                    print(f"epoch {epoch}: loss={loss:.4f} "
                          f"train={rec.get('train_acc', float('nan')):.3f} "
                          f"val={rec.get('val_acc', float('nan')):.3f}")
                if cfg.patience and strikes >= cfg.patience:
                    break
            self.history.append(rec)
            self._export_metrics(rec)
            if cfg.checkpoint_dir and epoch % cfg.checkpoint_every == 0:
                self.save_checkpoint()
        elapsed = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
            os.makedirs(cfg.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(cfg.trace_dir,
                                                  'trace.json'))
        if cfg.checkpoint_dir:
            self.save_checkpoint()
        final = self.evaluate()
        self._export_metrics({'final': final, 'seconds': elapsed})
        return {'final': final, 'best': best_metrics, 'seconds': elapsed,
                'epochs_run': len(self.history)}
