"""Driver: the program's `MinibatchTrainer`, one `train_epoch()` a call:
an optimizer step on each batch of `batch_size` train seeds in a random
order, `fanouts` in-neighbours sampled a hop on the host, the subgraph a
padded CSR graph.

Set-up builds the trainer around the program's FSW-GNN loaded with the
benchmark's leaves (the sampler and the epoch order seeded from the run's
seed) and runs its first epoch, the window's own call.  Its first
`checked_steps` optimizer steps are the checked ones, read through the
program's own calls: a forward hook gives the first batch's logits (its
real rows), Adam's exp_avg / (1 - beta1) after step 1 the gradient, and
the leaves after the last checked step their change.

The window's steps are counted as they ran: the sampler's batches are
kept as the program made them (their local edge lists, no copy), and
`tally` merges each one's duplicate pairs and sums the work model's floor
after the window, so that the counting adds no host work inside it.  The
host's own work on each batch, the sampler's call and the padded CSR
graph's build (`graph.from_edge_index`), is timed on the host's clock, as
is the whole `_build_batch` (those two, the copies to the card and the
wait for the card that the first copy makes).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import workmodel
from ..gen import SEED_MASK, coalesce, trainable
from .conv_step import build_model


class Cell:
    def __init__(self, cfg: dict, wl: dict, inputs: dict, device):
        from fsw_gnn_tpu_torch import TrainConfig
        from fsw_gnn_tpu_torch.data import NodeClassificationData, sampler
        from fsw_gnn_tpu_torch.train.minibatch import MinibatchTrainer
        model_cfg, train = cfg['model'], cfg['train']
        if train['optimizer'] != 'adam':
            raise ValueError('the MinibatchTrainer steps Adam')
        if sampler._load_native() is None:
            raise RuntimeError("the sampler's native library did not load; "
                               'its numpy fallback draws other batches than '
                               'the reference rebuilds')
        data = NodeClassificationData(
            name=cfg['name'], edge_index=inputs['edge_index'],
            features=inputs['features'], labels=inputs['labels'],
            train_mask=inputs['train_mask'], val_mask=inputs['val_mask'],
            test_mask=inputs['test_mask'])
        model = build_model(model_cfg, device)
        model.load_state_dict(inputs['params'], strict=True)
        tcfg = TrainConfig(hidden_dims=tuple(model_cfg['hidden_dims']),
                           learning_rate=float(train['lr']),
                           mlp_layers=model_cfg['mlp_layers'],
                           minimize_slice_coherence=False,
                           seed=inputs['seed'] & SEED_MASK)
        tr = self.trainer = MinibatchTrainer(
            data, tcfg, batch_size=int(train['batch_size']),
            fanouts=tuple(train['fanouts']), device=device, model=model)
        self.model_cfg, self.train_cfg = model_cfg, train
        self.params = params = dict(tr.model.named_parameters())

        # every batch the sampler makes, kept as (local edges, real nodes),
        # and the host's ns a batch: [sample, CSR build, whole build]
        kept, host = self._kept, self._host = [], []
        sample, build = tr.sampler.sample, tr._build_batch
        clock = time.perf_counter_ns

        def recorded(*args, **kwargs):
            t0 = clock()
            batch = sample(*args, **kwargs)
            kept.append((batch.edge_index_local, batch.num_real_nodes))
            host.append([clock() - t0, 0, 0])
            return batch

        def csr_timed(*args, **kwargs):
            t0 = clock()
            g = self._from_edge_index(*args, **kwargs)
            host[-1][1] = clock() - t0
            return g

        def build_timed(seeds):
            t0 = clock()
            out = build(seeds)
            host[-1][2] = clock() - t0
            return out
        tr.sampler.sample, tr._build_batch = recorded, build_timed
        self._csr_timed = csr_timed

        # the checked steps: the first epoch's first optimizer steps
        n_checked = int(wl['checked_steps'])
        b1 = float(train['betas'][0])
        losses, outs, first = [], [], {}
        mb_step = tr._mb_step

        def checked_step(*args):
            loss = mb_step(*args)
            losses.append(loss)
            if len(losses) == 1:
                state = tr.opt.state
                first['grad'] = {
                    k: (state[p]['exp_avg'].clone() / (1 - b1)
                        if 'exp_avg' in state.get(p, {})
                        else p.new_zeros(p.shape))
                    for k, p in params.items() if trainable(k)}
            if len(losses) == n_checked:
                first['change'] = {k: p.detach() - inputs['params'][k]
                                   for k, p in params.items()
                                   if trainable(k)}
            return loss

        def first_logits(module, args, out):
            if not outs:
                outs.append(out.detach().clone())

        tr._mb_step = checked_step
        hook = tr.model.register_forward_hook(first_logits)
        try:
            with self._timed_csr():
                tr.train_epoch()
        finally:
            hook.remove()
            del tr._mb_step
        if len(losses) < n_checked:
            raise ValueError(f'an epoch has {len(losses)} steps, fewer than '
                             f'the {n_checked} checked ones')
        self.first = {'losses': losses[:n_checked],
                      'out': outs[0][:kept[0][1]],
                      'grad': first['grad'], 'change': first['change']}
        kept.clear()
        host.clear()
        self._work = []

    @contextlib.contextmanager
    def _timed_csr(self):
        """The trainer's module calls the timed CSR build while inside."""
        from fsw_gnn_tpu_torch.train import minibatch
        self._from_edge_index = minibatch.from_edge_index
        minibatch.from_edge_index = self._csr_timed
        try:
            yield
        finally:
            minibatch.from_edge_index = self._from_edge_index

    def call(self) -> int:
        """One epoch; returns its optimizer steps (one a batch)."""
        n = len(self._kept)
        with self._timed_csr():
            self.trainer.train_epoch()
        return len(self._kept) - n

    def tally(self, lo: int, hi: int) -> dict:
        """The real edges (duplicate pairs merged, as the aggregation sees
        them), the work model's floor in seconds and the host's seconds
        (`sample`, `csr`: its own work on the batches; `build`: the whole
        `_build_batch`), summed over the window's steps lo .. hi - 1."""
        while len(self._work) < hi:
            edge_index, n = self._kept[len(self._work)]
            _, dst, _ = coalesce(edge_index, n)
            deg = np.bincount(dst, minlength=n)
            floor = workmodel.step_work(self.model_cfg, self.train_cfg, deg,
                                        n, len(dst))['floor_s']
            self._work.append((len(dst), floor))
        part = self._work[lo:hi]
        host = np.array(self._host[lo:hi], np.float64).reshape(-1, 3)
        sample_s, csr_s, build_s = host.sum(axis=0) * 1e-9
        return {'edges': float(sum(e for e, _ in part)),
                'floor_s': sum(f for _, f in part),
                'host_s': {'sample': sample_s, 'csr': csr_s,
                           'build': build_s}}

    def leaves(self):
        return list(self.params.values())
