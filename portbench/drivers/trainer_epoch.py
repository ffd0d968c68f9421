"""Driver: the program's full-graph `Trainer`, one `train_epoch()` (one
optimizer step on the whole graph) a call, on the layout the Trainer picks.

Set-up builds the Trainer around the program's FSW-GNN loaded with the
benchmark's leaves, and runs its first `checked_steps` epochs through
`train_epoch()`, the window's own call: they warm every kernel up and are
the checked steps.  The first step's gradient is read from Adam's state
(exp_avg / (1 - beta1) after one step).
"""
from __future__ import annotations

import torch

from ..gen import trainable
from .conv_step import build_model


class Cell:
    def __init__(self, cfg: dict, wl: dict, inputs: dict, device):
        from fsw_gnn_tpu_torch import TrainConfig, Trainer
        from fsw_gnn_tpu_torch.data import NodeClassificationData
        model_cfg, train = cfg['model'], cfg['train']
        if train['optimizer'] != 'adam':
            raise ValueError('the Trainer steps Adam')
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
                           minimize_slice_coherence=False)
        self.trainer = Trainer(data, tcfg, device=device, model=model)
        params = dict(self.trainer.model.named_parameters())
        self.params = params
        b1 = float(train['betas'][0])
        outs = []
        # the first step's logits, as the Trainer's forward returns them
        hook = self.trainer.model.register_forward_hook(
            lambda module, args, out: outs.append(out.detach()))
        losses, grad = [], None
        for _ in range(int(wl['checked_steps'])):
            losses.append(self.trainer.train_epoch())
            hook.remove()
            if grad is None:
                state = self.trainer.opt.state
                grad = {k: (state[p]['exp_avg'].clone() / (1 - b1)
                            if 'exp_avg' in state.get(p, {})
                            else torch.zeros_like(p))
                        for k, p in params.items() if trainable(k)}
        self.first = {
            'losses': losses, 'out': outs[0], 'grad': grad,
            'change': {k: p.detach() - inputs['params'][k]
                       for k, p in params.items() if trainable(k)}}

    def call(self) -> int:
        self.trainer.train_epoch()
        return 1

    def leaves(self):
        return list(self.params.values())
