"""Faults planted in the program underneath a run, for the tests and the
calibration (never in a benchmark run): each must make `correct` false.

  frozen_state    the optimizer's step returns the state unchanged;
  half_batch      half of the batch left out, the mean taken over the rest
                  (the trainers' loss over the first half of the rows its
                  mask holds: the train nodes, or a sampled batch's seeds;
                  a single FSWConv's output cut to its first half of rows);
  altered_answer  an answer altered where it is produced: the FSW
                  embedding's row of recipient 0 moved by 1.
The exchange between chips does not exist in a one-chip cell.
"""
from __future__ import annotations

import contextlib

FAULTS = ('frozen_state', 'half_batch', 'altered_answer')


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(fault: str, cfg: dict):
    """A context manager that plants `fault` in the program for a cell of
    configuration `cfg`."""
    import torch

    from fsw_gnn_tpu_torch import FSWConv
    from fsw_gnn_tpu_torch.modules import FSWEmbedding
    from fsw_gnn_tpu_torch.train import minibatch, trainer
    stack = contextlib.ExitStack()
    if fault == 'frozen_state':
        for cls in (torch.optim.SGD, torch.optim.Adam):
            stack.enter_context(_patched(cls, 'step',
                                         lambda self, closure=None: None))
    elif fault == 'half_batch':
        if cfg['train']['loss'] == 'masked_mean_cross_entropy':
            ce = trainer.masked_softmax_cross_entropy

            def half_ce(logits, labels, mask):
                rows = torch.nonzero(mask).flatten()
                mask = mask.clone()
                mask[rows[rows.shape[0] // 2:]] = 0
                return ce(logits, labels, mask)
            for module in (trainer, minibatch):
                stack.enter_context(_patched(
                    module, 'masked_softmax_cross_entropy', half_ce))
        else:
            fwd = FSWConv.forward

            def half_rows(self, *args, **kwargs):
                out = fwd(self, *args, **kwargs)
                return out[:out.shape[0] // 2]
            stack.enter_context(_patched(FSWConv, 'forward', half_rows))
    elif fault == 'altered_answer':
        emb = FSWEmbedding.forward

        def altered(self, *args, **kwargs):
            out = emb(self, *args, **kwargs)
            shift = torch.zeros_like(out)
            shift[0] = 1.0
            return out + shift
        stack.enter_context(_patched(FSWEmbedding, 'forward', altered))
    else:
        raise ValueError(f'unknown fault {fault!r}')
    return stack
