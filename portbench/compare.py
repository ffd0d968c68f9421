"""The comparison that decides `correct`: the program's first training
steps against the reference's.

Four numbers, each held to a limit the cell's workload file states:
  * `loss`: the relative gap between the program's and the reference's
    loss of the first step (the later steps' losses carry the noise of
    float32 leaves and of Adam's sign on gradients near zero, PERF.md;
    `detail` gives every step's);
  * `out`: the first step's forward output (the logits), by the worst
    row: |row(program) - row(reference)| over the larger of the
    reference's norm of that row and of the median row;
  * `grad`: the first step's gradient as the optimizer got it, by the
    worst leaf: |norm(program) - norm(reference)| over the larger of the
    reference's norm of that leaf and of the median leaf;
  * `change`: each leaf's change after the checked steps, by the worst
    leaf in the same way; leaves whose reference gradient is below a
    thousandth of the median leaf's (nought to rounding, which Adam moves
    by round-off alone) are left out.
Besides, `nonfinite` counts the leaves that hold a NaN or an infinity after
the measured window (limit 0).
"""
from __future__ import annotations

import statistics

import torch

NOUGHT = 1e-3       # a leaf's gradient below this share of the median's


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _worst(values) -> float:
    """The largest value; infinity where any is a NaN."""
    values = list(values)
    return float('inf') if any(v != v for v in values) else max(values)


def worst_leaf(got: dict, want: dict, keep=None) -> float:
    """max over leaves of |norm(got) - norm(want)| / max(norm(want), the
    median leaf's norm(want))."""
    g, w = _norms(got), _norms(want)
    keys = [k for k in w if keep is None or k in keep]
    med = statistics.median(w[k] for k in keys)
    return _worst(abs(g.get(k, 0.0) - w[k]) / max(w[k], med, 1e-300)
                  for k in keys)


def worst_row(got, want) -> float:
    """max over rows of |got_r - want_r| / max(|want_r|, the median row's
    |want_r|); infinity where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return float('inf')
    want = want.double()
    diff = torch.linalg.vector_norm(got.double() - want, dim=1)
    norm = torch.linalg.vector_norm(want, dim=1)
    scale = torch.clamp(norm, min=float(norm.median()))
    return _worst([float((diff / torch.clamp(scale, min=1e-300)).max())])


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of the program's first steps (`prog`: losses,
    grad, change) against the reference's."""
    a, b = prog['losses'][0], ref['losses'][0]
    loss = _worst([abs(a - b) / max(abs(b), 1e-300)])
    if len(prog['losses']) != len(ref['losses']):
        loss = float('inf')
    gn = _norms(ref['grad'])
    med = statistics.median(gn.values())
    moved = {k for k, v in gn.items() if v >= NOUGHT * med}
    return {'loss': loss,
            'out': worst_row(prog['out'], ref['out']),
            'grad': worst_leaf(prog['grad'], ref['grad']),
            'change': worst_leaf(prog['change'], ref['change'], moved)}


def detail(prog: dict, ref: dict) -> dict:
    """What the numbers are made of, for a look at their causes: each
    step's loss gap, and each leaf's gap in the gradient and the change
    (relative to the larger of its own and the median leaf's norm)."""
    def leaves(got, want):
        g, w = _norms(got), _norms(want)
        med = statistics.median(w.values())
        return {k: (g.get(k, 0.0) - w[k]) / max(w[k], med, 1e-300)
                for k in w}
    return {'loss_steps': [(a - b) / max(abs(b), 1e-300) for a, b in
                           zip(prog['losses'], ref['losses'])],
            'grad_leaves': leaves(prog['grad'], ref['grad']),
            'change_leaves': leaves(prog['change'], ref['change'])}


def judge(values: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(values[k] <= limits[k] for k in limits)
