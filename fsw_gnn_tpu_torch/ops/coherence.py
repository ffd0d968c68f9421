"""Mutual-coherence minimization of a frame of unit vectors.

Counterpart of fsw_gnn_tpu/ops/coherence.py: a p-norm surrogate schedule
(p = 3 ... 1e13) of projected gradient descent with an adaptive step
size, minimizing the largest off-diagonal Gram entry (the mutual
coherence) of the rows of a matrix.

Each p-stage keeps the JAX package's state machine (its `lax.while_loop`
carry): a seek phase that doubles the step while the objective keeps
falling, with a stash of the best solution, then a backtrack to that stash;
strikes for low improvement, counted on accepted steps only; a stop at the
minimum step, on a step that does not improve; at most 1000 iterations;
and the whole stage reverted when the coherence did not fall.  Here the
loop runs eagerly: one host sync an iteration reads the step's decisions,
computed on the device in the frame's dtype.  The two products of an
iteration are `torch.matmul`, as the JAX package leaves them to XLA.
Everything runs in the input's dtype on the input's device.
"""
from __future__ import annotations

import torch

P_SCHEDULE = (3., 6., 10., 20., 50., 100., 200., 500., 1000., 2000., 5000.,
              1e4, 2e4, 5e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12, 1e13)

_STEP_INIT = 2000.0
_N_ITER_MAX = 1000
_IMPROVEMENT_THRESH = 1e-4
_STEP_MIN = 1e-5
_STEP_MAX = 1e10
_MAX_LOW_IMPROVEMENTS = 5
_STEP_DECREASE = 0.5


def _normalize_rows(X):
    return X / torch.linalg.norm(X, dim=1, keepdim=True)


def gram_offdiag(X):
    """Gram matrix X X^T with its diagonal zeroed."""
    G = X @ X.t()
    return G - torch.diag(torch.diag(G))


def mutual_coherence(X):
    """Max |off-diagonal Gram entry| of the row-normalized frame X."""
    return torch.max(torch.abs(gram_offdiag(_normalize_rows(X))))


def _eval_G(G, p, n):
    """(mu, objective) of an off-diagonal Gram matrix at the surrogate's
    exponent p (a 0-d tensor of G's dtype)."""
    mu = torch.max(torch.abs(G))
    rho = 1.0 / (2.0 * n * (n - 1.0))
    obj = mu * torch.pow(rho * torch.sum(torch.pow(torch.abs(G / mu), p)),
                         1.0 / p)
    return mu, obj


def _minimize_p(X_init, p: float, step_size_init: float):
    """One p-stage from the unit rows X_init.  Returns (X, step,
    iterations, kept): the stage's frame and step size (X_init and
    step_size_init when the coherence did not fall, kept False)."""
    n = X_init.shape[0]
    dt, dev = X_init.dtype, X_init.device
    p = torch.tensor(p, dtype=dt, device=dev)
    rho = torch.pow(torch.tensor(1.0 / (2.0 * n * (n - 1.0)), dtype=dt,
                                 device=dev), 1.0 / p)
    ones = torch.ones((n, 1), dtype=dt, device=dev)

    X, G = X_init, gram_offdiag(X_init)
    mu, obj = _eval_G(G, p, n)
    mu0 = mu
    step = step_size_init
    low_cnt = 0
    finished_init = False
    step_init_best = step_size_init
    obj_best_seek = torch.tensor(float('inf'), dtype=dt, device=dev)
    Xb, Gb, objb, mub = X, G, obj, mu      # the seek phase's stash
    i = 1
    done = False
    while i <= _N_ITER_MAX and not done:
        # gradient of the p-norm surrogate at the current frame
        Gn = G / mu
        absGn = torch.abs(Gn)
        Gp = torch.pow(absGn, p)
        son = torch.sum(Gp)
        grad = rho / torch.pow(son, 1.0 - 1.0 / p) * (
            (torch.pow(absGn, p - 1.0) * torch.sign(Gn)) @ X
            - (Gp @ (mu * ones)) * X)
        X_new = _normalize_rows(X - step * grad)
        G_new = gram_offdiag(X_new)
        mu_new, obj_new = _eval_G(G_new, p, n)

        # the iteration's decisions, in G's dtype, in one sync: improved,
        # better than the seek's best, and low improvement for each
        # candidate that may be accepted (the new frame or the stash)
        improved, better_seek, low_new, low_stash = torch.stack([
            obj_new < obj, obj_new < obj_best_seek,
            (obj - obj_new) / (1.0 - obj) <= _IMPROVEMENT_THRESH,
            (obj - objb) / (1.0 - obj) <= _IMPROVEMENT_THRESH]).tolist()
        i += 1
        if not improved:
            if finished_init:
                # shrink the step, or stop at the minimum
                if step * _STEP_DECREASE >= _STEP_MIN:
                    step = step * _STEP_DECREASE
                else:
                    done = True
            else:
                # the seek ends: settle on its best step
                step = step_init_best
                finished_init = True
            continue
        grow = better_seek and step / _STEP_DECREASE <= _STEP_MAX
        if not finished_init and grow:
            # record the best, stash it, try a larger step; accept nothing
            obj_best_seek = obj_new
            step_init_best = step
            step = step / _STEP_DECREASE
            Xb, Gb, objb, mub = X_new, G_new, obj_new, mu_new
            continue
        if finished_init:
            X, G, mu, obj, low = X_new, G_new, mu_new, obj_new, low_new
        else:
            # the seek ends: backtrack to the stash, at its best step
            X, G, mu, obj, low = Xb, Gb, mub, objb, low_stash
            step = step_init_best
            finished_init = True
        low_cnt = low_cnt + 1 if low else 0
        done = low_cnt >= _MAX_LOW_IMPROVEMENTS

    if bool(mu < mu0):
        return X, step, i - 1, True
    return X_init, step_size_init, i - 1, False


def minimize_mutual_coherence(X_init):
    """Minimize the mutual coherence of the rows of X_init; returns the
    unit-row frame, in X_init's dtype and on its device."""
    if X_init.numel() == 0:
        return X_init
    if X_init.shape[0] == 1:
        return _normalize_rows(X_init)
    X = _normalize_rows(X_init)
    step = _STEP_INIT
    for p in P_SCHEDULE:
        X, step, _, _ = _minimize_p(X, p, step)
    return X
