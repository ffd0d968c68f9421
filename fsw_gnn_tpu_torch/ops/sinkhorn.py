"""Doubly-stochastic projection and optimization on the Birkhoff polytope.

Counterpart of `fsw_gnn_tpu/ops/sinkhorn.py`: the doubly-stochastic graph
metric minimizes

    f(S) = ||A1 @ S - S @ A2||_F + lambda * <S, D>

over doubly-stochastic S (D the pairwise feature distances) by entropic
mirror descent: each step multiplies S by exp(-eta * grad f) and projects
back onto the Birkhoff polytope with log-domain Sinkhorn normalization.
The steps are the JAX package's: eta = lr / (1 + 0.01 i), the best
objective tracked from +inf, and the final minimum.

Plain tensor code, run eagerly on the inputs' device; every function
broadcasts over leading batch axes (the matrices are the last two).  The
products are `torch.matmul`.
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def sinkhorn_project(logS: torch.Tensor, n_iters: int = 50) -> torch.Tensor:
    """Project exp(logS) (..., n, n) onto the Birkhoff polytope
    (log-domain Sinkhorn: rows, then columns, `n_iters` times)."""
    for _ in range(n_iters):
        logS = logS - torch.logsumexp(logS, dim=-1, keepdim=True)
        logS = logS - torch.logsumexp(logS, dim=-2, keepdim=True)
    return torch.exp(logS)


def _structure(S, A1, A2, eps):
    """(R, ||R||_F regularized) with R = A1 S - S A2."""
    R = A1 @ S - S @ A2
    return R, torch.sqrt(torch.sum(R * R, dim=(-2, -1)) + eps)


def _objective(S, A1, A2, D, lam, use_squared_dists, eps):
    """f(S) over the leading axes: the structure term plus lam times the
    feature term (<S, D>, or sqrt(<S, D^2>) with use_squared_dists)."""
    _, structure = _structure(S, A1, A2, eps)
    if use_squared_dists:
        feature = torch.sqrt(torch.sum(S * (D * D), dim=(-2, -1)) + eps)
    else:
        feature = torch.sum(S * D, dim=(-2, -1))
    return structure + lam * feature


def _objective_grad(S, A1, A2, D, lam, use_squared_dists, eps):
    """The gradient of `_objective` in S, in closed form:
    (A1^T R - R A2^T) / ||R|| plus lam times D (or D^2 / (2 sqrt(<S,
    D^2>)))."""
    R, structure = _structure(S, A1, A2, eps)
    g = (A1.transpose(-2, -1) @ R - R @ A2.transpose(-2, -1)) \
        / structure[..., None, None]
    if use_squared_dists:
        D2 = D * D
        feature = torch.sqrt(torch.sum(S * D2, dim=(-2, -1)) + eps)
        return g + lam * D2 / (2.0 * feature[..., None, None])
    return g + lam * D


def dsmetric_solve(A1, V1, A2, V2, lambda_features=1.0,
                   use_squared_dists: bool = False,
                   n_outer: int = 500, n_sinkhorn: int = 30,
                   lr: float = 0.5, return_S: bool = False,
                   eps: float = 1e-12, *, device=None, dtype=None):
    """Solve the doubly-stochastic metric program on `device` (None: the
    card).

    A1, A2 (..., n, n) adjacency; V1, V2 (..., n, d) vertex features, as
    arrays or tensors, cast to `dtype` (None: a tensor's own floating type,
    else float32).  Returns the optimal objective (...,) (and S if
    return_S)."""
    dev = resolve_device(device)

    def cast(a):
        t = torch.as_tensor(a)
        dt = dtype if dtype is not None else (
            t.dtype if t.is_floating_point() else torch.float32)
        return t.to(device=dev, dtype=dt)

    A1, V1, A2, V2 = cast(A1), cast(V1), cast(A2), cast(V2)
    n = A1.shape[-1]
    diff = V1[..., :, None, :] - V2[..., None, :, :]
    D = torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
    args = (A1, A2, D, lambda_features, use_squared_dists, eps)

    lead = torch.broadcast_shapes(A1.shape[:-2], A2.shape[:-2], D.shape[:-2])
    logS = torch.zeros(lead + (n, n), dtype=A1.dtype, device=dev)
    best_obj = torch.full(lead, float('inf'), dtype=A1.dtype, device=dev)
    best_logS = logS
    for i in range(n_outer):
        S = sinkhorn_project(logS, n_sinkhorn)
        g = _objective_grad(S, *args)
        # mirror-descent step with mild decay
        eta = lr / (1.0 + 0.01 * i)
        log_S = torch.log(S + 1e-30)
        logS = log_S - eta * g
        obj = _objective(S, *args)
        better = obj < best_obj
        best_obj = torch.where(better, obj, best_obj)
        best_logS = torch.where(better[..., None, None], log_S, best_logS)
    S_best = sinkhorn_project(best_logS, n_sinkhorn)
    obj = torch.minimum(_objective(S_best, *args), best_obj)
    if return_S:
        return obj, S_best
    return obj


def dsmetric_batched(A1, V1, A2, V2, **kwargs):
    """`dsmetric_solve` over a leading batch axis (it broadcasts)."""
    return dsmetric_solve(A1, V1, A2, V2, **kwargs)
