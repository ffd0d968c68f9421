"""The collectives of the distributed paths, with their gradients.

`torch.distributed` collectives carry no autograd, so each one the model
runs through is an `autograd.Function` whose backward is the JAX
transpose of the JAX collective it replaces:

  * `all_gather_rows` (`lax.all_gather(tiled=True)`): rank r's rows of the
    gathered (P * n, ...) matrix; backward, every rank's cotangent of MY
    rows summed (`psum_scatter`), a reduce-scatter;
  * `all_to_all_rows` (`lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)`): block q of my (P, L, ...) input goes to rank q, which
    puts it at block r; the collective is its own transpose;
  * `all_reduce_mean` (`lax.pmean`): the mean over ranks; backward, the
    mean of the cotangents (a replicated cotangent passes through);
  * `start_all_gather`: an all-gather issued now (async_op=True) whose
    result, taken with `.wait()` where it is needed, joins autograd as
    `all_gather_rows` does.  On NCCL the wait orders the compute stream
    after the collective, with no host synchronisation.
Every collective runs over the default process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_gather_into(out, x, async_op=False):
    # torch 2.13 renames the collective; older versions (the card's) have
    # only the first name
    fn = (getattr(dist, 'all_gather_single', None)
          or dist.all_gather_into_tensor)
    return fn(out, x, async_op=async_op)


def _reduce_scatter(g):
    """My rows of the sum over the ranks of (P * n, ...) `g`."""
    fn = (getattr(dist, 'reduce_scatter_single', None)
          or dist.reduce_scatter_tensor)
    out = g.new_empty((g.shape[0] // dist.get_world_size(),)
                      + tuple(g.shape[1:]))
    fn(out, g.contiguous())
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.new_empty((dist.get_world_size() * x.shape[0],)
                          + tuple(x.shape[1:]))
        _all_gather_into(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g)


def all_gather_rows(x):
    """(P * n, ...) of every rank's (n, ...) rows in rank order."""
    return _AllGather.apply(x)


class _Gathered(torch.autograd.Function):
    """The result of an all-gather started on `x` (the rows of one chunk):
    the forward waits for it, the backward reduce-scatters as
    `_AllGather`'s."""

    @staticmethod
    def forward(ctx, x, pending):
        pending.work.wait()
        return pending.out

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g), None


class PendingGather:
    """An all-gather of `x`'s rows in flight; `wait()` gives the gathered
    (P * n, ...) tensor, which takes a gradient to `x`."""

    def __init__(self, x):
        self.x = x.contiguous()
        self.out = x.new_empty((dist.get_world_size() * x.shape[0],)
                               + tuple(x.shape[1:]))
        self.work = _all_gather_into(self.out, self.x.detach(),
                                     async_op=True)

    def wait(self):
        return _Gathered.apply(self.x, self)


def start_all_gather(x) -> PendingGather:
    return PendingGather(x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S):
        recv = torch.empty_like(S)
        dist.all_to_all_single(recv, S.contiguous())
        return recv

    @staticmethod
    def backward(ctx, g):
        back = torch.empty_like(g)
        dist.all_to_all_single(back, g.contiguous())
        return back


def all_to_all_rows(S):
    """S (P, L, ...): block q to rank q; returns (P, L, ...) whose block q
    came from rank q."""
    return _AllToAll.apply(S)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g / dist.get_world_size()


def all_reduce_mean(x):
    """The mean of `x` over the ranks, on every rank, differentiable."""
    return _AllReduceMean.apply(x)


def all_reduce_sum(x):
    """The sum of `x` over the ranks (a new tensor; no gradient)."""
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the ranks in place (JAX's psum
    of the gradient tree), one collective per dtype; a parameter with no
    gradient on this rank takes zeros."""
    by_dtype = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        k = 0
        for g in grads:
            g.copy_(flat[k:k + g.numel()].view_as(g))
            k += g.numel()


def average_running_stats(module: torch.nn.Module) -> None:
    """The mean over the ranks of every BatchNorm's running statistics
    (JAX's pmean of the mutated 'batch_stats' collection)."""
    P = dist.get_world_size()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                for b in (m.running_mean, m.running_var):
                    dist.all_reduce(b)
                    b.div_(P)
