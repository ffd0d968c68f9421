"""The plain reference: the FSW-GNN's training steps in plain PyTorch,
computed from the edge list, in float64 (or, for the control, in float32
with every product's operands rounded to TF32).

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the same edge list, features, labels, masks and initial
leaves (`gen.py`) that it hands the program, and it works out the rest
itself (duplicates merged, in-degrees, the per-recipient order).

The FSW embedding of recipient r's in-neighbourhood {(x_j, w_j)} for slice
vector v and frequency f:

    emb = (1 + f) * sum_j p_(j) * 2 w_j sinc(f w_j) cos(pi f (2 c_j - w_j))

with p_(j) = <x_(j), v> sorted ascending (ties in edge order), w_j the
weights divided by max(total, 1) and c_j their inclusive cumsum in that
order (plus the phantom mass max(1 - total, 0) / max(total, 1) above zero);
the total mass times the degree scale is prepended.  An FSWConv appends the
recipient's own features and runs its MLP head (Linear, LeakyReLU(0.2)).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .gen import coalesce


def tf32_round(x):
    """x (float32) rounded to TF32's 10-bit mantissa, to nearest, as the
    tensor cores round a float32 operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b on TF32 operands, its backward's products too, as a float32
    product runs on the tensor cores with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).t(), tf32_round(a).t() @ g


class Arith:
    """The reference's arithmetic: dtype, and whether products round their
    operands to TF32 (the control)."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, a, b):
        if self.tf32:
            return _TF32Product.apply(a, b)
        return a @ b


class Graph:
    """The edge list as the aggregation sees it, on `device`: duplicates
    merged (weights summed), edges sorted by (recipient, sender)."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int, device):
        src, dst, w = coalesce(edge_index, num_nodes)
        self.src = torch.as_tensor(src, device=device)
        self.dst = torch.as_tensor(dst, device=device)
        self.weight = torch.as_tensor(w, device=device)
        self.num_nodes = num_nodes
        deg = np.bincount(dst, minlength=num_nodes)
        start = np.concatenate([[0], np.cumsum(deg)[:-1]])
        self.seg_start = torch.as_tensor(start, device=device)


def _slice_block(Xp_blk, f_blk, g: Graph, wn, pad_e):
    """(R, S_blk) FSW aggregation of projections Xp_blk (N, S_blk)."""
    P = Xp_blk[g.src].t()                                     # (S_blk, E)
    _, o1 = torch.sort(P, dim=1, stable=True)
    _, o2 = torch.sort(g.dst[o1], dim=1, stable=True)
    perm = torch.gather(o1, 1, o2)          # by recipient, then p, then edge
    ps = torch.gather(P, 1, perm)
    ws = wn[perm]
    cs = torch.cumsum(ws, dim=1)
    before = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], dim=1)
    c = cs - before[:, g.seg_start][:, g.dst]   # restart at each recipient
    c = c + pad_e * (ps > 0)
    f = f_blk[:, None]
    terms = ps * 2.0 * ws * torch.sinc(f * ws) * torch.cos(
        math.pi * f * (2.0 * c - ws))
    out = torch.zeros((P.shape[0], g.num_nodes), dtype=P.dtype,
                      device=P.device).index_add_(1, g.dst, terms)
    return ((1.0 + f) * out).t()


def fsw_embed(X, g: Graph, V, freqs, scale, ar: Arith, slice_block=None):
    """(N, 1 + S): the degree column, then the S slices' aggregation, in
    slice blocks of `slice_block` (each recomputed in the backward, so
    that a large graph fits)."""
    dt = X.dtype
    w = g.weight.to(dt)
    w_sum = torch.zeros(g.num_nodes, dtype=dt, device=X.device).index_add_(
        0, g.dst, w)
    w_pad = torch.clamp(w_sum, min=1.0)
    wn = w / w_pad[g.dst]
    pad_e = (torch.clamp(1.0 - w_sum, min=0.0) / w_pad)[g.dst]
    Xp = ar.mm(X, V.t())                                      # (N, S)
    S = V.shape[0]
    blk = slice_block or S
    parts = []
    for k in range(0, S, blk):
        args = (Xp[:, k:k + blk], freqs[k:k + blk], g, wn, pad_e)
        if blk < S and torch.is_grad_enabled():
            parts.append(checkpoint(_slice_block, *args, use_reentrant=False))
        else:
            parts.append(_slice_block(*args))
    return torch.cat([(w_sum * scale)[:, None]] + parts, dim=1)


def leaky(x):
    return torch.nn.functional.leaky_relu(x, negative_slope=0.2)


def fsw_conv(params, prefix, X, g, mlp_layers, ar: Arith, final_act=True,
             slice_block=None):
    """One FSWConv: the embedding, the recipient's own features appended,
    the MLP head (LeakyReLU after every layer, after the last one too
    where `final_act`)."""
    emb = fsw_embed(X, g, params[prefix + 'fsw_embed.proj_vecs'],
                    params[prefix + 'fsw_embed.freqs'],
                    params[prefix + 'fsw_embed.total_mass_scale'], ar,
                    slice_block)
    h = torch.cat([emb, X], dim=1)
    for i in range(mlp_layers):
        W = params[f'{prefix}head.dense.{i}.weight']
        b = params[f'{prefix}head.dense.{i}.bias']
        h = ar.mm(h, W.t()) + b
        if i < mlp_layers - 1 or final_act:
            h = leaky(h)
    return h


def forward(model: dict, params, X, g, ar: Arith, slice_block=None):
    """The configuration's model: one FSWConv, or an FSW-GNN whose last
    layer has no activation."""
    if model['kind'] == 'fsw_conv':
        return fsw_conv(params, '', X, g, model['mlp_layers'], ar,
                        slice_block=slice_block)
    n = len(model['hidden_dims']) + 1
    x = X
    for i in range(n):
        x = fsw_conv(params, f'convs.{i}.', x, g, model['mlp_layers'], ar,
                     final_act=i < n - 1, slice_block=slice_block)
    return x


def loss_of(train: dict, out, data):
    """The configuration's loss."""
    if train['loss'] == 'sum_sq_over_nodes':
        return (out * out).sum() / out.shape[0]
    if train['loss'] == 'masked_mean_cross_entropy':
        logp = torch.log_softmax(out, dim=-1)
        ll = torch.gather(logp, 1, data['labels'][:, None])[:, 0]
        mask = data['train_mask'].to(out.dtype)
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    raise ValueError(f"unknown loss {train['loss']!r}")


class Optimizer:
    """SGD, or Adam as torch.optim.Adam defines it, on a dict of leaves."""

    def __init__(self, train: dict, params: dict):
        self.train = train
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        tr = self.train
        lr = float(tr['lr'])
        self.t += 1
        with torch.no_grad():
            for k, g in grads.items():
                if tr['optimizer'] == 'sgd':
                    params[k] -= lr * g
                    continue
                b1, b2 = (float(b) for b in tr['betas'])
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = ((self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t))
                         + float(tr['eps']))
                params[k] -= (lr / (1 - b1 ** self.t)) * self.m[k] / denom


def train_steps(cfg: dict, inputs: dict, n_steps: int, ar: Arith,
                slice_block=None) -> dict:
    """`n_steps` training steps of the configuration from the benchmark's
    inputs (edge_index, features, labels, train_mask, init leaves,
    trainable names), on the inputs' device.  Returns the losses, the first
    step's forward output, the first step's gradient of every trainable
    leaf and every leaf's change after the last step, as float64
    tensors."""
    # products in the stated precision (the control rounds its own)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = ar.dtype
    dev = inputs['features'].device
    g = Graph(inputs['edge_index'], inputs['num_nodes'], dev)
    X = inputs['features'].to(dt)
    data = {k: torch.as_tensor(inputs[k], device=dev)
            for k in ('labels', 'train_mask') if k in inputs}
    p0 = {k: v.to(dt) for k, v in inputs['params'].items()}
    params = {k: v.clone() for k, v in p0.items()}
    names = [k for k in params if k in inputs['trainable']]
    opt = Optimizer(cfg['train'], {k: params[k] for k in names})
    losses, first_grad, first_out = [], None, None
    for _ in range(n_steps):
        leaves = {k: (v.detach().requires_grad_(k in names))
                  for k, v in params.items()}
        out = forward(cfg['model'], leaves, X, g, ar, slice_block)
        if first_out is None:
            first_out = out.detach().double()
        loss = loss_of(cfg['train'], out, data)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        grads = dict(zip(names, grads))
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: v.detach().double() for k, v in grads.items()}
        opt.step(params, grads)
        del loss, leaves, out
    return {'losses': losses, 'out': first_out, 'grad': first_grad,
            'change': {k: (params[k] - p0[k]).double() for k in names}}
