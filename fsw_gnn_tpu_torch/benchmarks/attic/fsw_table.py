"""Kernel A1: the table-layout FSW forward by a sorting network.

Counterpart of benchmarks/attic/fsw_table_pallas.py.  For every recipient r
and slice s of a dense neighbour table:

    out[r, s] = (1 + f_s) sum_b ps 2 ws sinc(f_s ws) cos(pi f_s (2c - ws))

where (ps, ws) are the row's entries sorted by projection value along the
bucket and c is the inclusive cumsum of ws plus the phantom-mass shift
pad_norm[r] 1[ps > 0].  The JAX package keeps this kernel in its attic,
wired into no route; so does the port: no route of the package calls it,
and only this module and the benchmark scripts reach it.

Scope, as the TPU kernel's: not cartesian, no edge features, float32, the
bucket width B a power of two.  A width that is not one, or whose pairs do
not fit a block's shared memory (B above 1024,
`ops.fsw_rank.smem_bytes('fsw_table_sort', B)`), raises `KernelError`
before any launch.

`fsw_table_sort` runs the kernel (csrc/fsw_table_sort.cu) on P (R, B, S)
already gathered on CUDA tensors, the plain version on CPU tensors, and
counts its launches; `fsw_table_forward` gathers P = Xp[idx] with a
PyTorch index first, as the TPU kernel gathers outside Pallas.  The plain
versions repeat the TPU kernel's formula: its bitonic network
(`sort_pairs_plain`, so tied projections keep the same weights), the
cumsum, the shift, the mod-1 range-reduced trig and the sum over B.
"""
from __future__ import annotations

import math

import torch

from ...kernels import KernelError
from ...ops.fsw_rank import (_MAX_SMEM, _check, _count, _kernel, _launch,
                               smem_bytes)


def sort_pairs_plain(ps, ws):
    """Bitonic sort of ps (R, B, S) ascending along axis 1, carrying ws
    (the same shape): the network of `_sort_pairs_along_b`.  At merge size
    k and distance j each position i meets its partner i ^ j; the pair is
    swapped where (lower > upper) equals the block's direction (ascending
    where i & k == 0), so ties in descending blocks swap and the multiset
    of (p, w) pairs is kept."""
    B = ps.shape[1]
    if B & (B - 1):
        raise KernelError(f'A1: bucket width {B} is not a power of two')
    pos = torch.arange(B, device=ps.device).view(1, B, 1)
    k = 2
    while k <= B:
        asc = (pos & k) == 0
        j = k // 2
        while j >= 1:
            partner = (pos ^ j).expand_as(ps)
            low = (pos & j) == 0
            pp, wp = ps.gather(1, partner), ws.gather(1, partner)
            lower = torch.where(low, ps, pp)
            upper = torch.where(low, pp, ps)
            swap = (lower > upper) == asc
            ps, ws = torch.where(swap, pp, ps), torch.where(swap, wp, ws)
            j //= 2
        k *= 2
    return ps, ws


def fsw_table_sort_plain(P, wn, pad_norm, freqs):
    """Plain PyTorch version of A1 on P (R, B, S) already gathered: the
    formula of `_fsw_table_kernel`.  wn (R, B), pad_norm (R,), freqs (S,);
    returns (R, S).  Any float dtype."""
    ps, ws = sort_pairs_plain(P, wn[:, :, None].expand_as(P))
    c = torch.cumsum(ws, dim=1)
    c = c + torch.where(ps > 0, pad_norm[:, None, None], torch.zeros_like(c))
    f = freqs[None, None, :]
    u_cos = 0.5 * f * (2.0 * c - ws)
    u_cos = u_cos - torch.round(u_cos)
    cos_t = torch.cos((2.0 * math.pi) * u_cos)
    x = f * ws
    u_sin = 0.5 * x
    u_sin = u_sin - torch.round(u_sin)
    sin_t = torch.sin((2.0 * math.pi) * u_sin)
    zero = x == 0.0
    sinc_t = torch.where(zero, torch.ones_like(x),
                         sin_t / (math.pi * x + zero.to(x.dtype)))
    sd = 2.0 * ws * sinc_t * cos_t
    return (1.0 + freqs) * torch.sum(ps * sd, dim=1)


def _width_fits(B: int):
    """KernelError unless A1's block holds width B."""
    if B < 2 or B & (B - 1):
        raise KernelError(f'A1: bucket width {B} is not a power of two >= 2')
    need = smem_bytes('fsw_table_sort', B)
    if need > _MAX_SMEM:
        raise KernelError(f'A1: bucket width {B} needs {need} bytes of '
                          f'shared memory, above the {_MAX_SMEM} a block '
                          f'has')


def fsw_table_sort(P, wn, pad_norm, freqs):
    """A1 on P (R, B, S) already gathered; wn (R, B) normalized weights;
    pad_norm (R,); freqs (S,).  Returns (R, S).  CPU tensors: the plain
    version.  CUDA tensors: the kernel (float32, contiguous), each launch
    adding one to `fsw_table_sort.launches`; a width it cannot take raises
    KernelError before the launch.  Forward only, as the TPU kernel."""
    R, B, S = P.shape
    if P.device.type == 'cpu':
        if B & (B - 1):
            raise KernelError(f'A1: bucket width {B} is not a power of two')
        return fsw_table_sort_plain(P, wn, pad_norm, freqs)
    if P.device.type != 'cuda':
        raise ValueError(f'unsupported device {P.device}')
    _width_fits(B)
    _check(list(zip(('P', 'wn', 'pad_norm', 'freqs'),
                    (P, wn, pad_norm, freqs))),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,)})
    out = torch.empty((R, S), dtype=torch.float32, device=P.device)
    if R == 0 or S == 0:
        return out
    _launch('fsw_table_sort', _kernel('fsw_table_sort')[0], P, wn, pad_norm,
            freqs, out, R, B, S)
    _count(fsw_table_sort)
    return out


fsw_table_sort.launches = 0


def fsw_table_forward(idx, wn, pad_norm, Xp, freqs):
    """out (R, S): the FSW aggregation over a dense neighbour table.

    idx (R, B) integer sender indices; wn (R, B) normalized weights;
    pad_norm (R,); Xp (N, S) projections; freqs (S,).  The row gather
    P = Xp[idx] is a PyTorch index, then `fsw_table_sort` (A1 on the card,
    its plain version on the CPU)."""
    R, B = idx.shape
    P = Xp[idx.reshape(-1).long()].reshape(R, B, Xp.shape[1])
    return fsw_table_sort(P.contiguous(), wn, pad_norm, freqs)


def fsw_table_forward_plain(idx, wn, pad_norm, Xp, freqs):
    """The plain version of `fsw_table_forward` on any device."""
    R, B = idx.shape
    P = Xp[idx.reshape(-1).long()].reshape(R, B, Xp.shape[1])
    return fsw_table_sort_plain(P, wn, pad_norm, freqs)
