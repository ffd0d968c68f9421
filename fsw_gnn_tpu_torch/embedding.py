"""Fourier Sliced-Wasserstein embedding on neighbor-table layouts.

Counterpart of the table path of `fsw_gnn_tpu/embedding.py`.  The embedding
of a weighted neighborhood {(x_j, w_j)} for slice vector v and frequency f
is

    emb = (1 + f) * sum_j p_(j) * 2 w_j sinc(f w_j) cos(pi f (2 c_j - w_j))

with p_(j) = <x_(j), v> sorted ascending and c_j the inclusive cumsum of the
normalized weights in that order.  A neighborhood whose total mass is below
`total_mass_pad_thresh` gets a phantom point at the origin carrying the
deficit; its only effects are the normalization and the shift
c_j += pad_norm * 1[p_(j) > 0].

Two aggregations:
  'sort': a stable sort along the bucket axis, then a cumsum (any dtype);
  'rank': the fused-projection kernel (ops/fsw_rank.py), which needs no
          sort, computes in float32 and casts back.
'auto' takes 'rank' wherever the fused-projection route applies (not
cartesian, d_in + d_edge below the slice count), on the CPU and on the card
alike, and 'sort' elsewhere.  The crossover rules the JAX package measured
on its own hardware are not carried over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from .ops.fsw_rank import fsw_rank_aggregate_proj

_K2_TODO = ('the unfused rank kernel (K2 in ROADMAP.md, fsw_rank_aggregate) '
            'is not ported yet')
_K4_TODO = ('the cartesian rank kernel (K4 in ROADMAP.md, '
            'fsw_rank_aggregate_cart) is not ported yet')


@dataclasses.dataclass(frozen=True)
class FSWConfig:
    """Static configuration of an FSW embedding.

    Exactly one of `d_out` or (`n_slices`, `n_freqs`) is given; the latter
    selects cartesian mode."""
    d_in: int
    d_out: Optional[int] = None
    n_slices: Optional[int] = None
    n_freqs: Optional[int] = None
    collapse_freqs: bool = False
    d_edge: int = 0
    encode_total_mass: bool = False
    total_mass_encoding_function: str = 'identity'   # identity | sqrt | log
    total_mass_encoding_scale: float = 1.0
    total_mass_encoding_method: str = 'plain'        # plain | homog | homog_alt
    total_mass_pad_thresh: float = 1.0
    learnable_slices: bool = False
    learnable_freqs: bool = False
    learnable_total_mass_encoding_scale: bool = False
    freqs_init: Union[float, int, str, Tuple[float, float]] = 'random'
    minimize_slice_coherence: bool = False
    enable_bias: bool = True

    def __post_init__(self):
        if self.d_in < 0 or self.d_edge < 0:
            raise ValueError('d_in and d_edge must be >= 0')
        if self.total_mass_encoding_method not in ('plain', 'homog',
                                                   'homog_alt'):
            raise ValueError('total_mass_encoding_method must be plain, '
                             'homog or homog_alt')
        if self.total_mass_encoding_function not in ('identity', 'sqrt',
                                                     'log'):
            raise ValueError('total_mass_encoding_function must be '
                             'identity, sqrt or log')
        if not self.total_mass_pad_thresh > 0:
            raise ValueError('total_mass_pad_thresh must be > 0')
        if (self.d_out is not None and self.n_slices is None
                and self.n_freqs is None):
            pass
        elif (self.d_out is None and self.n_slices is not None
              and self.n_freqs is not None):
            if not (self.collapse_freqs or not self.encode_total_mass):
                raise ValueError('Cartesian mode with collapse_freqs=False '
                                 'does not support encode_total_mass=True')
        else:
            raise ValueError('Give exactly one of d_out or '
                             '(n_slices, n_freqs)')
        if self.d_out == 0:
            object.__setattr__(self, 'encode_total_mass', False)

    @property
    def cartesian_mode(self) -> bool:
        return self.d_out is None

    @property
    def total_mass_dim(self) -> int:
        return 1 if self.encode_total_mass else 0

    @property
    def nSlices(self) -> int:
        if self.cartesian_mode:
            return self.n_slices
        return self.d_out - self.total_mass_dim

    @property
    def nFreqs(self) -> int:
        if self.cartesian_mode:
            return self.n_freqs
        return self.d_out - self.total_mass_dim

    @property
    def out_dim(self) -> int:
        if self.cartesian_mode:
            return self.n_slices * self.n_freqs + self.total_mass_dim
        return self.d_out

    @property
    def proj_dim(self) -> int:
        return self.d_in + self.d_edge


class _LowClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, thresh):
        ctx.save_for_backward(x)
        ctx.thresh = thresh
        return torch.clamp(x, min=thresh)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= ctx.thresh, g, torch.zeros_like(g)), None


def lowclamp(x, thresh: float):
    """`max(x, thresh)` whose gradient is 1 at the threshold itself (the
    active set is x >= thresh)."""
    return _LowClamp.apply(x, float(thresh))


def _sinc_diff(ws, c, freqs):
    """2 w sinc(f w) cos(pi f (2c - w)) for broadcastable ws, c, freqs."""
    return 2.0 * ws * torch.sinc(freqs * ws) * torch.cos(
        math.pi * freqs * (2.0 * c - ws))


def _total_mass_value(w_sum, cfg: FSWConfig):
    """f(total mass) per `total_mass_encoding_function`."""
    if cfg.total_mass_encoding_function == 'identity':
        return w_sum
    if cfg.total_mass_encoding_function == 'sqrt':
        # sqrt(1+x) - 1 without cancellation
        return 2.0 * (w_sum / (torch.sqrt(w_sum + 1.0) + 1.0))
    return torch.log1p(w_sum)


def _homog_alt_part1(tm):
    return torch.where(tm <= 1, tm * (2 - tm), torch.ones_like(tm))


def _homog_alt_part2(tm):
    return torch.where(tm <= 1, tm * tm, 2 * tm - 1)


def _append_total_mass(emb, w_sum, scale, cfg: FSWConfig):
    """Prepend the encoded total mass along the last axis."""
    tm = (_total_mass_value(w_sum, cfg) * scale)[..., None]
    if cfg.total_mass_encoding_method == 'plain':
        return torch.cat([tm, emb], dim=-1)
    emb_norm = torch.mean(torch.abs(emb), dim=-1, keepdim=True)
    if cfg.total_mass_encoding_method == 'homog':
        return torch.cat([tm * emb_norm, emb], dim=-1)
    return torch.cat([_homog_alt_part1(tm) * emb_norm,
                      _homog_alt_part2(tm) * emb], dim=-1)


def _finalize(emb, w_sum, cfg: FSWConfig, bias, total_mass_scale):
    """Collapse, total-mass augmentation, bias."""
    if cfg.cartesian_mode and cfg.collapse_freqs:
        emb = emb.reshape(emb.shape[:-2] + (emb.shape[-2] * emb.shape[-1],))
    if cfg.encode_total_mass:
        scale = (total_mass_scale if total_mass_scale is not None else
                 torch.tensor(cfg.total_mass_encoding_scale,
                              dtype=emb.dtype, device=emb.device))
        emb = _append_total_mass(emb, w_sum, scale, cfg)
    if cfg.enable_bias and bias is not None:
        emb = emb + bias
    return emb


def _resolve_aggregate(aggregate: str, cfg: FSWConfig, s_eff: int) -> str:
    """'sort' or 'rank' for one table.  'rank' here always means the
    fused-projection kernel; where that route does not apply, 'rank' would
    need K2 (or K4 in cartesian mode), which is not ported."""
    if aggregate not in ('auto', 'sort', 'rank'):
        raise ValueError(f"aggregate must be 'auto'|'sort'|'rank', "
                         f"got {aggregate!r}")
    fused = not cfg.cartesian_mode and cfg.proj_dim < s_eff
    if aggregate == 'auto':
        return 'rank' if fused else 'sort'
    if aggregate == 'rank' and not fused:
        raise NotImplementedError(_K4_TODO if cfg.cartesian_mode
                                  else _K2_TODO)
    return aggregate


def bucket_quadrature(P, wn, pad_norm, f_block, cfg: FSWConfig, agg: str,
                      weights_grad: bool = True, uniform_w: bool = False):
    """Per-neighborhood FSW aggregation on pre-gathered projections.

    P (R, B, S_blk); wn (R, B); pad_norm (R,); f_block (S_blk,) (or
    (S_blk, F) in cartesian mode).  `agg` is resolved: 'sort' (stable sort
    + cumsum) or 'rank' (the unfused kernel K2 / cartesian K4, not ported
    yet).  Returns (R, S_blk) (or (R, S_blk, F))."""
    if agg == 'rank':
        raise NotImplementedError(_K4_TODO if cfg.cartesian_mode
                                  else _K2_TODO)
    keys = P.transpose(1, 2)                                   # (R, S, B)
    ps, order = torch.sort(keys, dim=2, stable=True)
    ws = torch.gather(wn[:, None, :].expand(keys.shape), 2, order)
    c = torch.cumsum(ws, dim=2) + pad_norm[:, None, None] * (ps > 0)
    if cfg.cartesian_mode:
        sd = _sinc_diff(ws[..., None], c[..., None],
                        f_block[:, None, :])                   # (R, S, B, F)
        emb = torch.einsum('rsb,rsbf->rsf', ps, sd)
        return (1.0 + f_block) * emb                           # (R, S, F)
    sd = _sinc_diff(ws, c, f_block[:, None])                   # (R, S, B)
    return (1.0 + f_block) * torch.sum(ps * sd, dim=2)         # (R, S)


def table_weights(w, cfg: FSWConfig):
    """(w_sum, wn, pad_norm) of an (R, B) weight table: the total mass, the
    weights normalized by max(total, thresh), and the phantom mass
    max(thresh - total, 0) in the same units."""
    w_sum = torch.sum(w, dim=-1)                               # (R,)
    w_sum_padded = lowclamp(w_sum, cfg.total_mass_pad_thresh)
    pad_norm = lowclamp(cfg.total_mass_pad_thresh - w_sum, 0.0) / w_sum_padded
    return w_sum, w / w_sum_padded[:, None], pad_norm


def gather_rows(X, table, cfg: FSWConfig):
    """The (R, B, d_in + d_edge) sender rows of a table: X gathered by
    `table.idx`, edge features appended."""
    Z = X[table.idx]                                           # (R, B, d_in)
    if cfg.d_edge > 0:
        if table.edge_feat is None:
            raise ValueError('the table has no edge features')
        Z = torch.cat([Z, table.edge_feat.to(Z.dtype)], dim=-1)
    return Z


def fsw_embed_table(X, table, projVecs, freqs, cfg: FSWConfig,
                    bias=None, total_mass_scale=None,
                    slice_chunk: Optional[int] = None,
                    return_raw: bool = False,
                    aggregate: str = 'auto',
                    weights_grad: bool = True):
    """Embed neighborhoods given as a dense `NeighborTable` (tensors on
    X's device).

    X (num_nodes, d_in).  Returns (num_recipients, d_out) (or
    (R, nSlices, nFreqs) in non-collapsed cartesian mode); with
    return_raw=True, (emb before finalize, w_sum).  `slice_chunk` bounds
    the slice width processed at once.  `weights_grad=False` declares the
    table weights data, not parameters: the rank route then gives them no
    gradient (the kernel skips that loop), and only then is
    `table.uniform_w` honoured (the flag is detected once, at build
    time)."""
    dt = X.dtype
    S = cfg.nSlices
    s_eff = S if slice_chunk is None else min(slice_chunk, S)
    agg = _resolve_aggregate(aggregate, cfg, s_eff)
    w_sum, wn, pad_norm = table_weights(table.weight, cfg)

    # the fused-projection route gathers the raw sender rows (R, B, D) and
    # projects inside the kernel; Z is built once for every slice chunk
    use_proj = agg == 'rank'
    unif = bool(table.uniform_w) and not weights_grad
    if use_proj:
        f32 = torch.float32
        Z32 = gather_rows(X, table, cfg).to(f32).contiguous()
        wn32 = wn.to(f32).contiguous()
        pad32 = pad_norm.to(f32).contiguous()

    def slices_block(proj_block, f_block):
        """proj_block: (S_blk, d_in + d_edge) slice vectors; f_block."""
        if use_proj:
            out = fsw_rank_aggregate_proj(
                Z32, wn32, pad32, f_block.to(torch.float32).contiguous(),
                proj_block.t().to(torch.float32).contiguous(),
                uniform_w=unif, with_dw=weights_grad)
            return out.to(dt)                                  # (R, S_blk)
        Xp = X @ proj_block[:, :cfg.d_in].t()                  # (N, S_blk)
        P = Xp[table.idx]                                      # (R, B, S_blk)
        if cfg.d_edge > 0:
            if table.edge_feat is None:
                raise ValueError('the table has no edge features')
            P = P + table.edge_feat @ proj_block[:, cfg.d_in:].t()
        return bucket_quadrature(P, wn, pad_norm, f_block, cfg, agg,
                                 weights_grad, uniform_w=unif)

    slice_freqs = (freqs.expand((S,) + tuple(freqs.shape))
                   if cfg.cartesian_mode else freqs)
    if slice_chunk is None or slice_chunk >= S:
        emb = slices_block(projVecs, slice_freqs)
    else:
        # zero-padded slices have f = 0 and a zero slice vector: they
        # contribute exact zeros and are cut off again
        n_chunks = -(-S // slice_chunk)
        S_pad = n_chunks * slice_chunk
        V_pad = torch.nn.functional.pad(projVecs, (0, 0, 0, S_pad - S))
        f_pad = torch.cat([slice_freqs, slice_freqs.new_zeros(
            (S_pad - S,) + tuple(slice_freqs.shape[1:]))])
        emb = torch.cat([
            slices_block(V_pad[k:k + slice_chunk], f_pad[k:k + slice_chunk])
            for k in range(0, S_pad, slice_chunk)], dim=1)[:, :S]

    if return_raw:
        return emb.to(dt), w_sum
    return _finalize(emb.to(dt), w_sum, cfg, bias, total_mass_scale)


def fsw_embed_multi_table(X, mt, projVecs, freqs, cfg: FSWConfig,
                          bias=None, total_mass_scale=None,
                          slice_chunk: Optional[int] = None,
                          aggregate: str = 'auto',
                          weights_grad: bool = True):
    """Embed a degree-bucketed `MultiTable`: each degree class runs the
    width-B_c table pipeline, its rows are copied into an (R + 1, ...)
    buffer in recipient order (the sentinel row R takes the padding rows
    and is dropped), then finalize once."""
    dt = X.dtype
    R = mt.num_recipients
    tail = ((cfg.nSlices, cfg.nFreqs) if cfg.cartesian_mode
            else (cfg.nSlices,))
    emb = torch.zeros((R + 1,) + tail, dtype=dt, device=X.device)
    w_sum = torch.zeros((R + 1,), dtype=dt, device=X.device)
    for tbl, ids in zip(mt.tables, mt.row_ids):
        raw, ws = fsw_embed_table(X, tbl, projVecs, freqs, cfg,
                                  slice_chunk=slice_chunk, return_raw=True,
                                  aggregate=aggregate,
                                  weights_grad=weights_grad)
        emb.index_copy_(0, ids, raw.to(dt))
        w_sum.index_copy_(0, ids, ws.to(dt))
    return _finalize(emb[:R], w_sum[:R], cfg, bias, total_mass_scale)
