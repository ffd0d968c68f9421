"""Fourier Sliced-Wasserstein embedding: the CSR graph, table, multiset and
dense graph paths.

Counterpart of `fsw_gnn_tpu/embedding.py`.
The embedding of a weighted neighborhood or multiset {(x_j, w_j)} for
slice vector v and frequency f is

    emb = (1 + f) * sum_j p_(j) * 2 w_j sinc(f w_j) cos(pi f (2 c_j - w_j))

with p_(j) = <x_(j), v> sorted ascending and c_j the inclusive cumsum of the
normalized weights in that order.  A neighborhood whose total mass is below
`total_mass_pad_thresh` gets a phantom point at the origin carrying the
deficit; its only effects are the normalization and the shift
c_j += pad_norm * 1[p_(j) > 0].

Aggregations:
  'sort': a stable sort along the entry axis, then a cumsum (any dtype);
          multisets with synthesized weights (W=None) take the static-grid
          quadrature instead, which sorts keys only;
  'rank': the weighted-rank kernels (ops/fsw_rank.py), which need no sort,
          compute in float32 and cast back: the fused-projection pair K1
          on tables where d_in + d_edge is below the slice width of one
          pass, the unfused pair K2 on projected entries elsewhere (tables
          and multisets), and in cartesian mode the pair K4 on projected
          entries (tables and multisets), which ranks once for all the
          frequencies of a slice.
'auto' takes 'rank' for an aggregation whose width (a table's bucket
size, a multiset's n) is at most the device's cap and whose kernels hold
that width in shared memory (`ops.fsw_rank.misfit`), and 'sort' otherwise
(`_resolve_aggregate`).  On a table K1 is taken only where it is faster
than the unfused route (`_k1_faster`).  The caps and K1's crossover are
the device's rules (`_rank_rules`, the counterpart of the JAX package's
per-device rules): the table measured on an H100 (which the CPU follows
too), else the card kind's autotune cache (`utils/autotune.py`), else
none, and 'auto' sorts.  The crossover rules the JAX package measured on
its own hardware are not carried over.  On an H100 the rank kernels'
forward and backward with weight gradients beat the sort route at the
widths `chip_smoke.py` measures (PERF.md).

The CSR graph path (`fsw_embed_graph`) sorts every slice's projections
within each recipient's segment and takes c with the segmented cumsum,
kernel K3 on the card (ops/segcumsum.py), over all slices of a chunk in
one call of its row form.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple, Union

import torch

from .graph import Graph
from .ops.gather_bwd import gather, gather_order
from .ops.fsw_rank import (fsw_rank_aggregate, fsw_rank_aggregate_cart,
                           fsw_rank_aggregate_proj, misfit)
from .ops.segcumsum import segcumsum_rows, segment_boundaries
from .ops.segment import (rows_gather, segment_expand, segment_lengths,
                          segment_sort_fused, segment_sum)
from .utils.profiling import count, gauge_max, named_scope, span, spanned

# the widest bucket the JAX package routes to its rank kernels (its
# `RANK_AGGREGATE_MAX_BUCKET_NO_DW`): the kernels hold a whole row in a
# block's shared memory, and their B x B rank loop outgrows a sort
RANK_AGGREGATE_MAX_BUCKET_NO_DW = 128

# The H100 crossover between the fused-projection kernels K1 and the
# unfused route (X @ V in float32, the gather of P, then K2) on one degree
# class of R rows of width B over N nodes, entries per node rho = R B / N.
# K1 projects every entry on the tensor cores (3xTF32), the unfused route
# every node once but moves an (R, B, S) tensor; per slice and feature the
# extra work is rho a against 1 b, and per entry and slice the moved bytes
# c, so K1 is faster where
#     rho <= K1_RHO0  or  D (rho - K1_RHO0) < rho K1_D0
# with K1_RHO0 = b / a and K1_D0 = c / a, fitted to the forward + backward
# times of the crossover table in PERF.md section 6 (one run of
# chip_smoke.py's routing phase on an NVIDIA H100 80GB HBM3 at 700 W,
# milliseconds, K1 against the unfused route): at 8.8 and 9.8 entries a
# node the routes cross between D = 256 (3.914 against 8.913, 4.926
# against 12.27) and 512 (12.67 against 9.81, 16.33 against 13.32), at 0.69
# between 512 (1.159 against 1.346) and 1024 (3.986 against 2.511); at 0.17
# K1 wins up to 1024 (1.154 against 1.611) and Cora's 0.047 at 1433 (0.510
# against 1.145), while Cora's 8.0 takes the unfused route at 1433 (27.92
# against 12.32).  The unfused route's backward is mostly PyTorch's scatter
# of dP into the projections; the forward alone favours it from D = 64 at
# 9 entries a node, and the rule follows training, the path that runs wide
# layers.  `cli autotune` (utils/autotune.py) measures the crossover again
# on a ladder of synthetic degree classes and fits this rule to it.
K1_RHO0 = 0.2
K1_D0 = 420.0

# The measured rules by card kind (a substring of the lower-cased name):
# the widest bucket 'auto' sends to a rank kernel with and without the
# weights' gradient, and K1's crossover (K1_RHO0, K1_D0 above).  The CPU
# follows the H100's, so the plain versions take the card's routes.
# `utils/autotune.py` measures these on any card (`cli autotune`) and
# caches them by kind; its `waste_*` keys are kept for parity with the
# JAX package's and read by no route.
_RANK_RULES_BY_KIND = {
    'h100': dict(cap_dw=128, cap_nodw=128, k1_rho0=0.2, k1_d0=420.0),
}
_KINDS: dict = {}


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


def promoted(*ts):
    """`ts` cast to the type JAX promotes them to together (torch keeps a
    dimensioned tensor's type against a 0-dim one of the same kind, JAX
    does not), e.g. bfloat16 features and float32 parameters go to
    float32, as a served bfloat16 request meets the model in the JAX
    package."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


def _mm(a, b):
    """a @ b in the promoted type (torch's matmul takes one type)."""
    a, b = promoted(a, b)
    return a @ b


def _append_total_mass(emb, w_sum, scale, cfg: FSWConfig):
    """Prepend the encoded total mass along the last axis."""
    tm, scale = promoted(_total_mass_value(w_sum, cfg), scale)
    tm = (tm * scale)[..., None]
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


def _device_kind(device) -> str:
    """The lower-cased name of a CUDA device, looked up once per device
    index."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    kind = _KINDS.get(index)
    if kind is None:
        kind = _KINDS[index] = torch.cuda.get_device_name(index).lower()
    return kind


def _rank_rules(device=None) -> Optional[dict]:
    """The routing rules of `device`: the measured table first (no device,
    the CPU, or a card whose kind it names), then the autotune cache for
    the card's kind (`utils/autotune.py`), then the H100's rules where
    FSW_ASSUME_H100_RULES=1; None when no rules are known, and 'auto'
    sorts.  As in the JAX package the table beats the cache on a kind it
    names, and a card it does not name never gets the H100's rules
    unasked.  The kind is looked up once per device index, so a card the
    table names costs no file read and no sync a call."""
    if device is None or torch.device(device).type != 'cuda':
        return _RANK_RULES_BY_KIND['h100']
    kind = _device_kind(torch.device(device))
    for known, rules in _RANK_RULES_BY_KIND.items():
        if known in kind:
            return rules
    from .utils.autotune import cached_rules
    cached = cached_rules(kind)
    if cached is not None:
        return cached
    if os.environ.get('FSW_ASSUME_H100_RULES') == '1':
        return _RANK_RULES_BY_KIND['h100']
    return None


def _k1_faster(D: int, entries_per_node: float,
               rules: Optional[dict] = None) -> bool:
    """Whether K1 beats the unfused route at feature width D on a table of
    `entries_per_node` entries a node (see K1_RHO0), by the crossover of
    `rules` (the H100 table's when None, or when they carry none)."""
    table = _RANK_RULES_BY_KIND['h100']
    rho0 = (rules or table).get('k1_rho0', table['k1_rho0'])
    d0 = (rules or table).get('k1_d0', table['k1_d0'])
    rho = float(entries_per_node)
    return rho <= rho0 or D * (rho - rho0) < rho * d0


def _resolve_aggregate(aggregate: str, cfg: FSWConfig, bucket_size: int,
                       s_eff: Optional[int] = None,
                       weights_grad: bool = True,
                       entries_per_node: Optional[float] = None,
                       device=None) -> str:
    """The route of one aggregation of width `bucket_size` (a table's
    bucket, a multiset's n): 'sort', 'rank' (the unfused kernels K2, or K4
    in cartesian mode) or 'rank_proj' (the fused-projection kernels K1).

    One rule for 'auto' and an explicit 'rank', on the CPU and on the
    card, whatever the grad mode (an eval forward takes the training
    forward's kernels):
      * K1 for a table outside cartesian mode (pass the slice width of one
        pass as `s_eff` and the table's R B over the nodes as
        `entries_per_node`) where d_in + d_edge < s_eff, K1f and K1b (with
        `weights_grad`) hold the width and `_k1_faster` says so;
      * otherwise K2, or K4 in cartesian mode, where its forward and
        backward hold the width;
      * otherwise 'sort' under 'auto'; an explicit 'rank' raises a
        ValueError naming the width and the shared memory it needs.
    The rules are `device`'s (`_rank_rules`; None: the H100 table's, as
    on the CPU): 'auto' sorts above their cap (`cap_dw` with
    `weights_grad`, else `cap_nodw`; RANK_AGGREGATE_MAX_BUCKET_NO_DW on
    the H100), and everywhere on a card with no rules; K1 is chosen by
    their crossover, and an explicit 'rank' on such a card keeps the H100
    table's.  The needs are `ops.fsw_rank.smem_bytes`, the kernels' own;
    K1 and K2 compute the same function, so where K1 cannot launch K2
    gives the same values.  K4b's need is taken with the uniform-weight
    trig, the larger."""
    if aggregate not in ('auto', 'sort', 'rank'):
        raise ValueError(f"aggregate must be 'auto'|'sort'|'rank', "
                         f"got {aggregate!r}")
    if aggregate == 'sort':
        return 'sort'
    B = bucket_size
    dw = bool(weights_grad)
    rules = _rank_rules(device)
    if aggregate == 'auto' and (
            rules is None or B > rules['cap_dw' if dw else 'cap_nodw']):
        return 'sort'
    if cfg.cartesian_mode:
        F = cfg.nFreqs
        short = misfit(('fsw_rank_cart_fwd', 'fsw_rank_cart_bwd'), B, F, dw,
                       uniform_w=True)
        at = f' at {F} frequencies'
    else:
        at = ''
        if (s_eff is not None and entries_per_node is not None
                and cfg.proj_dim < s_eff
                and _k1_faster(cfg.proj_dim, entries_per_node, rules)
                and misfit(('fsw_rank_fwdp', 'fsw_rank_bwdp'), B,
                           with_dw=dw) is None):
            return 'rank_proj'
        short = misfit(('fsw_rank_fwd', 'fsw_rank_bwd'), B, with_dw=dw)
    if short is None:
        return 'rank'
    if aggregate == 'auto':
        return 'sort'
    name, need = short
    grads = 'with' if dw else 'without'
    raise ValueError(f"aggregate='rank': bucket width {B}{at} {grads} "
                     f"weight gradients needs {need} bytes of shared memory "
                     f"in {name}, above the 232448 a block has; use "
                     f"aggregate='sort' or 'auto'")


def _sort_quadrature(keys, wn, pad_norm, f_block, cfg: FSWConfig):
    """The sort route on keys (..., S_blk, B) with weights wn (..., B) and
    phantom mass pad_norm (...): a stable sort along the entries, the
    cumsum, the quadrature.  f_block is (S_blk,), or in cartesian mode
    (F,) or (S_blk, F).  Returns (..., S_blk) (or (..., S_blk, F))."""
    ps, order = torch.sort(keys, dim=-1, stable=True)
    ws = torch.gather(wn[..., None, :].expand(keys.shape), -1, order)
    c = torch.cumsum(ws, dim=-1) + pad_norm[..., None, None] * (ps > 0)
    if cfg.cartesian_mode:
        sd = _sinc_diff(ws[..., None], c[..., None],
                        f_block[..., None, :])               # (..., S, B, F)
        return (1.0 + f_block) * torch.einsum('...sb,...sbf->...sf', ps, sd)
    sd = _sinc_diff(ws, c, f_block[:, None])                 # (..., S, B)
    return (1.0 + f_block) * torch.sum(ps * sd, dim=-1)


def bucket_quadrature(P, wn, pad_norm, f_block, cfg: FSWConfig, agg: str,
                      weights_grad: bool = True, uniform_w: bool = False):
    """Per-neighborhood FSW aggregation on pre-gathered projections.

    P (R, B, S_blk); wn (R, B); pad_norm (R,); f_block (S_blk,) (or
    (F,) or (S_blk, F) in cartesian mode).  `agg` is resolved: 'sort'
    (stable sort + cumsum) or 'rank' (kernel K2, or in cartesian mode K4
    on the (S_blk, F) frequency matrix, in float32, cast back).
    `uniform_w` declares row-constant weights (see `fsw_rank_aggregate`).
    Returns (R, S_blk) (or (R, S_blk, F))."""
    if agg == 'rank':
        f32 = torch.float32
        a32 = (P.to(f32).contiguous(), wn.to(f32).contiguous(),
               pad_norm.to(f32).contiguous())
        fb = f_block.to(f32)
        aggregate = fsw_rank_aggregate
        if cfg.cartesian_mode:
            aggregate = fsw_rank_aggregate_cart
            if fb.dim() == 1:       # the grid every slice shares
                fb = fb.expand(P.shape[2], fb.shape[0])
        out = aggregate(*a32, fb.contiguous(), uniform_w=uniform_w,
                        with_dw=weights_grad)
        return out.to(P.dtype)
    return _sort_quadrature(P.transpose(1, 2), wn, pad_norm, f_block, cfg)


def table_weights(w, cfg: FSWConfig):
    """(w_sum, wn, pad_norm) of weights w (..., B): the total mass, the
    weights normalized by max(total, thresh), and the phantom mass
    max(thresh - total, 0) in the same units."""
    w_sum = torch.sum(w, dim=-1)                               # (...,)
    w_sum_padded = lowclamp(w_sum, cfg.total_mass_pad_thresh)
    pad_norm = lowclamp(cfg.total_mass_pad_thresh - w_sum, 0.0) / w_sum_padded
    return w_sum, w / w_sum_padded[..., None], pad_norm


def _gather(src, table):
    """src[table.idx], in the span `fsw.gather`, counted: its entries and
    its padding (the table's `pad_entries`, where the layout functions of
    graph.py computed it).  Where autograd differentiates `src`, the
    backward is `ops.gather_bwd` on the table's `gather_order` (built here,
    on idx's device, where the table has none or one over other senders or
    entries: `gather.bwd_order_built`), and the gather counts the senders
    whose run the order cut (`gather.bwd_split_rows`) and the longest run
    (`gather.hot_row_entries`, where graph.py counted it)."""
    grad = torch.is_grad_enabled() and src.requires_grad
    with span('fsw.gather'):
        if grad:
            order = table.gather_order
            if (order is None or order.num_senders != src.shape[0]
                    or order.perm.shape[0] != table.idx.numel()):
                order = gather_order(table.idx, src.shape[0])
                count('gather.bwd_order_built')
            out = gather(src, table.idx, order)
        else:
            out = src[table.idx]
    count('gather.entries', table.idx.numel())
    if table.pad_entries is not None:
        count('gather.pad_entries', table.pad_entries)
    if grad:
        count('gather.bwd_split_rows', order.split_rows)
        if table.hot_row_entries is not None:
            gauge_max('gather.hot_row_entries', table.hot_row_entries)
    return out


def gather_rows(X, table, cfg: FSWConfig):
    """The (R, B, d_in + d_edge) sender rows of a table: X gathered by
    `table.idx`, edge features appended."""
    Z = _gather(X, table)                                      # (R, B, d_in)
    if cfg.d_edge > 0:
        if table.edge_feat is None:
            raise ValueError('the table has no edge features')
        Z = torch.cat([Z, table.edge_feat.to(Z.dtype)], dim=-1)
    return Z


def _chunked(slices_block, V, freqs, cfg: FSWConfig,
             slice_chunk: Optional[int]):
    """slices_block(V_block, f_block) over the slice axis, `slice_chunk`
    slices at a time (all at once when None).  Zero-padded slices have a
    zero slice vector (and f = 0 outside cartesian mode): they contribute
    exact zeros and are cut off again."""
    S = cfg.nSlices
    if slice_chunk is None or slice_chunk >= S:
        return slices_block(V, freqs)
    S_pad = -(-S // slice_chunk) * slice_chunk
    V_pad = torch.nn.functional.pad(V, (0, 0, 0, S_pad - S))
    if cfg.cartesian_mode:        # every chunk takes all the frequencies
        return torch.cat([slices_block(V_pad[k:k + slice_chunk], freqs)
                          for k in range(0, S_pad, slice_chunk)],
                         dim=-2)[..., :S, :]
    f_pad = torch.cat([freqs, freqs.new_zeros(S_pad - S)])
    return torch.cat([slices_block(V_pad[k:k + slice_chunk],
                                   f_pad[k:k + slice_chunk])
                      for k in range(0, S_pad, slice_chunk)],
                     dim=-1)[..., :S]


def _fused_inputs(X, table, wn, pad_norm, cfg: FSWConfig):
    """K1's row inputs of a table, in float32: the gathered sender rows Z
    (R, B, d_in + d_edge), wn and pad_norm."""
    f32 = torch.float32
    return (gather_rows(X, table, cfg).to(f32).contiguous(),
            wn.to(f32).contiguous(), pad_norm.to(f32).contiguous())


def _fused_block(fused, proj_block, f_block, unif: bool, weights_grad):
    """The fused route (K1) on one slice block: `fused` from
    `_fused_inputs`, proj_block (S_blk, d_in + d_edge).  Returns
    (R, S_blk) in float32."""
    Z32, wn32, pad32 = fused
    return fsw_rank_aggregate_proj(
        Z32, wn32, pad32, f_block.to(torch.float32).contiguous(),
        proj_block.t().to(torch.float32).contiguous(),
        uniform_w=unif, with_dw=weights_grad)


def _unfused_block(X, table, wn, pad_norm, proj_block, f_block,
                   cfg: FSWConfig, agg: str, weights_grad, unif: bool):
    """The unfused route on one slice block: X projected once, P gathered
    by the table, then `bucket_quadrature` by `agg` (K2 / K4, or sort).
    Returns (R, S_blk) (or (R, S_blk, F))."""
    Xp = _mm(X, proj_block[:, :cfg.d_in].t())                  # (N, S_blk)
    P = _gather(Xp, table)                                     # (R, B, S_blk)
    if cfg.d_edge > 0:
        if table.edge_feat is None:
            raise ValueError('the table has no edge features')
        P = P + _mm(table.edge_feat, proj_block[:, cfg.d_in:].t())
    return bucket_quadrature(P, wn, pad_norm, f_block, cfg, agg,
                             weights_grad, uniform_w=unif)


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
    S = cfg.nSlices
    s_eff = S if slice_chunk is None else min(slice_chunk, S)
    agg = _resolve_aggregate(aggregate, cfg, table.bucket_size, s_eff,
                             weights_grad,
                             table.idx.numel() / max(X.shape[0], 1),
                             table.idx.device)
    with span('fsw.embed.table', route=agg, B=table.bucket_size,
              R=table.idx.shape[0]):
        return _embed_table(X, table, projVecs, freqs, cfg, agg, bias,
                            total_mass_scale, slice_chunk, return_raw,
                            weights_grad)


def _embed_table(X, table, projVecs, freqs, cfg: FSWConfig, agg: str,
                 bias, total_mass_scale, slice_chunk, return_raw,
                 weights_grad):
    """`fsw_embed_table` on the route `agg` that it resolved."""
    dt = X.dtype
    w_sum, wn, pad_norm = table_weights(table.weight, cfg)

    # the fused-projection route gathers the raw sender rows (R, B, D) and
    # projects inside the kernel; Z is built once for every slice chunk
    use_proj = agg == 'rank_proj'
    unif = bool(table.uniform_w)
    if use_proj:
        fused = _fused_inputs(X, table, wn, pad_norm, cfg)

    def slices_block(proj_block, f_block):
        """proj_block: (S_blk, d_in + d_edge) slice vectors; f_block."""
        if use_proj:
            return _fused_block(fused, proj_block, f_block, unif,
                                weights_grad).to(dt)           # (R, S_blk)
        return _unfused_block(X, table, wn, pad_norm, proj_block, f_block,
                              cfg, agg, weights_grad, unif)

    emb = _chunked(slices_block, projVecs, freqs, cfg, slice_chunk)

    if return_raw:
        return emb.to(dt), w_sum
    return _finalize(emb.to(dt), w_sum, cfg, bias, total_mass_scale)


@spanned('fsw.embed.multi_table')
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


def fsw_embed_multiset(X, W, projVecs, freqs, cfg: FSWConfig,
                       bias=None, total_mass_scale=None,
                       w_mode: str = 'unit',
                       slice_chunk: Optional[int] = None,
                       aggregate: str = 'auto',
                       weights_grad: bool = True):
    """Embed batched weighted multisets (point clouds).

    X (..., n, d_in); W (..., n) nonnegative, or None with w_mode 'unit'
    (every weight 1) or 'uniform' (every weight 1/n).  Returns
    (..., d_out) (or (..., nSlices, nFreqs) in non-collapsed cartesian
    mode).  `slice_chunk` bounds the slice width processed at once.

    Each multiset is one neighborhood of width n, routed as a table class
    (`_resolve_aggregate`, bucket n): 'rank' projects with a matmul and
    runs kernel K2 (K4 in cartesian mode) on the (R, n, S) projections
    (R = the leading dims flattened); 'sort' sorts, except that
    synthesized weights (W=None) outside cartesian mode take the
    static-grid quadrature: the sorted
    cumulative weight is then the fixed grid c_j = (j + 1) wc (+ the
    phantom mass above zero), so only the keys are sorted and the trig is
    one (S, n) matrix.  Synthesized weights are never differentiated."""
    n = X.shape[-2]
    dt, dev = X.dtype, X.device
    unif = W is None                    # synthesized weights: row-constant
    if unif:
        if w_mode not in ('unit', 'uniform'):
            raise ValueError(f"w_mode must be 'unit' or 'uniform', "
                             f"got {w_mode!r}")
        W = torch.full(X.shape[:-1], 1.0 if w_mode == 'unit' else 1.0 / n,
                       dtype=dt, device=dev)
        weights_grad = False
        # the static grid's constants, Python floats
        T = float(cfg.total_mass_pad_thresh)
        ws_total = float(n) if w_mode == 'unit' else 1.0
        wsp_c = max(ws_total, T)
        wc = (1.0 / wsp_c) if w_mode == 'unit' else 1.0 / (n * wsp_c)
        padc = max(T - ws_total, 0.0) / wsp_c
    agg = _resolve_aggregate(aggregate, cfg, n, weights_grad=weights_grad,
                             device=dev)
    w_sum, wn, pad_norm = table_weights(W, cfg)

    def slices_block(V_block, f_block):
        """V_block (S_blk, d_in) slice vectors; f_block (S_blk,) (or (F,)
        in cartesian mode)."""
        Xp = X @ V_block.t()                                 # (..., n, Sb)
        if agg == 'rank':
            lead = Xp.shape[:-2]
            out = bucket_quadrature(
                Xp.reshape(-1, n, Xp.shape[-1]), wn.reshape(-1, n),
                pad_norm.reshape(-1), f_block, cfg, 'rank', weights_grad,
                uniform_w=unif)
            return out.reshape(lead + out.shape[1:])         # (..., Sb)
        keys = Xp.transpose(-1, -2)                          # (..., Sb, n)
        if unif and not cfg.cartesian_mode:
            ps = torch.sort(keys, dim=-1).values
            wct = torch.tensor(wc, dtype=dt, device=dev)
            c0 = (torch.arange(1, n + 1, dtype=dt, device=dev) * wc)[None, :]
            g1 = (1.0 + f_block)[:, None]
            phi0 = g1 * _sinc_diff(wct, c0, f_block[:, None])   # (Sb, n)
            if padc != 0.0:
                phi1 = g1 * _sinc_diff(wct, c0 + padc, f_block[:, None])
                return torch.sum(ps * torch.where(ps > 0, phi1, phi0),
                                 dim=-1)
            return torch.einsum('...sn,sn->...s', ps, phi0)
        return _sort_quadrature(keys, wn, pad_norm, f_block, cfg)

    emb = _chunked(slices_block, projVecs[:, :cfg.d_in], freqs, cfg,
                   slice_chunk)
    return _finalize(emb, w_sum, cfg, bias, total_mass_scale)


def fsw_embed_graph_dense(X, W, projVecs, freqs, cfg: FSWConfig,
                          X_edge=None, bias=None, total_mass_scale=None,
                          slice_chunk: Optional[int] = None):
    """Graph mode with a dense adjacency: W (..., R, n) the weights of
    sender j in recipient r's neighborhood, X (..., n, d_in), X_edge
    (..., R, n, d_edge) or (..., R, n) when d_edge == 1.  Returns
    (..., R, d_out).  The sort route only, as in the JAX package."""
    w_sum, wn, pad_norm = table_weights(W, cfg)
    if cfg.d_edge > 0:
        if X_edge is None:
            raise ValueError('d_edge > 0 needs X_edge')
        if X_edge.dim() == W.dim():
            X_edge = X_edge[..., None]

    def slices_block(V_block, f_block):
        """V_block (S_blk, d_in + d_edge); f_block (S_blk,) or (F,)."""
        Xp = X @ V_block[:, :cfg.d_in].t()                   # (..., n, Sb)
        if cfg.d_edge > 0:
            P = Xp[..., None, :, :] + X_edge @ V_block[:, cfg.d_in:].t()
        else:
            P = Xp[..., None, :, :].expand(W.shape[:-1] + Xp.shape[-2:])
        return _sort_quadrature(P.transpose(-1, -2), wn, pad_norm, f_block,
                                cfg)                          # (..., R, Sb)

    emb = _chunked(slices_block, projVecs, freqs, cfg, slice_chunk)
    return _finalize(emb, w_sum, cfg, bias, total_mass_scale)


def graph_weights(graph, cfg: FSWConfig, dst_len):
    """(w_sum (R,), wn (E,), pad_norm_e (E,)) of a CSR graph on X's device:
    each recipient's total mass, the edge weights normalized by their
    recipient's max(total, thresh), and the recipient's phantom mass per
    edge.  `dst_len`: each recipient's edge count (diff of row_ptr)."""
    dst = graph.dst
    w_sum = segment_sum(graph.weight, dst, graph.num_recipients,
                        lengths=dst_len)
    w_sum_padded = lowclamp(w_sum, cfg.total_mass_pad_thresh)
    pad_norm = lowclamp(cfg.total_mass_pad_thresh - w_sum, 0.0) / w_sum_padded
    return (w_sum,
            graph.weight / segment_expand(w_sum_padded, dst, lengths=dst_len),
            segment_expand(pad_norm, dst, lengths=dst_len))


@spanned('fsw.embed.graph')
def fsw_embed_graph(X, graph, projVecs, freqs, cfg: FSWConfig,
                    bias=None, total_mass_scale=None,
                    slice_chunk: Optional[int] = None):
    """Embed every recipient's in-neighborhood of a CSR `Graph` (moved to
    X's device when needed).

    X (num_nodes, d_in).  Returns (num_recipients, d_out) (or (R, nSlices,
    nFreqs) in non-collapsed cartesian mode).  `slice_chunk` bounds the
    slice width processed at once.

    Where the JAX package maps one slice at a time, a chunk of S_b slices
    goes at once: the projections are laid out as (S_b, E), each row
    sorted within the segments (recipients), and the cumsum of the sorted
    weights is one K3 call over the (S_b, E) rows, every row scanned on its
    own over the graph's E-long is_end mask (sorting within a segment
    leaves every edge in its segment).  Padded edges (weight 0,
    sender 0, recipient R - 1) contribute exactly 0.

    As in the JAX package, no step backs up through a scatter: the
    senders' gather (`rows_gather`, by the graph's src_order/src_sorted),
    the fused sort, the per-recipient sums and the weights' expansion over
    the edges each have a gather or a sorted segment-sum for backward
    (ops/segment.py), so the gradients are the same bits from call to
    call."""
    graph = graph.to(X.device)
    dt = X.dtype
    R = graph.num_recipients
    dst = graph.dst
    # the recipients' and the senders' run lengths, once for every chunk
    dst_len = torch.diff(graph.row_ptr.long())
    if graph.src_sorted is None:
        src_sorted, src_order = torch.sort(graph.src, stable=True)
    else:
        src_sorted, src_order = graph.src_sorted, graph.src_order
    src_len = segment_lengths(src_sorted, graph.num_nodes)
    w_sum, wn, pad_e = graph_weights(graph, cfg, dst_len)
    is_end = segment_boundaries(dst)
    if cfg.d_edge > 0 and graph.edge_feat is None:
        raise ValueError('the graph has no edge features')

    def slices_block(V_block, f_block):
        """V_block (S_b, d_in + d_edge); f_block (S_b,) or (F,)."""
        with named_scope('fsw_project'):
            Xp = _mm(V_block[:, :cfg.d_in], X.t())              # (S_b, N)
        # projections laid out (S_b, E), each slice's row contiguous
        keys = rows_gather(graph.num_nodes, Xp, graph.src, src_order,
                           src_sorted, dim=1, lengths=src_len)
        if cfg.d_edge > 0:
            keys = keys + _mm(V_block[:, cfg.d_in:],
                              graph.edge_feat.to(dt).t())
        ps, ws = segment_sort_fused(keys, wn, dst)
        with named_scope('fsw_segcumsum'):
            if ws.dtype.itemsize == 2:
                # K3 has float32 and float64 kernels: 2-byte weights (a
                # bfloat16 server's) are summed in float32, rounded once
                c = segcumsum_rows(ws.float(), is_end).to(ws.dtype)
            else:
                c = segcumsum_rows(ws, is_end)
            c = c + pad_e * (ps > 0)
        if cfg.cartesian_mode:
            sd = _sinc_diff(ws[..., None], c[..., None], f_block)
            terms = ps[..., None] * sd                          # (S_b, E, F)
            out = segment_sum(terms, dst, R, 1, dst_len)
            return ((1.0 + f_block) * out).transpose(0, 1)      # (R, S_b, F)
        terms = ps * _sinc_diff(ws, c, f_block[:, None])
        out = segment_sum(terms, dst, R, 1, dst_len)
        return ((1.0 + f_block)[:, None] * out).t()             # (R, S_b)

    emb = _chunked(slices_block, projVecs, freqs, cfg, slice_chunk)
    return _finalize(emb.to(dt), w_sum.to(dt), cfg, bias, total_mass_scale)


def fsw_embed_graph_batched(X, graphs, projVecs, freqs, cfg: FSWConfig,
                            bias=None, total_mass_scale=None,
                            slice_chunk: Optional[int] = None):
    """Embed a stack of G equally shaped CSR graphs (`graph.stack_graphs`:
    every array with a leading G axis).  X (*batch, n, d_in) with the
    batch dims multiplying out to G; returns (*batch, R, d_out).

    The stack runs as one block-diagonal graph (node ids offset by g * n,
    recipients by g * R, edges by g * E), so every chunk of slices is still
    one K3 call."""
    batch_shape = tuple(X.shape[:-2])
    graphs = graphs.to(X.device)
    G = graphs.src.shape[0]
    if math.prod(batch_shape) != G:
        raise ValueError(f'leading batch dims {batch_shape} must multiply '
                         f'out to the stacked graph count {G}')
    N, R = graphs.num_nodes, graphs.num_recipients
    E = graphs.src.shape[1]
    g = torch.arange(G, device=X.device)[:, None]
    ef = graphs.edge_feat
    row_ptr = torch.cat([(graphs.row_ptr[:, :-1] + g * E).reshape(-1),
                         graphs.row_ptr.new_full((1,), G * E)])
    # each graph's stable sort by sender, offset, is the flat graph's
    order = {} if graphs.src_order is None else dict(
        src_order=(graphs.src_order + g * E).reshape(-1),
        src_sorted=(graphs.src_sorted + g * N).reshape(-1))
    flat = Graph(
        src=(graphs.src + g * N).reshape(-1),
        dst=(graphs.dst + g * R).reshape(-1),
        weight=graphs.weight.reshape(-1), row_ptr=row_ptr,
        in_degrees=graphs.in_degrees.reshape(-1),
        edge_feat=None if ef is None else ef.reshape(G * E, -1),
        num_nodes=G * N, num_recipients=G * R, num_edges=G * E, **order)
    out = fsw_embed_graph(X.reshape(G * N, X.shape[-1]), flat, projVecs,
                          freqs, cfg, bias=bias,
                          total_mass_scale=total_mass_scale,
                          slice_chunk=slice_chunk)
    return out.reshape(batch_shape + (R,) + tuple(out.shape[1:]))
