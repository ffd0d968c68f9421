"""The FSW graph convolution and readout as torch `nn.Module`s.

Counterpart of `FSWConv` and `FSWReadout` in `fsw_gnn_tpu/conv.py`, with
the same defaults:
  * embed_dim = 2 * max(in, out) unless mlp_layers == 0 and not
    concat_self, which forces embed_dim = out_channels;
  * mlp_hidden_dim = max(in, out);
  * the embedding has a bias only when no MLP follows;
  * the degree encoding is 'homog' iff homog_degree_encoding;
  * the embedding uses freqs_init='spread';
  * MLP layer order Linear -> BatchNorm -> activation -> Dropout, with
    LeakyReLU(0.2) activations by default;
  * BatchNorm in train mode is flax's (`FlaxBatchNorm`), its statistics
    taken over every rank's rows with `bn_axis_name`;
  * mlp_layers == 0 with concat_self reduces the dimension by a random
    (out_channels, in) frame, coherence-minimized, in place of an MLP;
  * Dropout draws its mask from the `generator` the caller passes to
    `forward` (it cannot match JAX's random stream).
The convolution consumes a prebuilt CSR Graph, NeighborTable or
MultiTable.  Train and eval mode are torch's (`module.train()` /
`.eval()`).
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Optional

import torch
from torch import nn

from .device import resolve_device
from .embedding import FSWConfig, promoted
from .modules import FSWEmbedding
from .ops.coherence import minimize_mutual_coherence
from .registry import register_layer, register_pooling
from .utils.profiling import spanned


def leaky_relu_02(x):
    return nn.functional.leaky_relu(x, negative_slope=0.2)


def _default_linear_init(layer: nn.Linear, gen: torch.Generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, torch's own
    nn.Linear default, drawn from `gen`."""
    bound = 1.0 / math.sqrt(layer.in_features)
    nn.init.uniform_(layer.weight, -bound, bound, generator=gen)
    if layer.bias is not None:
        nn.init.uniform_(layer.bias, -bound, bound, generator=gen)


# the named schemes; the biases start at zero (as in the JAX package)
_MLP_INITS = {
    'xavier_uniform': nn.init.xavier_uniform_,
    'xavier_normal': nn.init.xavier_normal_,
    'kaiming_uniform': lambda w, generator: nn.init.kaiming_uniform_(
        w, nonlinearity='relu', generator=generator),
    'kaiming_normal': lambda w, generator: nn.init.kaiming_normal_(
        w, nonlinearity='relu', generator=generator),
}


class FlaxBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the batch axis whose train mode is flax
    `nn.BatchNorm`'s: normalise with the biased batch variance and eps
    1e-5, and move the running statistics as
    running = 0.99 * running + 0.01 * batch, with the biased variance for
    running_var too (torch's BatchNorm1d uses momentum 0.1 and the unbiased
    variance there).  Eval mode normalises with the running statistics.
    The state keeps torch's names (weight, bias, running_mean,
    running_var).

    With `axis_name` (the name of the mesh axis; the port's one axis is
    the default torch.distributed process group) train mode takes flax's
    `BatchNorm(axis_name=...)` statistics: every rank's mean and mean of
    squares over its rows, averaged over the ranks (a differentiable mean
    all-reduce, each rank weighted alike), var = max(0, E[x^2] - E[x]^2)."""

    DECAY = 0.99

    def __init__(self, num_features: int, dtype=torch.float32,
                 axis_name=None):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - self.DECAY,
                         dtype=dtype)
        self.axis_name = axis_name

    def _batch_stats(self, x):
        if self.axis_name is None:
            return x.mean(dim=0), x.var(dim=0, unbiased=False)
        from .parallel.collectives import all_reduce_mean
        mu = all_reduce_mean(torch.stack([x.mean(dim=0),
                                          (x * x).mean(dim=0)]))
        return mu[0], torch.clamp(mu[1] - mu[0] * mu[0], min=0.0)

    def forward(self, x):
        # computes in its own type, as flax's BatchNorm(dtype=...) does
        x = x.to(self.running_mean.dtype)
        if not self.training:
            return super().forward(x)
        mean, var = self._batch_stats(x)
        with torch.no_grad():
            self.running_mean.mul_(self.DECAY).add_(mean, alpha=1 - self.DECAY)
            self.running_var.mul_(self.DECAY).add_(var, alpha=1 - self.DECAY)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def dropout(x, p: float, generator: Optional[torch.Generator] = None):
    """Inverted dropout as flax applies it: keep each entry with
    probability 1 - p and scale the kept ones by 1 / (1 - p).  The mask is
    drawn from `generator` (on x's device; None: torch's default)."""
    if p <= 0:
        return x
    if p >= 1:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class _MLPHead(nn.Module):
    """The post-aggregation head: `mlp_layers` Linear layers, each followed
    by optional BatchNorm, activation and Dropout.  Layer i is
    `dense[i]`; its BatchNorm is `bn[str(i)]`, its dropout rate
    `rates[i]`.

    With mlp_layers == 0 the head is `bn['final']` alone, after
    `x @ dim_reduct.T` when concat_self: dim_reduct (out_channels, in_dim)
    is drawn N(0, 1) in float64 on the CPU from `gen`, coherence-minimized
    in float64 on `device` (None: the card) and cast to dtype; a parameter when
    `learnable_dim_reduct`, else a buffer (the JAX package's 'fsw_fixed'
    variable)."""

    def __init__(self, in_dim: int, out_channels: int, mlp_layers: int,
                 mlp_hidden_dim: int, bias: bool, mlp_init: Optional[str],
                 activation_final: Optional[Callable],
                 activation_hidden: Optional[Callable],
                 batchnorm_final: bool, batchnorm_hidden: bool,
                 dropout_final: float, dropout_hidden: float,
                 concat_self: bool, gen: torch.Generator,
                 learnable_dim_reduct: bool = True,
                 bn_axis_name=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        if mlp_init is not None and mlp_init not in _MLP_INITS:
            raise ValueError(f'invalid mlp_init {mlp_init!r}')
        self.mlp_layers = mlp_layers
        self.dense = nn.ModuleList()
        self.bn = nn.ModuleDict()
        self.acts = []
        self.rates = []
        if mlp_layers == 0:
            width = in_dim
            if concat_self:
                w = torch.randn((out_channels, in_dim), generator=gen,
                                dtype=torch.float64)
                w = minimize_mutual_coherence(w.to(device)).to(dtype)
                if learnable_dim_reduct:
                    self.dim_reduct = nn.Parameter(w)
                else:
                    self.register_buffer('dim_reduct', w)
                width = out_channels
            if batchnorm_final:
                self.bn['final'] = FlaxBatchNorm(width, dtype=dtype,
                                                 axis_name=bn_axis_name)
            return
        in_d = in_dim
        for i in range(mlp_layers):
            is_final = i == mlp_layers - 1
            out_d = out_channels if is_final else mlp_hidden_dim
            layer = nn.Linear(in_d, out_d, bias=bias, dtype=dtype)
            with torch.no_grad():
                if mlp_init is None:
                    _default_linear_init(layer, gen)
                else:
                    _MLP_INITS[mlp_init](layer.weight, generator=gen)
                    if layer.bias is not None:
                        layer.bias.zero_()
            self.dense.append(layer)
            if batchnorm_final if is_final else batchnorm_hidden:
                self.bn[str(i)] = FlaxBatchNorm(out_d, dtype=dtype,
                                                axis_name=bn_axis_name)
            self.acts.append(activation_final if is_final
                             else activation_hidden)
            self.rates.append(dropout_final if is_final else dropout_hidden)
            in_d = out_d

    @spanned('fsw.mlp_head')
    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x (..., in_dim) of any float type: each Linear and BatchNorm
        computes in its own parameters' type, as flax's Dense(dtype=...)
        and BatchNorm(dtype=...) do; the dim_reduct product in the type the
        two promote to."""
        if self.mlp_layers == 0:
            if hasattr(self, 'dim_reduct'):
                x, w = promoted(x, self.dim_reduct)
                x = x @ w.t()
            return self.bn['final'](x) if 'final' in self.bn else x
        for i, layer in enumerate(self.dense):
            x = layer(x.to(layer.weight.dtype))
            if str(i) in self.bn:
                x = self.bn[str(i)](x)
            if self.acts[i] is not None:
                x = self.acts[i](x)
            if self.training:
                x = dropout(x, self.rates[i], generator)
        return x


@register_layer('fsw_conv')
class FSWConv(nn.Module):
    """FSW message-passing layer over a CSR Graph, NeighborTable or
    MultiTable.

    Call `conv(vertex_features, graph)` with vertex_features
    (N, in_channels) and a layout whose recipients are the N nodes.  Edge
    features (edgefeat_dim > 0) ride in the layout's `edge_feat`.
    Parameters are drawn from `generator` (a fresh one seeded 0 when None)
    and placed on `device` (None: the card)."""

    # concat_self appends the recipients' own features to the embedding
    _self_features = True

    def __init__(self, in_channels: int, out_channels: int,
                 edgefeat_dim: int = 0,
                 embed_dim: Optional[int] = None,
                 learnable_embedding: bool = True,
                 encode_vertex_degrees: bool = True,
                 vertex_degree_encoding_function: str = 'identity',
                 vertex_degree_encoding_scale: float = 1.0,
                 learnable_vertex_degree_encoding_scale: bool = False,
                 homog_degree_encoding: bool = False,
                 vertex_degree_pad_thresh: float = 1.0,
                 concat_self: bool = True,
                 message_weight_vs_self: float = 1.0,
                 bias: bool = True,
                 mlp_layers: int = 1,
                 mlp_hidden_dim: Optional[int] = None,
                 mlp_activation_final: Optional[Callable] = leaky_relu_02,
                 mlp_activation_hidden: Optional[Callable] = leaky_relu_02,
                 mlp_init: Optional[str] = None,
                 batchnorm_final: bool = False,
                 batchnorm_hidden: bool = False,
                 dropout_final: float = 0.0,
                 dropout_hidden: float = 0.0,
                 minimize_slice_coherence: bool = True,
                 bn_axis_name=None,
                 dtype=torch.float32,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.concat_self = concat_self
        self.message_weight_vs_self = message_weight_vs_self

        if mlp_layers == 0 and not concat_self:
            embed_dim = out_channels
        elif embed_dim is None:
            embed_dim = 2 * max(in_channels, out_channels)
        self.embed_cfg = FSWConfig(
            d_in=in_channels,
            d_out=embed_dim,
            d_edge=edgefeat_dim,
            encode_total_mass=encode_vertex_degrees,
            total_mass_encoding_function=vertex_degree_encoding_function,
            total_mass_encoding_scale=vertex_degree_encoding_scale,
            total_mass_encoding_method=(
                'homog' if homog_degree_encoding else 'plain'),
            total_mass_pad_thresh=vertex_degree_pad_thresh,
            learnable_slices=learnable_embedding,
            learnable_freqs=learnable_embedding,
            learnable_total_mass_encoding_scale=(
                learnable_vertex_degree_encoding_scale),
            freqs_init='spread',
            minimize_slice_coherence=minimize_slice_coherence,
            enable_bias=bias and mlp_layers == 0,
        )
        # built where it will live, so the coherence minimizers run there
        self.fsw_embed = FSWEmbedding(self.embed_cfg, dtype=dtype,
                                      device=device, generator=gen)
        head_in = embed_dim + (in_channels if concat_self
                               and self._self_features else 0)
        self.head = _MLPHead(
            in_dim=head_in, out_channels=out_channels,
            mlp_layers=mlp_layers,
            mlp_hidden_dim=(mlp_hidden_dim if mlp_hidden_dim is not None
                            else max(in_channels, out_channels)),
            bias=bias, mlp_init=mlp_init,
            activation_final=mlp_activation_final,
            activation_hidden=mlp_activation_hidden,
            batchnorm_final=batchnorm_final,
            batchnorm_hidden=batchnorm_hidden,
            dropout_final=dropout_final, dropout_hidden=dropout_hidden,
            concat_self=concat_self, gen=gen,
            learnable_dim_reduct=learnable_embedding,
            bn_axis_name=bn_axis_name, dtype=dtype, device=device)
        self.to(device)

    @classmethod
    def from_config(cls, config: Optional[dict] = None, **kwargs):
        """Construct with config-dict overrides: any key in `config`
        overrides the matching constructor argument; unknown keys raise."""
        config = dict(config or {})
        valid = set(inspect.signature(cls.__init__).parameters) - {'self'}
        for key in config:
            if key not in valid:
                raise ValueError(f"Invalid argument '{key}' in config")
        kwargs.update(config)
        return cls(**kwargs)

    @spanned('fsw.conv')
    def forward(self, vertex_features, graph, *, slice_chunk=None,
                recipient_features=None, aggregate: str = 'auto',
                proj_gather_fn=None, exchange_chunks: int = 4,
                generator: Optional[torch.Generator] = None):
        """vertex_features (N, d_in) sender features; recipient_features
        (R, d_in) the recipients' own features for concat_self (default:
        vertex_features).  Under edge partitioning the senders are the
        exchanged padded-global matrix and the recipients the local shard;
        with `proj_gather_fn` (the overlapped exchange) vertex_features are
        the local shard's rows and the embedding exchanges their
        projections in `exchange_chunks` slice chunks
        (parallel/overlap.py).  `generator` draws the dropout masks in
        train mode.  Returns (R, out_channels)."""
        # weights_grad=False: the adjacency weights are data, never
        # parameters, which lets the rank kernel use uniform_w
        emb = self.fsw_embed(vertex_features, graph=graph,
                             slice_chunk=slice_chunk, aggregate=aggregate,
                             weights_grad=False,
                             proj_gather_fn=proj_gather_fn,
                             exchange_chunks=exchange_chunks)
        if self.concat_self:
            self_feats = (vertex_features if recipient_features is None
                          else recipient_features)
            emb = torch.cat([self.message_weight_vs_self * emb, self_feats],
                            dim=-1)
        return self.head(emb, generator)


@register_pooling('fsw_readout')
class FSWReadout(FSWConv):
    """Global graph pooling as a bipartite FSW aggregation.

    Call `readout(vertex_features, pool_graph)` where `pool_graph` comes
    from `graph.readout_graph(graph_index, num_vertices, batch_size)`: an
    edge of weight 1 from every vertex to its graph's node.  Returns
    (batch_size, out_channels).  The recipients are graph nodes with no
    features of their own, so concat_self only sizes the embedding (as in
    the JAX package); edgefeat_dim must be 0."""

    _self_features = False

    def __init__(self, in_channels: int, out_channels: int, **kwargs):
        if kwargs.get('edgefeat_dim', 0) != 0:
            raise ValueError('edgefeat_dim must be 0 in a global readout '
                             'layer')
        super().__init__(in_channels, out_channels, **kwargs)

    def forward(self, vertex_features, graph, *, slice_chunk=None,
                aggregate: str = 'auto',
                generator: Optional[torch.Generator] = None):
        """vertex_features (num_vertices, d_in); `generator` draws the
        dropout masks in train mode."""
        emb = self.fsw_embed(vertex_features, graph=graph,
                             slice_chunk=slice_chunk, aggregate=aggregate,
                             weights_grad=False)
        return self.head(emb, generator)
