"""The FSW graph convolution as a torch `nn.Module`.

Counterpart of `FSWConv` in `fsw_gnn_tpu/conv.py`, with the same defaults:
  * embed_dim = 2 * max(in, out) unless mlp_layers == 0 and not
    concat_self, which forces embed_dim = out_channels;
  * mlp_hidden_dim = max(in, out);
  * the embedding has a bias only when no MLP follows;
  * the degree encoding is 'homog' iff homog_degree_encoding;
  * the embedding uses freqs_init='spread';
  * MLP layer order Linear -> BatchNorm -> activation -> Dropout, with
    LeakyReLU(0.2) activations by default;
  * BatchNorm in train mode is flax's (`FlaxBatchNorm`);
  * Dropout draws its mask from the `generator` the caller passes to
    `forward` (it cannot match JAX's random stream).
The convolution consumes a prebuilt NeighborTable or MultiTable.  Train
and eval mode are torch's (`module.train()` / `.eval()`).
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, Optional

import torch
from torch import nn

from .device import resolve_device
from .embedding import FSWConfig
from .modules import FSWEmbedding
from .registry import register_layer


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
    running_var)."""

    DECAY = 0.99

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - self.DECAY,
                         dtype=dtype)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
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
    `rates[i]`."""

    def __init__(self, in_dim: int, out_channels: int, mlp_layers: int,
                 mlp_hidden_dim: int, bias: bool, mlp_init: Optional[str],
                 activation_final: Optional[Callable],
                 activation_hidden: Optional[Callable],
                 batchnorm_final: bool, batchnorm_hidden: bool,
                 dropout_final: float, dropout_hidden: float,
                 concat_self: bool, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        if mlp_layers == 0 and concat_self:
            raise NotImplementedError(
                'mlp_layers=0 with concat_self=True initializes its '
                'dimensionality reduction with the coherence minimizer '
                '(item 9 in ROADMAP.md), which is not ported yet')
        if mlp_init is not None and mlp_init not in _MLP_INITS:
            raise ValueError(f'invalid mlp_init {mlp_init!r}')
        self.mlp_layers = mlp_layers
        self.dense = nn.ModuleList()
        self.bn = nn.ModuleDict()
        self.acts = []
        self.rates = []
        if mlp_layers == 0:
            if batchnorm_final:
                self.bn['final'] = FlaxBatchNorm(in_dim, dtype=dtype)
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
                self.bn[str(i)] = FlaxBatchNorm(out_d, dtype=dtype)
            self.acts.append(activation_final if is_final
                             else activation_hidden)
            self.rates.append(dropout_final if is_final else dropout_hidden)
            in_d = out_d

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.mlp_layers == 0:
            return self.bn['final'](x) if 'final' in self.bn else x
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if str(i) in self.bn:
                x = self.bn[str(i)](x)
            if self.acts[i] is not None:
                x = self.acts[i](x)
            if self.training:
                x = dropout(x, self.rates[i], generator)
        return x


@register_layer('fsw_conv')
class FSWConv(nn.Module):
    """FSW message-passing layer over a NeighborTable or MultiTable.

    Call `conv(vertex_features, graph)` with vertex_features
    (N, in_channels) and a table whose recipients are the N nodes.  Edge
    features (edgefeat_dim > 0) ride in the tables' `edge_feat`.
    Parameters are drawn from `generator` (a fresh one seeded 0 when None)
    and placed on `device` (None: the card)."""

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
        self.fsw_embed = FSWEmbedding(self.embed_cfg, dtype=dtype,
                                      device='cpu', generator=gen)
        head_in = embed_dim + (in_channels if concat_self else 0)
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
            concat_self=concat_self, gen=gen, dtype=dtype)
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

    def forward(self, vertex_features, graph, *, slice_chunk=None,
                recipient_features=None, aggregate: str = 'auto',
                generator: Optional[torch.Generator] = None):
        """vertex_features (N, d_in) sender features; recipient_features
        (R, d_in) the recipients' own features for concat_self (default:
        vertex_features).  `generator` draws the dropout masks in train
        mode.  Returns (R, out_channels)."""
        # weights_grad=False: the adjacency weights are data, never
        # parameters, which lets the rank kernel use uniform_w
        emb = self.fsw_embed(vertex_features, graph=graph,
                             slice_chunk=slice_chunk, aggregate=aggregate,
                             weights_grad=False)
        if self.concat_self:
            self_feats = (vertex_features if recipient_features is None
                          else recipient_features)
            emb = torch.cat([self.message_weight_vs_self * emb, self_feats],
                            dim=-1)
        return self.head(emb, generator)
