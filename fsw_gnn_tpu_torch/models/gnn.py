"""Stacked FSW-GNN models.

Counterpart of `fsw_gnn_tpu/models/gnn.py` for one device: `FSWGNN`, an
N-layer node classifier of `FSWConv`s.  The edge-partitioned exchanges
(`gather_fn`, `proj_gather_fn`) and cross-shard BatchNorm belong to the
distributed trainer (item 14 in ROADMAP.md); `FSWGraphClassifier` waits for
`FSWReadout` (item 10).  Neither is ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..conv import FSWConv, leaky_relu_02
from ..device import resolve_device

_DIST_TODO = ('the edge-partitioned exchanges (gather_fn, proj_gather_fn, '
              'bn_axis_name) belong to the distributed trainer, item 14 in '
              'ROADMAP.md, which is not ported yet')


class FSWGNN(nn.Module):
    """N-layer FSW-GNN for node-level prediction.

    hidden_dims: feature dims after each conv layer; the last entry is the
    output dim (e.g. num_classes).  Layer i is `convs[i]` (the JAX
    package's 'conv_{i}').  Parameters are drawn from `generator` (a fresh
    one seeded 0 when None) and placed on `device` (None: the card)."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int],
                 edgefeat_dim: int = 0,
                 embed_dim: Optional[int] = None,
                 minimize_slice_coherence: bool = True,
                 encode_vertex_degrees: bool = True,
                 homog_degree_encoding: bool = False,
                 mlp_layers: int = 1,
                 bias: bool = True,
                 dropout: float = 0.0,
                 batchnorm: bool = False,
                 bn_axis_name: Optional[str] = None,
                 slice_chunk: Optional[int] = None,
                 aggregate: str = 'auto',
                 dtype=torch.float32,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if bn_axis_name is not None:
            raise NotImplementedError(_DIST_TODO)
        device = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.in_channels = in_channels
        self.hidden_dims = tuple(hidden_dims)
        self.edgefeat_dim = edgefeat_dim
        self.embed_dim = embed_dim
        self.minimize_slice_coherence = minimize_slice_coherence
        self.encode_vertex_degrees = encode_vertex_degrees
        self.homog_degree_encoding = homog_degree_encoding
        self.mlp_layers = mlp_layers
        self.bias = bias
        self.dropout = dropout
        self.batchnorm = batchnorm
        self.slice_chunk = slice_chunk
        self.aggregate = aggregate
        self.dtype = dtype
        self.convs = nn.ModuleList(
            gnn_layer_conv(self, i, generator=gen)
            for i in range(len(self.hidden_dims)))
        self.to(device)

    def forward(self, vertex_features, graph, *, gather_fn=None,
                proj_gather_fn=None,
                generator: Optional[torch.Generator] = None):
        """vertex_features (N, in_channels); `graph` a NeighborTable or
        MultiTable over the N nodes.  `generator` draws the dropout masks
        in train mode.  Returns (N, hidden_dims[-1])."""
        if gather_fn is not None or proj_gather_fn is not None:
            raise NotImplementedError(_DIST_TODO)
        x = vertex_features
        for conv in self.convs:
            x = conv(x, graph, slice_chunk=self.slice_chunk,
                     recipient_features=x, aggregate=self.aggregate,
                     generator=generator)
        return x


def gnn_layer_conv(model: FSWGNN, i: int, *,
                   generator: Optional[torch.Generator] = None) -> FSWConv:
    """The i-th layer's FSWConv of an FSWGNN, built on the CPU as the JAX
    package's `gnn_layer_conv` builds it: the last layer has no
    activation, no BatchNorm and no dropout."""
    d_in = model.in_channels if i == 0 else model.hidden_dims[i - 1]
    is_last = i == len(model.hidden_dims) - 1
    return FSWConv(
        in_channels=d_in,
        out_channels=model.hidden_dims[i],
        edgefeat_dim=model.edgefeat_dim if i == 0 else 0,
        embed_dim=model.embed_dim,
        minimize_slice_coherence=model.minimize_slice_coherence,
        encode_vertex_degrees=model.encode_vertex_degrees,
        homog_degree_encoding=model.homog_degree_encoding,
        mlp_layers=model.mlp_layers,
        bias=model.bias,
        mlp_activation_final=None if is_last else leaky_relu_02,
        batchnorm_final=model.batchnorm and not is_last,
        dropout_final=0.0 if is_last else model.dropout,
        dtype=model.dtype,
        device='cpu',
        generator=generator)
