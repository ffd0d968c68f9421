"""Stacked FSW-GNN models.

Counterpart of `fsw_gnn_tpu/models/gnn.py`: `FSWGNN`, an N-layer node
classifier of `FSWConv`s, and `FSWGraphClassifier`, a conv stack with FSW
readout pooling and a linear head.  The same FSWGNN runs on one device and
on one rank of the edge-partitioned trainer (parallel/dist.py), which
passes the boundary exchange (`gather_fn` or `proj_gather_fn`) and builds
the model with cross-rank BatchNorm (`bn_axis_name`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import math

import torch
from torch import nn

from ..conv import FSWConv, FSWReadout, leaky_relu_02
from ..device import resolve_device
from ..utils.profiling import span

class FSWGNN(nn.Module):
    """N-layer FSW-GNN for node-level prediction.

    hidden_dims: feature dims after each conv layer; the last entry is the
    output dim (e.g. num_classes).  Layer i is `convs[i]` (the JAX
    package's 'conv_{i}').  `bn_axis_name` (a mesh axis name, as the JAX
    package's 'graph') takes BatchNorm's train-mode statistics over every
    rank's rows (`conv.FlaxBatchNorm`).  Parameters
    are drawn from `generator` (a fresh one seeded 0 when None) and placed
    on `device` (None: the card)."""

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
        self.bn_axis_name = bn_axis_name
        self.slice_chunk = slice_chunk
        self.aggregate = aggregate
        self.dtype = dtype
        self.convs = nn.ModuleList(
            gnn_layer_conv(self, i, generator=gen, device=device)
            for i in range(len(self.hidden_dims)))
        self.to(device)

    def forward(self, vertex_features, graph, *, gather_fn=None,
                proj_gather_fn=None, exchange_chunks: int = 4,
                generator: Optional[torch.Generator] = None):
        """vertex_features (N, in_channels); `graph` a CSR Graph,
        NeighborTable or MultiTable over the N nodes.  `generator` draws
        the dropout masks in train mode.  Returns (N, hidden_dims[-1]).

        Under edge partitioning vertex_features are this rank's rows and
        `graph` its shard (`parallel.partition.local_graph`):
        `gather_fn` assembles every layer's sender matrix from the local
        rows (an all-gather or an all-to-all; the identity on one device),
        or `proj_gather_fn` keeps the features local and exchanges each
        layer's sender projections in `exchange_chunks` slice chunks
        inside the embedding (parallel/overlap.py; tables only)."""
        if gather_fn is not None and proj_gather_fn is not None:
            raise ValueError('pass gather_fn or proj_gather_fn, not both')
        x = vertex_features
        for i, conv in enumerate(self.convs):
            with span('fsw.gnn.layer', layer=i):
                senders = x if gather_fn is None else gather_fn(x)
                x = conv(senders, graph, slice_chunk=self.slice_chunk,
                         recipient_features=x, aggregate=self.aggregate,
                         proj_gather_fn=proj_gather_fn,
                         exchange_chunks=exchange_chunks,
                         generator=generator)
        return x


def gnn_layer_conv(model: FSWGNN, i: int, *,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> FSWConv:
    """The i-th layer's FSWConv of an FSWGNN, built on `device` (None:
    the card) as the JAX package's `gnn_layer_conv` builds it: the last
    layer has no activation, no BatchNorm and no dropout."""
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
        bn_axis_name=model.bn_axis_name,
        dtype=model.dtype,
        device=device,
        generator=generator)


class FSWGraphClassifier(nn.Module):
    """Conv stack, FSW readout pooling and a linear classification head.

    `gnn` is an FSWGNN over `hidden_dims`; `readout` an FSWReadout from
    hidden_dims[-1] to readout_dim (default hidden_dims[-1]) with
    concat_self off; `cls_head` a Linear to num_classes, initialized as
    flax's Dense (LeCun-normal weights, zero bias).  Parameters are drawn
    from `generator` (a fresh one seeded 0 when None) and placed on
    `device` (None: the card)."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int],
                 num_classes: int, readout_dim: Optional[int] = None,
                 minimize_slice_coherence: bool = True,
                 mlp_layers: int = 1,
                 dtype=torch.float32,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        hidden_dims = tuple(hidden_dims)
        rd = readout_dim or hidden_dims[-1]
        self.gnn = FSWGNN(in_channels, hidden_dims,
                          minimize_slice_coherence=minimize_slice_coherence,
                          mlp_layers=mlp_layers, dtype=dtype, device=device,
                          generator=gen)
        self.readout = FSWReadout(
            hidden_dims[-1], rd, concat_self=False,
            minimize_slice_coherence=minimize_slice_coherence,
            mlp_layers=mlp_layers, dtype=dtype, device=device,
            generator=gen)
        self.cls_head = nn.Linear(rd, num_classes, dtype=dtype)
        with torch.no_grad():
            # flax's lecun_normal: a normal truncated at two standard
            # deviations, scaled to variance 1 / fan_in
            std = 1.0 / math.sqrt(rd) / 0.87962566103423978
            nn.init.trunc_normal_(self.cls_head.weight, std=std,
                                  a=-2.0 * std, b=2.0 * std, generator=gen)
            self.cls_head.bias.zero_()
        self.to(device)

    def forward(self, vertex_features, graph, pool_graph, *,
                generator: Optional[torch.Generator] = None):
        """vertex_features (N, in_channels); `graph` over the N vertices of
        the batch; `pool_graph` from `graph.readout_graph`.  Returns
        (batch_size, num_classes) logits."""
        x = self.gnn(vertex_features, graph, generator=generator)
        pooled = self.readout(x, pool_graph, generator=generator)
        return self.cls_head(pooled)
