"""The FSW embedding as a torch `nn.Module`, and two helpers on slice
parameters.

Counterpart of `fsw_gnn_tpu/modules.py`: the CSR `Graph`, neighbor-table
layouts, dense multisets and dense adjacencies, and the distributed
trainer's overlapped exchange.
Parameters `proj_vecs`, `freqs`, optional `bias` and `total_mass_scale`
are `nn.Parameter`s when learnable and buffers otherwise (the JAX package
keeps the latter in its 'fsw_fixed' collection).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .device import resolve_device
from .embedding import (FSWConfig, fsw_embed_graph, fsw_embed_graph_dense,
                        fsw_embed_multi_table, fsw_embed_multiset,
                        fsw_embed_table)
from .graph import Graph, MultiTable, NeighborTable
from .params import bias_shape, generate_freqs, generate_proj_vecs
from .utils.profiling import spanned


def spread_freqs_at_interval(freqs, center: float, radius: float):
    """Equispaced frequencies on [center - radius, center + radius], of
    freqs' shape, dtype and device: the new tensor to copy into an
    `FSWEmbedding`'s `freqs`."""
    if radius < 0:
        raise ValueError('radius must be >= 0')
    nF = freqs.shape[0]
    if nF == 1 or radius == 0:
        return torch.full_like(freqs, center)
    spread = 2 * (0.5 + torch.arange(nF, dtype=freqs.dtype,
                                     device=freqs.device)) / nF - 1
    return center + radius * (spread / (1 - 1 / nF))


def get_mutual_coherence(proj_vecs):
    """Max |off-diagonal Gram entry| of the slice vectors (rows)."""
    G = proj_vecs @ proj_vecs.t()
    return torch.max(torch.abs(G - torch.diag(torch.diag(G))))


class FSWEmbedding(nn.Module):
    """Fourier Sliced-Wasserstein embedding of multisets and graph
    neighborhoods.

    Parameters are drawn from `generator` (a fresh one seeded 0 when None)
    and placed on `device` (None: the card)."""

    def __init__(self, cfg: FSWConfig, *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))

        def put(name, value, learnable):
            value = value.to(device=device, dtype=dtype)
            if learnable:
                self.register_parameter(name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)

        if cfg.out_dim == 0:
            return
        # the slice vectors' coherence minimizer runs on `device`
        put('proj_vecs', generate_proj_vecs(gen, cfg, dtype, device),
            cfg.learnable_slices)
        put('freqs', generate_freqs(gen, cfg, dtype, device),
            cfg.learnable_freqs)
        if cfg.enable_bias:
            put('bias', torch.zeros(bias_shape(cfg)), cfg.learnable_slices)
        if cfg.encode_total_mass:
            put('total_mass_scale',
                torch.tensor(cfg.total_mass_encoding_scale),
                cfg.learnable_total_mass_encoding_scale)

    @spanned('fsw.embed')
    def forward(self, X, W=None, *, graph=None, X_edge=None,
                graph_mode: bool = False, w_mode: str = 'unit',
                slice_chunk=None, aggregate: str = 'auto',
                weights_grad: bool = True, proj_gather_fn=None,
                exchange_chunks: int = 4):
        """Dispatches as the JAX module does: a `graph` (CSR Graph,
        NeighborTable or MultiTable, moved to X's device when needed; X
        (num_nodes, d_in))
        first, giving (num_recipients, d_out), W ignored (with
        `proj_gather_fn`, the overlapped exchange of the distributed
        trainer: X is this shard's rows, the graph a NeighborTable or
        MultiTable over the padded-global senders, and the sender
        projections are exchanged in `exchange_chunks` slice chunks, more
        where `slice_chunk` asks for narrower ones; parallel/overlap.py);
        then
        `graph_mode=True` with a dense adjacency W (..., R, n), X
        (..., n, d_in) and optional X_edge, giving (..., R, d_out); else
        a batch of multisets X (..., n, d_in) with weights W (..., n) or
        None (`w_mode` 'unit' or 'uniform'), giving (..., d_out).  With
        out_dim == 0 every call gives zeros of those shapes.  A CSR Graph
        takes no
        `aggregate` or `weights_grad`, as in the JAX package: it always
        sorts, and its weights take a gradient when they require one."""
        cfg = self.cfg
        if cfg.out_dim == 0:
            if graph is not None:
                lead = (graph.num_recipients,)
            else:
                lead = (W.shape[:-1] if graph_mode and W is not None
                        else X.shape[:-2])
            return X.new_zeros(tuple(lead) + (0,))
        kw = dict(bias=getattr(self, 'bias', None),
                  total_mass_scale=getattr(self, 'total_mass_scale', None),
                  slice_chunk=slice_chunk)
        if graph is not None:
            if proj_gather_fn is not None:
                if not isinstance(graph, (MultiTable, NeighborTable)):
                    raise ValueError('the overlapped exchange needs a '
                                     'NeighborTable or MultiTable layout')
                from .parallel.overlap import fsw_embed_local_overlap
                # the overlap's slice chunks are a slice serialization:
                # a tighter slice_chunk raises their number
                n_chunks = exchange_chunks
                if slice_chunk is not None:
                    n_chunks = max(n_chunks, -(-cfg.nSlices // slice_chunk))
                return fsw_embed_local_overlap(
                    X, graph.to(X.device), self.proj_vecs, self.freqs, cfg,
                    proj_gather_fn=proj_gather_fn, n_chunks=n_chunks,
                    bias=kw['bias'], total_mass_scale=kw['total_mass_scale'],
                    aggregate=aggregate, weights_grad=weights_grad)
            if isinstance(graph, Graph):
                return fsw_embed_graph(X, graph, self.proj_vecs, self.freqs,
                                       cfg, **kw)
            graph = graph.to(X.device)
            embed = (fsw_embed_multi_table if isinstance(graph, MultiTable)
                     else fsw_embed_table)
            return embed(X, graph, self.proj_vecs, self.freqs, cfg,
                         aggregate=aggregate, weights_grad=weights_grad, **kw)
        if graph_mode:
            return fsw_embed_graph_dense(X, W, self.proj_vecs, self.freqs,
                                         cfg, X_edge=X_edge, **kw)
        return fsw_embed_multiset(X, W, self.proj_vecs, self.freqs, cfg,
                                  w_mode=w_mode, aggregate=aggregate,
                                  weights_grad=weights_grad, **kw)
