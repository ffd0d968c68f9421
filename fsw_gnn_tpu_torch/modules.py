"""The FSW embedding as a torch `nn.Module`.

Counterpart of `fsw_gnn_tpu/modules.py`, for the neighbor-table layouts.
Parameters `proj_vecs`, `freqs`, optional `bias` and `total_mass_scale`
are `nn.Parameter`s when learnable and buffers otherwise (the JAX package
keeps the latter in its 'fsw_fixed' collection).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .device import resolve_device
from .embedding import FSWConfig, fsw_embed_multi_table, fsw_embed_table
from .graph import MultiTable, NeighborTable
from .params import bias_shape, generate_freqs, generate_proj_vecs


class FSWEmbedding(nn.Module):
    """Fourier Sliced-Wasserstein embedding of graph neighborhoods.

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
        put('proj_vecs', generate_proj_vecs(gen, cfg), cfg.learnable_slices)
        put('freqs', generate_freqs(gen, cfg), cfg.learnable_freqs)
        if cfg.enable_bias:
            put('bias', torch.zeros(bias_shape(cfg)), cfg.learnable_slices)
        if cfg.encode_total_mass:
            put('total_mass_scale',
                torch.tensor(cfg.total_mass_encoding_scale),
                cfg.learnable_total_mass_encoding_scale)

    def forward(self, X, W=None, *, graph=None, slice_chunk=None,
                aggregate: str = 'auto', weights_grad: bool = True):
        """X (num_nodes, d_in) sender features; `graph` a NeighborTable or
        MultiTable (moved to X's device when needed).  Returns
        (num_recipients, d_out).  `W` (a multiset's weights or a dense
        adjacency) is not ported yet and must be None."""
        cfg = self.cfg
        if W is not None or not isinstance(graph, (MultiTable,
                                                    NeighborTable)):
            raise NotImplementedError(
                'only the NeighborTable / MultiTable layouts are ported: '
                'dense multisets and dense adjacencies are item 6 and the '
                'CSR Graph is item 7 in ROADMAP.md')
        if cfg.out_dim == 0:
            return X.new_zeros((graph.num_recipients, 0))
        graph = graph.to(X.device)
        kw = dict(bias=getattr(self, 'bias', None),
                  total_mass_scale=getattr(self, 'total_mass_scale', None),
                  slice_chunk=slice_chunk, aggregate=aggregate,
                  weights_grad=weights_grad)
        embed = (fsw_embed_multi_table if isinstance(graph, MultiTable)
                 else fsw_embed_table)
        return embed(X, graph, self.proj_vecs, self.freqs, cfg, **kw)
