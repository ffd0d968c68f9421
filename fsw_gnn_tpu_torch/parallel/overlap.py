"""Exchange overlapped with aggregation: the distributed FSW aggregation
with the sender projections exchanged in slice chunks.

Counterpart of `fsw_gnn_tpu/parallel/overlap.py`.  The FSW aggregation is
not edge-decomposable (the rank couples all of a recipient's edges), but
the slice axis is: the aggregation of slice chunk k needs only the
projection columns of chunk k.  So each rank projects its own rows, starts
every chunk's all-gather at once (async_op=True) and waits on chunk k's
handle just before chunk k's aggregation; the collectives of the later
chunks run behind the aggregation of the earlier ones.  On NCCL the wait
orders the compute stream after the collective; nothing waits on the host.

Per layer, with K chunks of exchange time T_x and aggregation time T_c,
serial costs K (T_x + T_c) and the overlap T_x + max(K T_c,
(K - 1) T_x + T_c).  Exchanging projections moves N S values a layer
against N d_in for raw features.

`fsw_embed_local_overlap` is the path the model takes
(`FSWGNN(..., proj_gather_fn=...)`, `make_distributed_train_step(...,
exchange='overlap')`): NeighborTable and MultiTable, edge features (their
projections stay local: edges belong to their recipient's shard) and
cartesian mode.  Each chunk aggregates through
`embedding.bucket_quadrature` on the route `_resolve_aggregate` gives the
chunk's width (K2, or K4 in cartesian mode, where the width fits; the
fused kernels K1 project inside the kernel and have no place here).
`pipelined_table_embed` / `make_overlapped_forward` are the JAX package's
first version on raw table arrays, kept with it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..embedding import (FSWConfig, _finalize, _mm, _resolve_aggregate,
                         _sinc_diff, bucket_quadrature, table_weights)
from ..graph import MultiTable
from .collectives import start_all_gather


def _chunk_grid(cfg: FSWConfig, n_chunks: int):
    """(chunk width, number of chunks, padded slice count)."""
    S = cfg.nSlices
    n_chunks = max(1, min(n_chunks, S))
    chunk = -(-S // n_chunks)
    n_chunks = -(-S // chunk)
    return chunk, n_chunks, chunk * n_chunks


def _result(gathered):
    """A chunk's gathered projections: a tensor, or an exchange in flight
    (anything with `wait()`), waited for here."""
    return gathered.wait() if hasattr(gathered, 'wait') else gathered


def fsw_embed_local_overlap(X_local, graph, proj, freqs, cfg: FSWConfig,
                            proj_gather_fn, n_chunks: int = 4, bias=None,
                            total_mass_scale=None, aggregate: str = 'auto',
                            weights_grad: bool = True):
    """The table embedding of this rank's recipients, with the sender
    projections exchanged in `n_chunks` slice chunks.

    X_local (R_shard, d_in): this rank's node features; `graph` its
    NeighborTable or MultiTable (tensors on X's device) whose sender ids
    index the padded-global (P * R_shard) layout.  `proj_gather_fn` maps a
    chunk's (R_shard, chunk) projections to the (P * R_shard, chunk)
    gathered ones, or to an exchange in flight whose `wait()` gives them
    (`collectives.start_all_gather`); the identity on one device.  Every
    chunk's exchange starts before the first aggregation.  Returns
    (R_shard, d_out) (or (R_shard, nSlices, nFreqs) in non-collapsed
    cartesian mode)."""
    dt = X_local.dtype
    S = cfg.nSlices
    chunk, n_chunks, S_pad = _chunk_grid(cfg, n_chunks)
    Xp_local = F.pad(_mm(X_local, proj[:, :cfg.d_in].t()), (0, S_pad - S))
    if cfg.cartesian_mode:
        slice_freqs = freqs.expand((S,) + tuple(freqs.shape))   # (S, F)
        f_pad = F.pad(slice_freqs, (0, 0, 0, S_pad - S))
    else:
        f_pad = F.pad(freqs, (0, S_pad - S))
    V_edge = None
    if cfg.d_edge > 0:
        # shard-local edge projections; padded slices have zero vectors
        V_edge = F.pad(proj[:, cfg.d_in:], (0, 0, 0, S_pad - S))

    # every chunk's exchange starts now, before any aggregation
    pending = [proj_gather_fn(Xp_local[:, k * chunk:(k + 1) * chunk])
               for k in range(n_chunks)]
    gathered = [None] * n_chunks

    def chunk_rows(k):
        if gathered[k] is None:
            gathered[k] = _result(pending[k])
        return gathered[k]

    is_multi = isinstance(graph, MultiTable)
    raws, wsums = [], []
    for t in (graph.tables if is_multi else (graph,)):
        w_sum, wn, pad_norm = table_weights(t.weight, cfg)
        agg = _resolve_aggregate(aggregate, cfg, t.bucket_size, s_eff=chunk,
                                 weights_grad=weights_grad,
                                 device=Xp_local.device)
        cols = []
        for k in range(n_chunks):
            Pk = chunk_rows(k)[t.idx]                        # (R, B, chunk)
            if cfg.d_edge > 0:
                if t.edge_feat is None:
                    raise ValueError('cfg.d_edge > 0 but the shard has no '
                                     'edge features')
                Pk = Pk + _mm(t.edge_feat,
                              V_edge[k * chunk:(k + 1) * chunk].t())
            cols.append(bucket_quadrature(
                Pk, wn, pad_norm, f_pad[k * chunk:(k + 1) * chunk], cfg,
                agg, weights_grad, uniform_w=bool(t.uniform_w)))
        raws.append(torch.cat(cols, dim=1)[:, :S])
        wsums.append(w_sum)

    if not is_multi:
        return _finalize(raws[0].to(dt), wsums[0].to(dt), cfg, bias,
                         total_mass_scale)
    R = graph.num_recipients
    tail = ((cfg.nSlices, cfg.nFreqs) if cfg.cartesian_mode
            else (cfg.nSlices,))
    emb = X_local.new_zeros((R + 1,) + tail)
    w_sum = X_local.new_zeros((R + 1,))
    for ids, raw, ws in zip(graph.row_ids, raws, wsums):
        emb.index_copy_(0, ids, raw.to(dt))
        w_sum.index_copy_(0, ids, ws.to(dt))
    return _finalize(emb[:R], w_sum[:R], cfg, bias, total_mass_scale)


def _chunk_quadrature(Pk, wn, pad_norm, f_k):
    """The sort route's quadrature of one slice chunk: Pk (R, B, Sk)
    gathered projections, wn (R, B), pad_norm (R,), f_k (Sk,).  Returns
    (R, Sk)."""
    keys = Pk.transpose(1, 2)                              # (R, Sk, B)
    ps, order = torch.sort(keys, dim=-1, stable=True)
    ws = torch.gather(wn[:, None, :].expand(keys.shape), -1, order)
    c = torch.cumsum(ws, dim=2) + pad_norm[:, None, None] * (ps > 0)
    sd = _sinc_diff(ws, c, f_k[None, :, None])
    return (1.0 + f_k) * torch.sum(ps * sd, dim=2)


def pipelined_table_embed(X_local, tbl_idx, tbl_w, proj, freqs,
                          cfg: FSWConfig, n_chunks: int = 4,
                          bias=None, total_mass_scale=None):
    """The first version of the overlapped embedding, on raw arrays of one
    table a shard (`partition_graph(..., layout='table')`): X_local
    (R_shard, d_in), tbl_idx (R_shard, B) padded-global sender ids, tbl_w
    (R_shard, B).  Each rank projects its own rows, starts every chunk's
    all-gather, and sorts each chunk on arrival.  Neither
    cartesian mode nor edge features."""
    if cfg.cartesian_mode or cfg.d_edge != 0:
        raise ValueError('pipelined_table_embed takes neither cartesian '
                         'mode nor edge features')
    dt = X_local.dtype
    S = cfg.nSlices
    w_sum, wn, pad_norm = table_weights(tbl_w, cfg)
    chunk = -(-S // n_chunks)
    S_pad = chunk * n_chunks
    Xp_local = F.pad(_mm(X_local, proj[:, :cfg.d_in].t()), (0, S_pad - S))
    f_pad = F.pad(freqs, (0, S_pad - S))
    pending = [start_all_gather(Xp_local[:, k * chunk:(k + 1) * chunk])
               for k in range(n_chunks)]
    outs = []
    for k in range(n_chunks):
        Pk = pending[k].wait()[tbl_idx]                    # (R, B, chunk)
        outs.append(_chunk_quadrature(Pk, wn, pad_norm,
                                      f_pad[k * chunk:(k + 1) * chunk]))
    emb = torch.cat(outs, dim=1)[:, :S]
    return _finalize(emb.to(dt), w_sum, cfg, bias, total_mass_scale)


def make_overlapped_forward(shards, mesh, cfg: FSWConfig, proj, freqs,
                            n_chunks: int = 4):
    """fwd(X_local) -> this rank's (R_shard, d_out) embeddings through
    `pipelined_table_embed`, on the shards' one table a shard (build them
    with layout='table')."""
    if shards.tbl_idx is None:
        raise ValueError("build the shards with layout='table'")
    idx = torch.as_tensor(shards.tbl_idx[mesh.rank]).long().to(mesh.device)
    w = torch.as_tensor(shards.tbl_w[mesh.rank]).to(mesh.device)

    def fwd(X_local):
        return pipelined_table_embed(X_local, idx, w, proj, freqs, cfg,
                                     n_chunks=n_chunks)
    return fwd
