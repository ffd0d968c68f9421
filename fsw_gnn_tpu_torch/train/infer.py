"""Exact memory-capped full-neighbor inference (layer-wise, chunked).

Counterpart of `fsw_gnn_tpu/train/infer.py`.  A full-graph forward
materializes (E, S) quadrature intermediates for the whole edge list at
once; this module evaluates the same function with device memory bounded
by a recipient chunk:

  * layer activations live on the host as (N, d) numpy arrays (the GNN's
    layer outputs are the only O(N) state -- the GraphSAGE layer-wise
    inference layout); the sender matrix goes to the device once a layer;
  * each layer processes recipients in fixed `node_chunk` slices; a
    chunk's incoming edges are a contiguous slice of the CSR edge list
    (dst-sorted), cut on the host and padded to one edge envelope shared
    by every chunk;
  * chunk subgraphs keep global sender ids (num_nodes = N) and the full
    graph's edge weights, so self-loop / gcn weighting and the degree
    encoding are those of the full-graph forward.

Each chunk runs the model's own layer (`model.convs[i]`) in eval mode, as
`FSWGNN.forward` calls it.  Peak device working set a step: the
(N, d_layer) sender matrix plus O(E_chunk * S) quadrature intermediates,
against O(E * S) for the one-shot forward.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..graph import Graph


def _chunk_graphs(graph: Graph, node_chunk: int):
    """Cut the (square, dst-sorted) CSR graph into per-recipient-chunk
    host subgraphs sharing one edge envelope.  Returns (chunks, bounds,
    e_cap): the chunk Graphs (num_nodes = N senders, node_chunk
    recipients, e_cap edges), their recipient ranges [r0, r1), and the
    envelope."""
    N = graph.num_recipients
    if graph.num_nodes != N:
        raise ValueError('layer-wise inference needs a square graph')
    src = np.asarray(graph.src)
    dst = np.asarray(graph.dst)
    weight = np.asarray(graph.weight)
    row_ptr = np.asarray(graph.row_ptr)
    in_deg = np.asarray(graph.in_degrees)
    ef = None if graph.edge_feat is None else np.asarray(graph.edge_feat)

    n_chunks = -(-N // node_chunk)
    bounds = [(k * node_chunk, min((k + 1) * node_chunk, N))
              for k in range(n_chunks)]
    # padded edges live in the last row's CSR range (from_edge_index pads
    # with dst = num_recipients - 1), so the final chunk's slice includes
    # them; they carry weight 0 and are exact through the quadrature
    edges = [(int(row_ptr[r0]), int(row_ptr[min(r1, N)]))
             for r0, r1 in bounds]
    e_cap = max(128, -(-max(e1 - e0 for e0, e1 in edges) // 128) * 128)

    chunks = []
    for (r0, r1), (e0, e1) in zip(bounds, edges):
        n_e = e1 - e0
        pad = e_cap - n_e
        rows = node_chunk
        src_c = np.concatenate([src[e0:e1], np.zeros(pad, src.dtype)])
        dst_c = np.concatenate([dst[e0:e1] - r0,
                                np.full(pad, rows - 1, dst.dtype)])
        w_c = np.concatenate([weight[e0:e1], np.zeros(pad, weight.dtype)])
        ef_c = None if ef is None else np.concatenate(
            [ef[e0:e1], np.zeros((pad,) + ef.shape[1:], ef.dtype)])
        rp = row_ptr[r0:min(r1, N) + 1].astype(np.int64) - e0
        if rp.shape[0] < rows + 1:                 # final short chunk
            rp = np.concatenate(
                [rp, np.full(rows + 1 - rp.shape[0], rp[-1], rp.dtype)])
        rp[-1] = e_cap                             # padding joins last row
        deg_c = np.zeros(rows, in_deg.dtype)
        deg_c[:r1 - r0] = in_deg[r0:r1]
        so = np.argsort(src_c, kind='stable')
        chunks.append(Graph(
            src=src_c.astype(np.int32), dst=dst_c.astype(np.int32),
            weight=w_c, row_ptr=rp.astype(np.int32), in_degrees=deg_c,
            edge_feat=ef_c, src_order=so.astype(np.int32),
            src_sorted=src_c[so].astype(np.int32),
            num_nodes=N, num_recipients=rows, num_edges=e_cap))
    return chunks, bounds, e_cap


def layerwise_predict(model, X, graph: Graph, node_chunk: int,
                      slice_chunk: Optional[int] = None,
                      device=None) -> np.ndarray:
    """Exact logits of `model(X, graph)` in eval mode with device memory
    capped by `node_chunk` recipients a step.

    `model` an FSWGNN on `device` (None: the card); X (N, d_in) on the
    host or the device; `graph` the square host CSR Graph.  `slice_chunk`
    defaults to the model's.  Returns a host (N, num_classes) float32
    array."""
    dev = resolve_device(device)
    chunks, bounds, _ = _chunk_graphs(graph, node_chunk)
    N = graph.num_recipients
    x_cur = (X.detach().cpu().numpy() if isinstance(X, torch.Tensor)
             else np.asarray(X)).astype(np.float32, copy=False)
    sc = slice_chunk if slice_chunk is not None else model.slice_chunk
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for conv in model.convs:
                x_dev = torch.from_numpy(x_cur).to(dev)
                out = None
                for g_c, (r0, r1) in zip(chunks, bounds):
                    recip = torch.zeros((node_chunk, x_cur.shape[1]),
                                        dtype=torch.float32, device=dev)
                    recip[:r1 - r0] = x_dev[r0:r1]
                    res = conv(x_dev, g_c.to(dev), slice_chunk=sc,
                               recipient_features=recip,
                               aggregate=model.aggregate)
                    if out is None:
                        out = np.empty((N, res.shape[-1]), np.float32)
                    out[r0:r1] = res[:r1 - r0].cpu().numpy()
                x_cur = out
    finally:
        model.train(was_training)
    return x_cur
