"""Edge partitioning of CSR graphs across the ranks.

Counterpart of `fsw_gnn_tpu/parallel/partition.py`, in numpy on the host,
giving the same arrays bit for bit.  Each shard owns a contiguous range
of recipients and all of their in-edges; since the global edge list is
sorted by recipient, every shard's edges are one contiguous slab.
Recipients are split greedily so each shard carries about E / P edges,
and every shard is padded to the same (E_shard, R_shard), stacked on a
leading shard axis.

Every rank builds the same `GraphShards` from the same graph and keeps
its own slice: `local_graph(shards, rank, exchange)` is the layout that
rank computes on (the JAX package's `dist._local_graph`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..graph import (Graph, MultiTable, NeighborTable, _detect_uniform_w,
                     degree_classes, to_multi_table)


@dataclasses.dataclass
class GraphShards:
    """P stacked, identically shaped local graphs (leading axis = shard).

    Node features live in the same padded per-shard layout as recipient
    ownership: shard p stores rows [recip_start[p], recip_start[p] + count)
    of the global feature matrix in a (R_shard, d) buffer (zero-padded), so
    the all-gathered sender matrix is the uniform (P * R_shard, d) stack.
    `src` is in padded-global ids (owner * R_shard + local row); `dst` in
    local (shard-relative) recipient ids.  The optional layouts: one
    neighbor table a shard (`tbl_*`, layout='table'), degree-bucketed
    MultiTables with one class structure for every shard (`mtbl_*`,
    layout 'auto' / 'multi'), and the all-to-all exchange's ids
    (`a2a_*`: a2a_send_idx[q, p] the local rows of shard q that shard p
    needs; a2a_src / a2a_tbl_idx / a2a_mtbl_idx the sender ids remapped
    into the received (P * a2a_rows) buffer).
    """
    src: np.ndarray          # (P, E_shard) int32, padded-global sender ids
    dst: np.ndarray          # (P, E_shard) int32, local recipient ids
    weight: np.ndarray       # (P, E_shard)
    row_ptr: np.ndarray      # (P, R_shard + 1) int32
    in_degrees: np.ndarray   # (P, R_shard)
    recip_start: np.ndarray  # (P,) int32 global id of local recipient 0
    recip_count: np.ndarray  # (P,) int32 real recipients of the shard
    src_order: Optional[np.ndarray] = None   # (P, E_shard)
    src_sorted: Optional[np.ndarray] = None  # (P, E_shard)
    edge_feat: Optional[np.ndarray] = None   # (P, E_shard, d_edge)
    tbl_idx: Optional[np.ndarray] = None     # (P, R_shard, B) int32
    tbl_w: Optional[np.ndarray] = None       # (P, R_shard, B)
    a2a_send_idx: Optional[np.ndarray] = None   # (P, P, L) int32
    a2a_src: Optional[np.ndarray] = None        # (P, E_shard) int32
    a2a_tbl_idx: Optional[np.ndarray] = None    # (P, R_shard, B) int32
    a2a_rows: int = 0
    mtbl_idx: Optional[tuple] = None           # per class (P, R_c, B_c)
    mtbl_w: Optional[tuple] = None
    mtbl_rows: Optional[tuple] = None          # (P, R_c) local recipients
    mtbl_ef: Optional[tuple] = None            # (P, R_c, B_c, d_edge)
    a2a_mtbl_idx: Optional[tuple] = None
    mtbl_uniform: Optional[tuple] = None       # per class, AND over shards
    tbl_uniform: bool = False
    num_nodes: int = 0
    num_recipients: int = 0
    num_shards: int = 1
    shard_num_recipients: int = 0

    @property
    def shard_num_edges(self) -> int:
        return self.src.shape[1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _shard_degrees(rp: np.ndarray) -> np.ndarray:
    """Real in-degree of every local row of one shard's row pointers."""
    ne = int(rp[-1])
    return np.diff(np.minimum(rp, ne))


def partition_graph(graph: Graph, num_shards: int,
                    pad_multiple: int = 128,
                    layout: str = 'auto',
                    with_all_to_all: bool = True) -> GraphShards:
    """Split a square CSR `Graph` (recipients == senders == nodes) into
    `num_shards` recipient-contiguous shards balanced by edge count, with
    the sender ids remapped into the padded per-shard node layout.
    `layout`: 'auto' or 'multi' (degree-bucketed MultiTables), 'table'
    (one table a shard, without edge features) or anything else (CSR
    only); `with_all_to_all` adds the all-to-all exchange's ids."""
    if graph.num_recipients != graph.num_nodes:
        raise ValueError('edge partitioning needs a square graph '
                         '(num_recipients == num_nodes)')
    row_ptr = np.asarray(graph.row_ptr, np.int64)
    src = np.asarray(graph.src)
    dst = np.asarray(graph.dst)
    w = np.asarray(graph.weight)
    indeg = np.asarray(graph.in_degrees)
    ef = None if graph.edge_feat is None else np.asarray(graph.edge_feat)
    R = graph.num_recipients
    E_real = graph.num_edges

    # greedy contiguous split of the recipients, E_real / P edges a shard
    target = E_real / num_shards
    bounds = [0]
    for p in range(1, num_shards):
        b = int(np.searchsorted(row_ptr[:R + 1], p * target, side='left'))
        bounds.append(max(bounds[-1], min(b, R)))
    bounds.append(R)

    R_shard = max(_round_up(max(bounds[p + 1] - bounds[p]
                                for p in range(num_shards)), 8), 8)
    E_shard = max(_round_up(max(int(row_ptr[bounds[p + 1]]
                                    - row_ptr[bounds[p]])
                                for p in range(num_shards)), pad_multiple),
                  pad_multiple)

    P = num_shards
    o_src = np.zeros((P, E_shard), np.int32)
    o_dst = np.full((P, E_shard), R_shard - 1, np.int32)
    o_w = np.zeros((P, E_shard), w.dtype)
    o_rp = np.zeros((P, R_shard + 1), np.int32)
    o_deg = np.zeros((P, R_shard), indeg.dtype)
    o_ef = (np.zeros((P, E_shard, graph.d_edge), ef.dtype)
            if ef is not None else None)
    starts = np.zeros(P, np.int32)
    counts = np.zeros(P, np.int32)

    # global node id -> padded-global id owner * R_shard + local row
    owner_of = np.searchsorted(np.asarray(bounds[1:-1], np.int64),
                               np.arange(R), side='right')
    padded_id = (owner_of * R_shard
                 + (np.arange(R) - np.asarray(bounds)[owner_of])
                 ).astype(np.int64)

    for p in range(P):
        r0, r1 = bounds[p], bounds[p + 1]
        e0, e1 = int(row_ptr[r0]), int(row_ptr[r1])
        ne, nr = e1 - e0, r1 - r0
        starts[p], counts[p] = r0, nr
        o_src[p, :ne] = padded_id[src[e0:e1]]
        o_dst[p, :ne] = dst[e0:e1] - r0
        o_w[p, :ne] = w[e0:e1]
        if ef is not None:
            o_ef[p, :ne] = ef[e0:e1]
        o_rp[p, :nr + 1] = row_ptr[r0:r1 + 1] - e0
        o_rp[p, nr + 1:] = ne
        o_deg[p, :nr] = indeg[r0:r1]

    o_order = np.argsort(o_src, axis=1, kind='stable').astype(np.int32)
    o_src_sorted = np.take_along_axis(o_src, o_order, axis=1)

    # one power-of-two-wide table a shard (edge features stay CSR-only)
    tbl_idx = tbl_w = None
    if layout == 'table' and ef is None:
        max_deg = max([int(_shard_degrees(o_rp[p]).max(initial=0))
                       for p in range(P)])
        B = 2
        while B < max(max_deg, 2):
            B *= 2
        tbl_idx = np.zeros((P, R_shard, B), np.int32)
        tbl_w = np.zeros((P, R_shard, B), w.dtype)
        for p in range(P):
            ne = int(o_rp[p, R_shard])
            lo = np.minimum(o_rp[p, :-1], ne)
            d_e = o_dst[p, :ne].astype(np.int64)
            pos_e = np.arange(ne) - lo[d_e]
            tbl_idx[p, d_e, pos_e] = o_src[p, :ne]
            tbl_w[p, d_e, pos_e] = o_w[p, :ne]

    # degree-bucketed MultiTables with one class structure for every shard,
    # so the per-class stacks share their shapes (edge features ride along)
    mtbl_idx = mtbl_w = mtbl_rows = mtbl_ef = mtbl_uniform = None
    if layout in ('auto', 'multi'):
        degs = [_shard_degrees(o_rp[p]) for p in range(P)]
        gmax = max([1] + [int(d.max()) for d in degs if d.size])
        classes = degree_classes(gmax)
        cls_counts = np.zeros((P, len(classes)), np.int64)
        for p, d in enumerate(degs):
            for ci, Bc in enumerate(classes):
                lo_deg = 0 if ci == 0 else classes[ci - 1]
                cnt = int(np.sum((d > lo_deg) & (d <= Bc)))
                if ci == 0:
                    cnt += int(np.sum(d == 0))
                cls_counts[p, ci] = cnt
        class_rows = [max(_round_up(int(cls_counts[:, ci].max()), 8), 8)
                      for ci in range(len(classes))]
        mts = [to_multi_table(
            Graph(src=o_src[p], dst=o_dst[p], weight=o_w[p],
                  row_ptr=o_rp[p], in_degrees=o_deg[p],
                  edge_feat=None if o_ef is None else o_ef[p],
                  num_nodes=P * R_shard, num_recipients=R_shard,
                  num_edges=int(o_rp[p, R_shard])),
            classes=classes, class_rows=class_rows) for p in range(P)]

        def stack(field):
            return tuple(np.stack([np.asarray(field(mt, ci)) for mt in mts])
                         for ci in range(len(classes)))
        mtbl_uniform = tuple(all(mt.tables[ci].uniform_w for mt in mts)
                             for ci in range(len(classes)))
        mtbl_idx = stack(lambda mt, ci: mt.tables[ci].idx)
        mtbl_w = stack(lambda mt, ci: mt.tables[ci].weight)
        mtbl_rows = stack(lambda mt, ci: mt.row_ids[ci])
        if o_ef is not None:
            mtbl_ef = stack(lambda mt, ci: mt.tables[ci].edge_feat)

    # the all-to-all exchange: which of q's local rows does p need?
    a2a_send = a2a_src = a2a_tbl = a2a_mtbl = None
    L = 0
    if with_all_to_all:
        need = [[None] * P for _ in range(P)]
        for p in range(P):
            ne = int(o_rp[p, R_shard])
            uniq = np.unique(o_src[p, :ne]) if ne else np.zeros(0, np.int64)
            owners = uniq // R_shard
            for q in range(P):
                rows_q = uniq[owners == q] - q * R_shard
                need[p][q] = rows_q.astype(np.int64)
                L = max(L, len(rows_q))
        L = max(_round_up(max(L, 1), 8), 8)
        a2a_send = np.zeros((P, P, L), np.int32)
        # padded-global sender id -> compact id q * L + position
        remap = []
        for p in range(P):
            m = np.zeros(P * R_shard, np.int32)
            for q in range(P):
                rows_q = need[p][q]
                a2a_send[q, p, :len(rows_q)] = rows_q
                m[q * R_shard + rows_q] = (
                    q * L + np.arange(len(rows_q), dtype=np.int32))
            remap.append(m)
        a2a_src = np.stack([remap[p][o_src[p]] for p in range(P)])
        if tbl_idx is not None:
            a2a_tbl = np.stack([remap[p][tbl_idx[p]] for p in range(P)])
        if mtbl_idx is not None:
            a2a_mtbl = tuple(np.stack([remap[p][stk[p]] for p in range(P)])
                             for stk in mtbl_idx)

    return GraphShards(
        src=o_src, dst=o_dst, weight=o_w, row_ptr=o_rp, in_degrees=o_deg,
        recip_start=starts, recip_count=counts, src_order=o_order,
        src_sorted=o_src_sorted, edge_feat=o_ef, tbl_idx=tbl_idx,
        tbl_w=tbl_w, a2a_send_idx=a2a_send, a2a_src=a2a_src,
        a2a_tbl_idx=a2a_tbl, a2a_rows=int(L), mtbl_idx=mtbl_idx,
        mtbl_w=mtbl_w, mtbl_rows=mtbl_rows, mtbl_ef=mtbl_ef,
        a2a_mtbl_idx=a2a_mtbl, mtbl_uniform=mtbl_uniform,
        tbl_uniform=(tbl_w is not None and _detect_uniform_w(
            tbl_w.reshape(-1, tbl_w.shape[-1]))),
        num_nodes=graph.num_nodes, num_recipients=R, num_shards=P,
        shard_num_recipients=R_shard)


def local_graph(shards: GraphShards, rank: int,
                exchange: str = 'all_gather'):
    """The layout rank `rank` computes on, in numpy (`.to(device)` it):
    a MultiTable when the shards carry the bucketed layout, else a
    NeighborTable when they carry one table a shard, else a CSR Graph.
    Sender ids index the all-gathered (P * R_shard) padded-global matrix,
    or with exchange='all_to_all' the received (P * a2a_rows) buffer.  The
    CSR Graph's last row pointer covers the padding edges (they point at
    the last local row), the port's CSR convention."""
    a2a = exchange == 'all_to_all'
    if a2a:
        if shards.a2a_src is None:
            raise ValueError('shards built without with_all_to_all=True')
        n_senders = shards.num_shards * shards.a2a_rows
    else:
        n_senders = shards.num_shards * shards.shard_num_recipients
    p = rank
    R_shard = shards.shard_num_recipients
    if shards.mtbl_idx is not None:
        idx_stacks = shards.a2a_mtbl_idx if a2a else shards.mtbl_idx
        ef_stacks = (shards.mtbl_ef if shards.mtbl_ef is not None
                     else (None,) * len(idx_stacks))
        unif = (shards.mtbl_uniform if shards.mtbl_uniform is not None
                else (False,) * len(idx_stacks))
        tables = tuple(
            NeighborTable(
                idx=idx_c[p], weight=w_c[p],
                in_degrees=np.sum(w_c[p], axis=1),
                edge_feat=None if ef_c is None else ef_c[p],
                num_nodes=n_senders, num_recipients=idx_c.shape[1],
                num_edges=idx_c.shape[1] * idx_c.shape[2], uniform_w=u_c)
            for idx_c, w_c, ef_c, u_c in zip(idx_stacks, shards.mtbl_w,
                                             ef_stacks, unif))
        return MultiTable(
            tables=tables, row_ids=tuple(r[p] for r in shards.mtbl_rows),
            in_degrees=shards.in_degrees[p], num_nodes=n_senders,
            num_recipients=R_shard, num_edges=shards.shard_num_edges)
    if shards.tbl_idx is not None:
        idx = shards.a2a_tbl_idx[p] if a2a else shards.tbl_idx[p]
        return NeighborTable(
            idx=idx, weight=shards.tbl_w[p],
            in_degrees=shards.in_degrees[p], num_nodes=n_senders,
            num_recipients=R_shard, num_edges=shards.shard_num_edges,
            uniform_w=shards.tbl_uniform)
    row_ptr = shards.row_ptr[p].copy()
    row_ptr[-1] = shards.shard_num_edges
    return Graph(
        src=shards.a2a_src[p] if a2a else shards.src[p],
        dst=shards.dst[p], weight=shards.weight[p], row_ptr=row_ptr,
        in_degrees=shards.in_degrees[p],
        edge_feat=None if shards.edge_feat is None else shards.edge_feat[p],
        src_order=None if a2a else shards.src_order[p],
        src_sorted=None if a2a else shards.src_sorted[p],
        num_nodes=n_senders, num_recipients=R_shard,
        num_edges=shards.shard_num_edges)


def shard_node_features(X, shards: GraphShards) -> np.ndarray:
    """Lay out global node features (N, ...) into the padded per-shard
    stack (P, R_shard, ...) of `shards`' ownership."""
    X = np.asarray(X)
    out = np.zeros((shards.num_shards, shards.shard_num_recipients)
                   + X.shape[1:], X.dtype)
    for p in range(shards.num_shards):
        s, c = shards.recip_start[p], shards.recip_count[p]
        out[p, :c] = X[s:s + c]
    return out


def unshard_recipient_values(stacked, shards: GraphShards) -> np.ndarray:
    """Inverse of the per-shard layout: (P, R_shard, ...) -> (R, ...)."""
    stacked = np.asarray(stacked)
    return np.concatenate([stacked[p, :shards.recip_count[p]]
                           for p in range(shards.num_shards)], axis=0)


def shard_recipient_labels(y, mask, shards: GraphShards):
    """Labels (R,) and a float mask (R,) laid out as (P, R_shard) int32
    and float32 stacks."""
    y = np.asarray(y)
    mask = np.asarray(mask, np.float32)
    shape = (shards.num_shards, shards.shard_num_recipients)
    labels = np.zeros(shape, np.int32)
    m = np.zeros(shape, np.float32)
    for p in range(shards.num_shards):
        s, c = shards.recip_start[p], shards.recip_count[p]
        labels[p, :c] = y[s:s + c]
        m[p, :c] = mask[s:s + c]
    return labels, m
