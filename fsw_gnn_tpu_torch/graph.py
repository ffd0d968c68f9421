"""Host-side graph layouts and their numpy builders.

Counterpart of `fsw_gnn_tpu/graph.py`: the same CSR `Graph`, dense
`NeighborTable` and degree-bucketed `MultiTable`, built once on the host in
numpy.  Each container is a plain dataclass of numpy arrays; `.to(device)`
returns a copy whose arrays are torch tensors on that device (index arrays
as int64, floats in their own dtype).

Conventions:
  * `edge_index` has shape (2, E) with edge_index[0] = source (sender) and
    edge_index[1] = destination (recipient).
  * Padding carries weight 0 and contributes exactly 0 to the FSW
    quadrature.  Padded CSR edges point at segment `num_recipients - 1` and
    sender 0; padded table entries at sender 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _tensor(a, device):
    """numpy array (or tensor) -> tensor on `device`; integer arrays widen
    to int64, the index type torch's gathers and scatters take."""
    if a is None:
        return None
    t = torch.as_tensor(a)
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


def _to(obj, device):
    """Copy of a layout dataclass with every array field on `device`."""
    device = torch.device(device)
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (np.ndarray, torch.Tensor)):
            changes[f.name] = _tensor(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass
class Graph:
    """Padded CSR-segment graph.

    src (E,) sender per edge; dst (E,) recipient per edge, sorted
    non-decreasing; weight (E,) (0 for padding); row_ptr (R+1,) CSR
    pointers; in_degrees (R,) summed unit/self-loop weights before gcn
    normalization; edge_feat (E, d_edge) or None; src_order / src_sorted
    the stable sort of the edges by sender.  num_edges counts the real
    (non-padding) edges.
    """
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    row_ptr: np.ndarray
    in_degrees: np.ndarray
    edge_feat: Optional[np.ndarray] = None
    src_order: Optional[np.ndarray] = None
    src_sorted: Optional[np.ndarray] = None
    num_nodes: int = 0
    num_recipients: int = 0
    num_edges: int = 0

    @property
    def padded_num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def d_edge(self) -> int:
        return 0 if self.edge_feat is None else self.edge_feat.shape[-1]

    def to(self, device) -> 'Graph':
        return _to(self, device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def from_edge_index(edge_index,
                    num_nodes: int,
                    edge_features=None,
                    *,
                    edge_weight=None,
                    self_loop_weight: float = 0.0,
                    edge_weighting: str = 'unit',
                    num_recipients: Optional[int] = None,
                    pad_to: Optional[int] = None,
                    pad_multiple: int = 128,
                    dtype=np.float32) -> Graph:
    """Build a padded CSR `Graph` from a (2, E) edge index on the host.

    Unit edge weights (or `edge_weight`), optional self-loops of weight
    `self_loop_weight`, duplicate edges coalesced by summing their weights
    and edge features, in-degrees, and optional symmetric 'gcn'
    normalization D^{-1/2} A D^{-1/2}.  Float arrays come out in `dtype`,
    index arrays in int32.
    """
    if edge_weighting not in ('unit', 'gcn'):
        raise ValueError(f"edge_weighting must be 'unit' or 'gcn', "
                         f"got {edge_weighting!r}")
    edge_index = np.asarray(edge_index)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f'edge_index must have shape (2, E), '
                         f'got {edge_index.shape}')
    num_recipients = num_nodes if num_recipients is None else num_recipients
    src = edge_index[0].astype(np.int64)
    dst = edge_index[1].astype(np.int64)
    E = src.shape[0]
    w = (np.ones(E, np.float64) if edge_weight is None
         else np.asarray(edge_weight, np.float64))
    d_edge = 0
    ef = None
    if edge_features is not None:
        ef = np.asarray(edge_features, np.float64)
        if ef.ndim == 1:
            ef = ef[:, None]
        if ef.shape[0] != E:
            raise ValueError(f'{ef.shape[0]} edge feature rows for {E} edges')
        d_edge = ef.shape[1]

    if self_loop_weight > 0:
        loop = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
        w = np.concatenate([w, np.full(num_nodes, self_loop_weight)])
        if ef is not None:
            ef = np.concatenate([ef, np.zeros((num_nodes, d_edge))], axis=0)

    # coalesce duplicates by (dst, src): weights and edge features sum
    key = dst * num_nodes + src
    order = np.argsort(key, kind='stable')
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    if ef is not None:
        ef = ef[order]
    uniq, first_idx, inverse = np.unique(key, return_index=True,
                                         return_inverse=True)
    if uniq.shape[0] != key.shape[0]:
        w = np.bincount(inverse, weights=w, minlength=uniq.shape[0])
        if ef is not None:
            ef = np.stack([np.bincount(inverse, weights=ef[:, j],
                                       minlength=uniq.shape[0])
                           for j in range(d_edge)], axis=1)
        src, dst = src[first_idx], dst[first_idx]

    E_real = src.shape[0]
    in_deg = np.bincount(dst, weights=w, minlength=num_recipients)

    if edge_weighting == 'gcn':
        deg_all = np.bincount(dst, weights=w,
                              minlength=max(num_recipients, num_nodes))
        with np.errstate(divide='ignore'):
            inv_sqrt = 1.0 / np.sqrt(deg_all)
        inv_sqrt[~np.isfinite(inv_sqrt)] = 0.0
        w = w * inv_sqrt[dst] * inv_sqrt[src]

    E_pad = pad_to if pad_to is not None else max(
        _round_up(max(E_real, 1), pad_multiple), pad_multiple)
    if E_pad < E_real:
        raise ValueError(f'pad_to={E_pad} < real edge count {E_real}')
    pad = E_pad - E_real
    pad_seg = max(num_recipients - 1, 0)
    src = np.concatenate([src, np.zeros(pad, np.int64)])
    dst = np.concatenate([dst, np.full(pad, pad_seg, np.int64)])
    w = np.concatenate([w, np.zeros(pad)])
    if ef is not None:
        ef = np.concatenate([ef, np.zeros((pad, d_edge))], axis=0)

    row_ptr = np.zeros(num_recipients + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_recipients), out=row_ptr[1:])

    src_order = np.argsort(src, kind='stable')
    npdt = np.dtype(dtype)
    return Graph(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        weight=w.astype(npdt),
        row_ptr=row_ptr.astype(np.int32),
        in_degrees=in_deg.astype(npdt),
        edge_feat=None if ef is None else ef.astype(npdt),
        src_order=src_order.astype(np.int32),
        src_sorted=src[src_order].astype(np.int32),
        num_nodes=int(num_nodes),
        num_recipients=int(num_recipients),
        num_edges=int(E_real),
    )


@dataclasses.dataclass
class NeighborTable:
    """Dense padded neighbor table: row r holds recipient r's in-edges.

    idx (R, B) sender ids (0 for padding); weight (R, B) (0 for padding);
    in_degrees (R,); edge_feat (R, B, d_edge) or None.

    uniform_w is True iff every real (nonzero-weight) entry of a row
    carries the same positive weight (unit adjacency, weight-1 self-loops).
    The rank kernel then computes sin(pi f w) once per row.  It is detected
    at build time: replace `weight` afterwards and it goes stale, so
    re-detect with `_detect_uniform_w` or set it False.  Differentiated
    weights are gated off it in `embedding.fsw_embed_table`.

    pad_entries (the entries that hold no edge) and hot_row_entries (the
    most entries any one sender takes, padding included) are counted once
    by `to_neighbor_table` and `to_multi_table`, for the gather's counters
    (`embedding._gather`); None where a table was made otherwise.
    """
    idx: np.ndarray
    weight: np.ndarray
    in_degrees: np.ndarray
    edge_feat: Optional[np.ndarray] = None
    num_nodes: int = 0
    num_recipients: int = 0
    num_edges: int = 0
    uniform_w: bool = False
    pad_entries: Optional[int] = None
    hot_row_entries: Optional[int] = None

    @property
    def bucket_size(self) -> int:
        return self.idx.shape[1]

    @property
    def d_edge(self) -> int:
        return 0 if self.edge_feat is None else self.edge_feat.shape[-1]

    def to(self, device) -> 'NeighborTable':
        return _to(self, device)


def _detect_uniform_w(wt: np.ndarray) -> bool:
    """True iff every nonzero entry of each row equals that row's max
    weight and no weight is negative.  False only forfeits the fast path;
    the kernel recovers the row constant as max_j wn[:, j], which is why
    positivity is part of the predicate."""
    if wt.size == 0:
        return True
    row_max = wt.max(axis=1, keepdims=True)
    return bool(np.all((wt == 0) | (wt == row_max)) and row_max.min() >= 0)


def _gather_counts(idx: np.ndarray, real: int) -> dict:
    """A table's pad_entries and hot_row_entries from its idx and the
    number of entries that hold an edge."""
    hot = int(np.bincount(idx.ravel()).max()) if idx.size else 0
    return dict(pad_entries=int(idx.size - real), hot_row_entries=hot)


def _degrees(graph: Graph):
    """Per-recipient (first edge, real degree), excluding the zero-weight
    padding edges at the tail of the last segment."""
    row_ptr = np.asarray(graph.row_ptr, np.int64)
    E_real = graph.num_edges
    lo = np.minimum(row_ptr[:-1], E_real)
    hi = np.minimum(row_ptr[1:], E_real)
    return lo, hi - lo


def to_neighbor_table(graph: Graph, bucket_size: Optional[int] = None,
                      pad_multiple: int = 8) -> NeighborTable:
    """Convert a CSR `Graph` to a dense `NeighborTable` (host-side).

    bucket_size defaults to the max in-degree rounded up to
    `pad_multiple`; it must cover the max degree (no edge is dropped)."""
    src = np.asarray(graph.src)
    w = np.asarray(graph.weight)
    ef = None if graph.edge_feat is None else np.asarray(graph.edge_feat)
    R = graph.num_recipients
    E_real = graph.num_edges
    lo, deg = _degrees(graph)
    max_deg = int(deg.max()) if R > 0 else 0
    B = bucket_size or max(_round_up(max(max_deg, 1), pad_multiple),
                           pad_multiple)
    if B < max_deg:
        raise ValueError(f'bucket_size {B} < max degree {max_deg}')

    idx = np.zeros((R, B), np.int32)
    wt = np.zeros((R, B), w.dtype)
    eft = (np.zeros((R, B, ef.shape[-1]), ef.dtype)
           if ef is not None else None)
    dst_e = np.asarray(graph.dst)[:E_real].astype(np.int64)
    pos_e = np.arange(E_real) - lo[dst_e]
    idx[dst_e, pos_e] = src[:E_real]
    wt[dst_e, pos_e] = w[:E_real]
    if eft is not None:
        eft[dst_e, pos_e] = ef[:E_real]
    return NeighborTable(
        idx=idx, weight=wt, in_degrees=np.asarray(graph.in_degrees),
        edge_feat=eft, num_nodes=graph.num_nodes, num_recipients=R,
        num_edges=E_real, uniform_w=_detect_uniform_w(wt),
        **_gather_counts(idx, E_real))


@dataclasses.dataclass
class MultiTable:
    """Degree-bucketed collection of NeighborTables.

    A recipient of degree d lands in the smallest class with B >= d.
    `row_ids[c]` maps class-c table rows back to recipient ids; padding
    rows point at the sentinel `num_recipients`, dropped at the scatter.
    """
    tables: tuple
    row_ids: tuple
    in_degrees: np.ndarray
    num_nodes: int = 0
    num_recipients: int = 0
    num_edges: int = 0

    @property
    def d_edge(self) -> int:
        return self.tables[0].d_edge if self.tables else 0

    def to(self, device) -> 'MultiTable':
        return dataclasses.replace(
            self, tables=tuple(t.to(device) for t in self.tables),
            row_ids=tuple(_tensor(r, device) for r in self.row_ids),
            in_degrees=_tensor(self.in_degrees, device))


def degree_classes(max_deg: int, min_bucket: int = 8) -> list:
    """Degree-class widths 8, 16, 24, 32, 48, 64, 96, ... (powers of two
    plus the 1.5x midpoints) covering max_deg."""
    B = max(min_bucket, 8)
    classes = []
    while True:
        classes.append(B)
        if B >= max_deg:
            break
        mid = B + B // 2
        if mid % 8 == 0 and mid >= min_bucket:
            classes.append(mid)
            if mid >= max_deg:
                break
        B *= 2
    return classes


def class_of(deg: np.ndarray, classes) -> np.ndarray:
    """Index of the degree class of every row (degree 0 goes to class 0)."""
    cls = np.zeros(deg.shape[0], np.int64)
    for ci, Bc in enumerate(classes):
        lo_deg = 0 if ci == 0 else classes[ci - 1]
        cls[(deg > lo_deg) & (deg <= Bc)] = ci
    cls[deg == 0] = 0
    return cls


def to_multi_table(graph: Graph, min_bucket: int = 8,
                   row_pad_multiple: int = 8,
                   classes=None, class_rows=None) -> MultiTable:
    """Convert a CSR `Graph` into a degree-bucketed `MultiTable`
    (host-side).

    `classes` / `class_rows` force the class widths and the per-class
    padded row counts (the serving envelope pins them so every request's
    tables have the same shapes)."""
    src = np.asarray(graph.src)
    w = np.asarray(graph.weight)
    ef = None if graph.edge_feat is None else np.asarray(graph.edge_feat)
    R = graph.num_recipients
    E_real = graph.num_edges
    lo, deg = _degrees(graph)

    if classes is None:
        classes = degree_classes(max(int(deg.max()) if R else 1, 1),
                                 min_bucket)
    else:
        classes = list(classes)
        if (int(deg.max()) if R else 0) > classes[-1]:
            raise ValueError(f'max degree {int(deg.max())} > widest '
                             f'class {classes[-1]}')
    cls_of = class_of(deg, classes)

    dst_e = np.asarray(graph.dst)[:E_real].astype(np.int64)
    pos_e = np.arange(E_real) - lo[dst_e]
    tables, row_ids = [], []
    for ci, Bc in enumerate(classes):
        rows = np.nonzero(cls_of == ci)[0]
        if class_rows is not None:
            Rc = int(class_rows[ci])
            if Rc < len(rows):
                raise ValueError(f'class {Bc} holds {len(rows)} rows > '
                                 f'class_rows {Rc}')
        else:
            Rc = max(_round_up(max(len(rows), 1), row_pad_multiple),
                     row_pad_multiple)
        idx = np.zeros((Rc, Bc), np.int32)
        wt = np.zeros((Rc, Bc), w.dtype)
        eft = (np.zeros((Rc, Bc, ef.shape[-1]), ef.dtype)
               if ef is not None else None)
        ids = np.full(Rc, R, np.int64)  # sentinel for padding rows
        ids[:len(rows)] = rows
        rank = np.full(R, -1, np.int64)
        rank[rows] = np.arange(len(rows))
        sel = cls_of[dst_e] == ci
        lr = rank[dst_e[sel]]
        idx[lr, pos_e[sel]] = src[:E_real][sel]
        wt[lr, pos_e[sel]] = w[:E_real][sel]
        if eft is not None:
            eft[lr, pos_e[sel]] = ef[:E_real][sel]
        real = int(deg[rows].sum())
        tables.append(NeighborTable(
            idx=idx, weight=wt, in_degrees=np.zeros(Rc, w.dtype),
            edge_feat=eft, num_nodes=graph.num_nodes, num_recipients=Rc,
            num_edges=real, uniform_w=_detect_uniform_w(wt),
            **_gather_counts(idx, real)))
        row_ids.append(ids.astype(np.int32))

    return MultiTable(tables=tuple(tables), row_ids=tuple(row_ids),
                      in_degrees=np.asarray(graph.in_degrees),
                      num_nodes=graph.num_nodes, num_recipients=R,
                      num_edges=E_real)


def auto_layout(graph: Graph, max_bucket: int = 4096):
    """The layout the single-device path computes on, chosen as the JAX
    package's `auto_layout` chooses it: the degree-bucketed MultiTable, or
    one NeighborTable when the graph has a single degree class, and the
    CSR `Graph` itself when its max degree exceeds `max_bucket`."""
    _, deg = _degrees(graph)
    max_deg = int(deg.max()) if graph.num_recipients > 0 else 0
    if max_deg > max_bucket:
        return graph
    mt = to_multi_table(graph)
    if len(mt.tables) == 1:
        return to_neighbor_table(graph)
    return mt


def stack_graphs(graphs) -> Graph:
    """Stack equally shaped CSR `Graph`s into one Graph whose arrays carry
    a leading G axis, for `embedding.fsw_embed_graph_batched`.  Every graph
    must share the padded edge count (`pad_to=` in `from_edge_index`), the
    node and recipient counts and the presence of edge features."""
    g0 = graphs[0]
    for g in graphs[1:]:
        if (g.src.shape != g0.src.shape or g.num_nodes != g0.num_nodes
                or g.num_recipients != g0.num_recipients
                or (g.edge_feat is None) != (g0.edge_feat is None)):
            raise ValueError('stacked graphs need equal padded shapes, node '
                             'and recipient counts and edge features')

    def stack(name):
        return np.stack([np.asarray(getattr(g, name)) for g in graphs])
    return Graph(
        src=stack('src'), dst=stack('dst'), weight=stack('weight'),
        row_ptr=stack('row_ptr'), in_degrees=stack('in_degrees'),
        edge_feat=None if g0.edge_feat is None else stack('edge_feat'),
        src_order=stack('src_order'), src_sorted=stack('src_sorted'),
        num_nodes=g0.num_nodes, num_recipients=g0.num_recipients,
        num_edges=max(g.num_edges for g in graphs))


def readout_graph(graph_index, num_vertices: int,
                  batch_size: Optional[int] = None, *,
                  pad_multiple: int = 128, dtype=np.float32) -> Graph:
    """Bipartite graph for global pooling: an edge of weight 1 from every
    vertex to the node of its graph.  `graph_index` (num_vertices,) must be
    non-decreasing; batch_size defaults to its max + 1."""
    gi = np.asarray(graph_index, np.int64)
    if gi.shape != (num_vertices,):
        raise ValueError(f'graph_index has shape {gi.shape}, expected '
                         f'({num_vertices},)')
    if np.any(np.diff(gi) < 0):
        raise ValueError('graph_index must be monotone non-decreasing')
    batch_size = int(gi.max()) + 1 if batch_size is None else int(batch_size)
    edge_index = np.stack([np.arange(num_vertices, dtype=np.int64), gi])
    return from_edge_index(edge_index, num_nodes=num_vertices,
                           num_recipients=batch_size,
                           pad_multiple=pad_multiple, dtype=dtype)
