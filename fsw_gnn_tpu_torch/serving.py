"""Online inference over arbitrary request graphs.

Counterpart of `multi_envelope` and the 'multi' layout of `GraphServer` in
`fsw_gnn_tpu/serving.py`.  A pinned degree-class envelope (`classes` plus
per-class row capacities `class_rows`, e.g. from `multi_envelope`) gives
every request's MultiTable the same shapes.  Requests are padded with
isolated nodes (zero features, no in-edges) and zero-weight entries, both
exact no-ops for the real outputs.

Transfer layout: a request is built on the host in numpy and shipped as
one int32 carrier [graph ints | graph float bits | X bits] in one pinned
host buffer, with one non-blocking host-to-device copy.  The device side
takes it apart with slices and `Tensor.view(dtype)` bit views, so no value
is converted on the wire.

Not ported yet (ROADMAP.md): the CSR route that the JAX server falls back
to for requests outside the envelope (item 7), export_forward /
load_forward, the 'triple' transfer layout, bf16 floats and uint16 index
packing (item 13).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .graph import (MultiTable, NeighborTable, class_of, degree_classes,
                    from_edge_index, to_multi_table)

_CSR_TODO = ('the CSR serving route (item 7 in ROADMAP.md) is not ported '
             'yet')


def multi_envelope(reference_graph, max_nodes: int, headroom: float = 1.5):
    """A pinned degree-class envelope (classes, class_rows) sized from a
    representative graph.

    classes: bucket widths covering `headroom` x the reference max degree;
    class_rows: per-class row capacities, the reference's class occupancy
    x headroom, except class 0, which must hold every zero/low-degree row
    (padding nodes land there) and is pinned to max_nodes."""
    row_ptr = np.asarray(reference_graph.row_ptr, np.int64)
    E_real = reference_graph.num_edges
    deg = (np.minimum(row_ptr[1:], E_real)
           - np.minimum(row_ptr[:-1], E_real))
    max_deg = int(deg.max()) if deg.size else 1
    classes = degree_classes(max(int(np.ceil(max_deg * headroom)), 1))
    counts = np.bincount(class_of(deg, classes), minlength=len(classes))
    rows = [int(min(max_nodes, max(8, -(-int(c * headroom) // 8) * 8)))
            for c in counts]
    rows[0] = int(max_nodes)
    return list(classes), rows


class GraphServer:
    """Online inference of `model` over request graphs inside a fixed
    (max_nodes, max_edges) envelope and degree-class envelope.

    The server puts `model` in eval mode on `device` (None: the card) and
    runs it under torch.inference_mode().  `assume_uniform_w=True` serves
    every request through the row-constant-weight kernel path and checks
    on the host, per request, that this holds (a duplicate edge coalesces
    to weight 2 and breaks it); such a request is counted in
    `uniform_w_fallbacks`, a request outside the envelope in `fallbacks`,
    and both then raise, since the CSR route that would serve them is not
    ported yet."""

    def __init__(self, model, max_nodes: int, max_edges: int, *,
                 d_edge: int = 0, dtype=torch.float32,
                 classes=None, class_rows=None,
                 assume_uniform_w: bool = False, device=None):
        if dtype != torch.float32:
            raise NotImplementedError('only the float32 carrier is ported '
                                      '(bf16 is item 13 in ROADMAP.md)')
        if classes is None or class_rows is None:
            raise NotImplementedError(
                f'a server needs classes and class_rows (see '
                f'multi_envelope): {_CSR_TODO}')
        if len(classes) != len(class_rows):
            raise ValueError('classes and class_rows differ in length')
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)
        self.d_edge = int(d_edge)
        self.dtype = dtype
        self.assume_uniform_w = bool(assume_uniform_w)
        self.classes = [int(c) for c in classes]
        self.class_rows = [int(r) for r in class_rows]
        self.fallbacks = 0            # requests outside the envelope
        self.uniform_w_fallbacks = 0  # assume_uniform_w requests that
        #                               failed the host check
        sizes = [rc * bc for rc, bc in zip(self.class_rows, self.classes)]
        self._offsets = np.cumsum([0] + sizes)
        tot = int(self._offsets[-1])
        self._li = tot + sum(self.class_rows)          # idx + row_ids
        self._lf = tot + self.max_nodes + tot * self.d_edge

    # ---- host side ------------------------------------------------------

    def _fits_envelope(self, g) -> bool:
        row_ptr = np.asarray(g.row_ptr, np.int64)
        deg = (np.minimum(row_ptr[1:], g.num_edges)
               - np.minimum(row_ptr[:-1], g.num_edges))
        if deg.size and int(deg.max()) > self.classes[-1]:
            return False
        counts = np.bincount(class_of(deg, self.classes),
                             minlength=len(self.classes))
        return bool(np.all(counts <= np.asarray(self.class_rows)))

    def _pack(self, mt: MultiTable, Xp: np.ndarray) -> torch.Tensor:
        """The int32 carrier, written straight into a pinned host buffer
        when serving on the card."""
        li, lf = self._li, self._lf
        n = li + lf + Xp.size
        host = torch.empty(n, dtype=torch.int32,
                           pin_memory=self.device.type == 'cuda')
        buf = host.numpy()
        ints = [t.idx.ravel() for t in mt.tables] + list(mt.row_ids)
        floats = [t.weight.ravel() for t in mt.tables] + [mt.in_degrees]
        if self.d_edge:
            floats += [t.edge_feat.ravel() for t in mt.tables]
        np.concatenate(ints, out=buf[:li], casting='unsafe')
        fview = buf[li:].view(np.float32)
        np.concatenate(floats, out=fview[:lf], casting='same_kind')
        fview[lf:] = Xp.ravel()
        return host

    # ---- device side ----------------------------------------------------

    def _unpack(self, buf: torch.Tensor):
        """Carrier on the device -> (X, MultiTable) by slices and bit
        views; nothing is copied but the int32 -> int64 index widening."""
        R, de, li, lf = self.max_nodes, self.d_edge, self._li, self._lf
        off = self._offsets
        tot = int(off[-1])
        ib = buf[:li]
        fb = buf[li:li + lf].view(torch.float32)
        X = buf[li + lf:].view(torch.float32).reshape(R, -1)
        tables, row_ids = [], []
        ro = tot
        for ci, (rc, bc) in enumerate(zip(self.class_rows, self.classes)):
            a, b = int(off[ci]), int(off[ci + 1])
            ef = None
            if de:
                efo = tot + R + a * de
                ef = fb[efo:efo + rc * bc * de].reshape(rc, bc, de)
            tables.append(NeighborTable(
                idx=ib[a:b].reshape(rc, bc).long(),
                weight=fb[a:b].reshape(rc, bc),
                in_degrees=fb.new_zeros((rc,)),
                edge_feat=ef, num_nodes=R, num_recipients=rc,
                uniform_w=self.assume_uniform_w))
            row_ids.append(ib[ro:ro + rc].long())
            ro += rc
        mt = MultiTable(tables=tuple(tables), row_ids=tuple(row_ids),
                        in_degrees=fb[tot:tot + R], num_nodes=R,
                        num_recipients=R, num_edges=self.max_edges)
        return X, mt

    def _dispatch(self, edge_index, features, edge_features=None):
        """Build, pad, check and ship one request and launch its forward
        without waiting for it; returns (device output, N)."""
        features = np.asarray(features)
        N = features.shape[0]
        E = np.asarray(edge_index).shape[1]
        if N > self.max_nodes:
            raise ValueError(f'{N} nodes > server envelope {self.max_nodes}')
        if E > self.max_edges:
            raise ValueError(f'{E} edges > server envelope {self.max_edges}')
        if (edge_features is None) != (self.d_edge == 0):
            raise ValueError('edge_features presence must match d_edge')
        Xp = np.zeros((self.max_nodes, features.shape[1]), np.float32)
        Xp[:N] = features
        g = from_edge_index(edge_index, self.max_nodes,
                            edge_features=edge_features,
                            pad_to=self.max_edges, dtype=np.float32)
        if not self._fits_envelope(g):
            self.fallbacks += 1
            raise NotImplementedError(
                f'the request does not fit the degree-class envelope: '
                f'{_CSR_TODO}')
        mt = to_multi_table(g, classes=self.classes,
                            class_rows=self.class_rows)
        if self.assume_uniform_w and not all(t.uniform_w
                                             for t in mt.tables):
            self.uniform_w_fallbacks += 1
            raise NotImplementedError(
                f'assume_uniform_w is set but the request has rows with '
                f'unequal weights (e.g. a duplicate edge): {_CSR_TODO}')
        host = self._pack(mt, Xp)
        buf = host.to(self.device, non_blocking=True)
        with torch.inference_mode():
            X, mt_dev = self._unpack(buf)
            out = self.model(X, mt_dev)
        return out, N

    def predict(self, edge_index, features, edge_features=None) -> np.ndarray:
        """edge_index (2, E), features (N, d_in); returns (N, out_dim)."""
        out, N = self._dispatch(edge_index, features, edge_features)
        return out[:N].cpu().numpy()

    def predict_many(self, requests, window: int = 16) -> list:
        """Pipelined batch: request k + 1 is built and launched before
        request k is read back, so the host work overlaps the device work.
        At most `window` requests are in flight.  `requests`: iterable of
        (edge_index, features[, edge_features]); returns the (N, out_dim)
        arrays in order."""
        window = max(1, int(window))
        results, pending = [], []
        for req in requests:
            pending.append(self._dispatch(*req))
            if len(pending) >= window:
                out, N = pending.pop(0)
                results.append(out[:N].cpu().numpy())
        for out, N in pending:
            results.append(out[:N].cpu().numpy())
        return results

    def warmup(self, d_in: int) -> None:
        """Serve one synthetic one-node request before real traffic, so the
        kernels are built and loaded and the first real request pays none
        of it.  `d_in` is the real traffic's feature width."""
        ef = (np.zeros((1, self.d_edge), np.float32) if self.d_edge
              else None)
        self.predict(np.zeros((2, 1), np.int64),
                     np.zeros((1, d_in), np.float32), edge_features=ef)
