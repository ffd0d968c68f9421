"""Online inference over arbitrary request graphs.

Counterpart of `multi_envelope` and `GraphServer` in
`fsw_gnn_tpu/serving.py`, with its two routes.  A pinned degree-class
envelope (`classes` plus per-class row capacities `class_rows`, e.g. from
`multi_envelope`) gives every request's MultiTable the same shapes; a
request outside it, every request of a server built without one, and a
request that fails the `assume_uniform_w` check go through the padded CSR
`Graph` instead.  Requests are padded with isolated nodes (zero features,
no in-edges) and zero-weight entries or edges, exact no-ops for the real
outputs.

Transfer layout: a request is built on the host in numpy and shipped as
one int32 carrier [graph ints | graph float bits | X bits] in one pinned
host buffer, with one non-blocking host-to-device copy: for the MultiTable
[idx of every class, row_ids | weights, in_degrees, edge_feat | X], for the
CSR graph [src, dst, row_ptr, src_order, src_sorted | weight, in_degrees,
edge_feat | X].  The device side takes it apart with slices and
`Tensor.view(dtype)` bit views, so no value is converted on the wire.

Not ported yet ("The kernels as torch custom ops, CUDA graphs, and the
rest of serving" in ROADMAP.md): export_forward / load_forward, the
'triple' transfer layout, bf16 floats and uint16 index packing.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .graph import (Graph, MultiTable, NeighborTable, class_of,
                    degree_classes, from_edge_index, to_multi_table)


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
    (max_nodes, max_edges) envelope.

    The server puts `model` in eval mode on `device` (None: the card) and
    runs it under torch.inference_mode().  With `classes` and `class_rows`
    a request inside that degree-class envelope is served as a MultiTable
    and one outside it as a CSR Graph, counted in `fallbacks`; without
    them every request is served as a CSR Graph.  `assume_uniform_w=True`
    serves MultiTables through the row-constant-weight kernel path and
    checks on the host, per request, that this holds (a duplicate edge
    coalesces to weight 2 and breaks it); a request that fails goes
    through the CSR Graph and counts in `uniform_w_fallbacks`."""

    def __init__(self, model, max_nodes: int, max_edges: int, *,
                 d_edge: int = 0, dtype=torch.float32,
                 classes=None, class_rows=None,
                 assume_uniform_w: bool = False, device=None):
        if dtype != torch.float32:
            raise NotImplementedError(
                'only the float32 carrier is ported (bf16 belongs to "The '
                'kernels as torch custom ops, CUDA graphs, and the rest of '
                'serving" in ROADMAP.md)')
        if (classes is None) != (class_rows is None):
            raise ValueError('pass classes and class_rows together (see '
                             'multi_envelope)')
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)
        self.d_edge = int(d_edge)
        self.dtype = dtype
        self.assume_uniform_w = bool(assume_uniform_w)
        self.fallbacks = 0            # requests outside the envelope
        self.uniform_w_fallbacks = 0  # assume_uniform_w requests that
        #                               failed the host check
        E, R, de = self.max_edges, self.max_nodes, self.d_edge
        self._li_csr = 4 * E + R + 1   # src, dst, row_ptr, order, sorted
        self._lf_csr = E + R + E * de         # weight, in_degrees, edge_feat
        self.classes = self.class_rows = None
        if classes is None:
            return
        if len(classes) != len(class_rows):
            raise ValueError('classes and class_rows differ in length')
        self.classes = [int(c) for c in classes]
        self.class_rows = [int(r) for r in class_rows]
        sizes = [rc * bc for rc, bc in zip(self.class_rows, self.classes)]
        self._offsets = np.cumsum([0] + sizes)
        tot = int(self._offsets[-1])
        self._li = tot + sum(self.class_rows)          # idx + row_ids
        self._lf = tot + R + tot * de

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

    def _carrier(self, ints, floats, Xp, li, lf) -> torch.Tensor:
        """The int32 carrier [ints | float bits | X bits], written straight
        into a pinned host buffer when serving on the card."""
        host = torch.empty(li + lf + Xp.size, dtype=torch.int32,
                           pin_memory=self.device.type == 'cuda')
        buf = host.numpy()
        np.concatenate(ints, out=buf[:li], casting='unsafe')
        fview = buf[li:].view(np.float32)
        np.concatenate(floats, out=fview[:lf], casting='same_kind')
        fview[lf:] = Xp.ravel()
        return host

    def _pack(self, mt: MultiTable, Xp: np.ndarray) -> torch.Tensor:
        """The MultiTable request's carrier."""
        ints = [t.idx.ravel() for t in mt.tables] + list(mt.row_ids)
        floats = [t.weight.ravel() for t in mt.tables] + [mt.in_degrees]
        if self.d_edge:
            floats += [t.edge_feat.ravel() for t in mt.tables]
        return self._carrier(ints, floats, Xp, self._li, self._lf)

    def _pack_csr(self, g: Graph, Xp: np.ndarray) -> torch.Tensor:
        """The CSR request's carrier."""
        ints = [g.src, g.dst, g.row_ptr, g.src_order, g.src_sorted]
        floats = [g.weight, g.in_degrees]
        if self.d_edge:
            floats.append(g.edge_feat.ravel())
        return self._carrier(ints, floats, Xp, self._li_csr, self._lf_csr)

    # ---- device side ----------------------------------------------------

    def _unpack(self, buf: torch.Tensor):
        """MultiTable carrier on the device -> (X, MultiTable) by slices
        and bit views; nothing is copied but the int32 -> int64 index
        widening."""
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

    def _unpack_csr(self, buf: torch.Tensor):
        """CSR carrier on the device -> (X, Graph), as `_unpack`."""
        E, R, de = self.max_edges, self.max_nodes, self.d_edge
        li, lf = self._li_csr, self._lf_csr
        ib = buf[:li].long()
        fb = buf[li:li + lf].view(torch.float32)
        X = buf[li + lf:].view(torch.float32).reshape(R, -1)
        g = Graph(src=ib[:E], dst=ib[E:2 * E], weight=fb[:E],
                  row_ptr=ib[2 * E:2 * E + R + 1], in_degrees=fb[E:E + R],
                  edge_feat=(fb[E + R:E + R + E * de].reshape(E, de) if de
                             else None),
                  src_order=ib[2 * E + R + 1:3 * E + R + 1],
                  src_sorted=ib[3 * E + R + 1:4 * E + R + 1],
                  num_nodes=R, num_recipients=R, num_edges=E)
        return X, g

    def _dispatch(self, edge_index, features, edge_features=None):
        """Build, pad, check, route and ship one request and launch its
        forward without waiting for it; returns (device output, N)."""
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
        host = None
        if self.classes is not None and self._fits_envelope(g):
            mt = to_multi_table(g, classes=self.classes,
                                class_rows=self.class_rows)
            if not self.assume_uniform_w or all(t.uniform_w
                                                for t in mt.tables):
                host, unpack = self._pack(mt, Xp), self._unpack
            else:
                self.uniform_w_fallbacks += 1
        elif self.classes is not None:
            self.fallbacks += 1
        if host is None:
            host, unpack = self._pack_csr(g, Xp), self._unpack_csr
        buf = host.to(self.device, non_blocking=True)
        with torch.inference_mode():
            out = self.model(*unpack(buf))
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
        """Serve one synthetic request through each route before real
        traffic, so the kernels are built and loaded and the first real
        request pays none of it: a one-node request, and with an envelope a
        star that overflows it (not counted in `fallbacks`).  `d_in` is the
        real traffic's feature width."""
        ef = (np.zeros((1, self.d_edge), np.float32) if self.d_edge
              else None)
        self.predict(np.zeros((2, 1), np.int64),
                     np.zeros((1, d_in), np.float32), edge_features=ef)
        if self.classes is not None:
            d = min(self.max_nodes - 1, self.max_edges)
            star = np.stack([np.arange(1, d + 1), np.zeros(d, np.int64)])
            efs = (np.zeros((d, self.d_edge), np.float32) if self.d_edge
                   else None)
            fb = self.fallbacks
            self.predict(star, np.zeros((d + 1, d_in), np.float32),
                         edge_features=efs)
            self.fallbacks = fb
