"""Online inference over arbitrary request graphs, and export.

Counterpart of `fsw_gnn_tpu/serving.py`:
  * `export_forward` / `load_forward`: a model's forward, closed over one
    graph, as a `torch.export` artifact (bytes) that a serving process runs
    without the model's Python code; `save_artifact` / `load_artifact`
    write and read it; `export_from_checkpoint` exports a `Trainer`
    checkpoint (its step_<n>.pt file).  An artifact needs
    `fsw_gnn_tpu_torch` imported, so that the kernels' custom ops are
    registered (as the JAX artifact needs `jax`), and runs on the device it
    was exported for (`device`, JAX's `platform`).
  * `multi_envelope` and `GraphServer`, with its two routes.  A pinned
    degree-class envelope (`classes` plus per-class row capacities
    `class_rows`) gives every request's MultiTable the same shapes; a
    request outside it, every request of a server built without one, and
    a request that fails the `assume_uniform_w` check go through the
    padded CSR `Graph` instead.  Requests are padded with isolated nodes
    (zero features, no in-edges) and zero-weight entries or edges, exact
    no-ops for the real outputs.

Each route is one CUDA graph (`utils.cache.CountingGraph`): captured at
its first request (`warmup` serves one of each before traffic), replayed
from then on with one launch from the host, counted in `num_compiles()`
as the JAX server counts its compiles.

Transfer layout, as in the JAX server.  'single' ships a request as one
int32 carrier [graph ints | graph float bits | X bits] in one pinned host
buffer, one non-blocking host-to-device copy; for the MultiTable [idx of
every class, row_ids | weights, in_degrees, edge_feat | X], for the CSR
graph [src, dst, row_ptr, src_order, src_sorted | weight, in_degrees,
edge_feat | X].  The device takes it apart with slices and
`Tensor.view(dtype)` bit views, so no value is converted on the wire.
2-byte payloads ride pair-packed, two to a word (the odd one padded with
a zero): the floats of a 2-byte `dtype` (bfloat16, float16), and the
indices as uint16 when every index value fits (`pack_indices`), decoded on
the device with shifts.  'triple' ships X, the int buffer and the float
buffer as three non-blocking copies, the only layout of an 8-byte dtype.
The model keeps its own (float32) parameters: a bfloat16 server feeds it
bfloat16 features, weights and in-degrees, as the JAX server does.
"""
from __future__ import annotations

import copy
import io
import os
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .graph import (Graph, MultiTable, NeighborTable, class_of,
                    degree_classes, from_edge_index, to_multi_table)
from .utils.cache import CountingGraph

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_LAYOUTS = ('auto', 'single', 'triple')


class _Closed(torch.nn.Module):
    """model(X, graph) with the graph fixed: the module `export_forward`
    exports (its tensors become the artifact's constants)."""

    def __init__(self, model, graph):
        super().__init__()
        self.model = model
        self.graph = graph

    def forward(self, X):
        return self.model(X, self.graph)


def export_forward(model, X_spec, graph, *, device=None) -> bytes:
    """Serialize `model`'s forward, in eval mode and closed over its
    parameters and the `graph` (a CSR Graph, NeighborTable or MultiTable),
    as a `torch.export` artifact.

    X_spec: a tensor of the node-feature input's shape and dtype (its
    values are not read; a 'meta' tensor will do).  device: where the
    artifact runs (None: the card; 'cpu').  A copy of the model and the
    graph are moved there (the caller's model stays as it is); the export
    traces them with fake tensors, so no kernel runs."""
    dev = resolve_device(device)
    mod = _Closed(copy.deepcopy(model).to(dev).eval(), graph.to(dev))
    X = torch.zeros(tuple(X_spec.shape), dtype=X_spec.dtype, device=dev)
    ep = torch.export.export(mod, (X,))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_forward(blob: bytes):
    """Deserialize an exported forward; returns a callable(X) -> output."""
    return torch.export.load(io.BytesIO(blob)).module()


def save_artifact(path: str, blob: bytes):
    with open(path, 'wb') as f:
        f.write(blob)


def load_artifact(path: str):
    with open(path, 'rb') as f:
        return load_forward(f.read())


def export_from_checkpoint(checkpoint_dir: str, model, X_spec, graph, *,
                           step: Optional[int] = None, device=None) -> bytes:
    """Restore the latest (or `step`) checkpoint that the port's `Trainer`
    wrote into `checkpoint_dir` (step_<n>.pt: model, optimizer, step) into
    `model` and export its forward (`export_forward`).  `model` must have
    the checkpoint's architecture; only its state is restored."""
    from .train.trainer import _CKPT
    names = {int(m.group(1)): m.group(0) for m in map(
        _CKPT.match, os.listdir(checkpoint_dir)) if m}
    if not names:
        raise FileNotFoundError(f'no checkpoint in {checkpoint_dir}')
    step = max(names) if step is None else int(step)
    if step not in names:
        raise FileNotFoundError(f'no checkpoint of step {step} in '
                                f'{checkpoint_dir}')
    state = torch.load(os.path.join(checkpoint_dir, names[step]),
                       map_location='cpu', weights_only=True)
    model.load_state_dict(state['model'])
    return export_forward(model, X_spec, graph, device=device)


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
    through the CSR Graph and counts in `uniform_w_fallbacks`.

    dtype: the requests' floats (features, edge weights, in-degrees, edge
    features) on the wire and into the model: float32, bfloat16, float16
    or float64.  transfer_layout: 'single' (one carrier; a 4-byte dtype,
    or a 2-byte one with max_nodes >= 2, which keeps d_in recoverable from
    the carrier's length), 'triple' (three copies) or 'auto' (single where
    the dtype allows it).  pack_indices: uint16 indices in the single
    carrier (None: wherever max(max_nodes, max_edges) <= 65535, so that
    every node id, edge position, row pointer and the row-id sentinel
    max_nodes fits; True raises on a larger envelope; never with 'triple').
    cuda_graphs=False serves every request eagerly on the card, to compare
    the two; `num_compiles()` counts the same keys either way."""

    def __init__(self, model, max_nodes: int, max_edges: int, *,
                 d_edge: int = 0, dtype=torch.float32,
                 classes=None, class_rows=None,
                 assume_uniform_w: bool = False,
                 transfer_layout: str = 'auto',
                 pack_indices: Optional[bool] = None,
                 cuda_graphs: bool = True, device=None):
        if dtype not in _DTYPES:
            raise ValueError(f'dtype must be one of {_DTYPES}, got {dtype}')
        if transfer_layout not in _LAYOUTS:
            raise ValueError(f'transfer_layout must be one of {_LAYOUTS}, '
                             f'got {transfer_layout!r}')
        if (classes is None) != (class_rows is None):
            raise ValueError('pass classes and class_rows together (see '
                             'multi_envelope)')
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)
        self.d_edge = int(d_edge)
        self.dtype = dtype
        self._itemsize = dtype.itemsize
        can_single = (self._itemsize == 4
                      or (self._itemsize == 2 and self.max_nodes >= 2))
        if transfer_layout == 'single' and not can_single:
            raise ValueError(f'the single carrier needs a 4-byte dtype or a '
                             f'2-byte one with max_nodes >= 2 (got {dtype}, '
                             f'max_nodes {self.max_nodes})')
        self._single = (can_single if transfer_layout == 'auto'
                        else transfer_layout == 'single')
        idx_fits = max(self.max_nodes, self.max_edges) <= 65535
        if pack_indices and not idx_fits:
            raise ValueError('pack_indices=True needs max(max_nodes, '
                             'max_edges) <= 65535')
        self._idx16 = self._single and (
            idx_fits if pack_indices is None else bool(pack_indices))
        # floats are built on the host in float64 for a float64 server,
        # else in float32 (rounded to a 2-byte dtype at packing)
        self._host_float = np.float64 if dtype == torch.float64 else (
            np.float32)
        self._pin = self.device.type == 'cuda'
        self.assume_uniform_w = bool(assume_uniform_w)
        self.fallbacks = 0            # requests outside the envelope
        self.uniform_w_fallbacks = 0  # assume_uniform_w requests that
        #                               failed the host check
        E, R, de = self.max_edges, self.max_nodes, self.d_edge
        self._li_csr = 4 * E + R + 1   # src, dst, row_ptr, order, sorted
        self._lf_csr = E + R + E * de         # weight, in_degrees, edge_feat
        routes = {'csr': self._route(self._unpack_csr, self._li_csr,
                                     self._lf_csr)}
        self.classes = self.class_rows = None
        if classes is not None:
            if len(classes) != len(class_rows):
                raise ValueError('classes and class_rows differ in length')
            self.classes = [int(c) for c in classes]
            self.class_rows = [int(r) for r in class_rows]
            sizes = [rc * bc for rc, bc in zip(self.class_rows,
                                                self.classes)]
            self._offsets = np.cumsum([0] + sizes)
            tot = int(self._offsets[-1])
            self._li = tot + sum(self.class_rows)          # idx + row_ids
            self._lf = tot + R + tot * de
            routes['multi'] = self._route(self._unpack, self._li, self._lf)
        self._graphs = CountingGraph(routes, self.device,
                                     capture=bool(cuda_graphs))

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

    def _wi(self, li: int) -> int:
        """Carrier words of li indices."""
        return -(-li // 2) if self._idx16 else li

    def _wf(self, lf: int) -> int:
        """Carrier words of lf floats (of the server's dtype)."""
        return lf if self._itemsize == 4 else -(-lf // 2)

    def _host(self, n, dtype):
        return torch.empty(n, dtype=dtype, pin_memory=self._pin)

    def _half_bits(self, floats):
        """The 2-byte dtype's bits (int16) of host floats, rounded to the
        nearest as the JAX package's numpy cast does."""
        f = torch.from_numpy(np.ascontiguousarray(floats, np.float32))
        return f.to(self.dtype).view(torch.int16).numpy()

    def _put_floats(self, words, parts, n):
        """parts (host floats, n in all) into carrier words: bit views of a
        4-byte dtype, pair-packed bits of a 2-byte one."""
        if self._itemsize == 4:
            np.concatenate(parts, out=words.view(np.float32),
                           casting='same_kind')
            return
        half = words.view(np.int16)
        half[:n] = self._half_bits(np.concatenate(parts))
        half[n:] = 0

    def _pack_all(self, ints, floats, Xp):
        """The request's host tensors, pinned when serving on the card:
        (carrier,) for 'single', (X, int buffer, float buffer) for
        'triple'.  ints, floats: lists of arrays, laid end to end."""
        li = sum(a.size for a in ints)
        lf = sum(a.size for a in floats)
        if not self._single:
            X, ib, fb = (self._host(Xp.shape, self.dtype),
                         self._host(li, torch.int32),
                         self._host(lf, self.dtype))
            np.concatenate(ints, out=ib.numpy(), casting='unsafe')
            fl = torch.from_numpy(np.concatenate(floats))
            fb.copy_(fl.to(self.dtype))
            X.copy_(torch.from_numpy(Xp).to(self.dtype))
            return X, ib, fb
        wi, wf, wx = self._wi(li), self._wf(lf), self._wf(Xp.size)
        host = self._host(wi + wf + wx, torch.int32)
        buf = host.numpy()
        if self._idx16:
            half = buf[:wi].view(np.uint16)
            np.concatenate(ints, out=half[:li], casting='unsafe')
            half[li:] = 0
        else:
            np.concatenate(ints, out=buf[:wi], casting='unsafe')
        self._put_floats(buf[wi:wi + wf], floats, lf)
        self._put_floats(buf[wi + wf:], [Xp.ravel()], Xp.size)
        return (host,)

    def _pack(self, mt: MultiTable, Xp: np.ndarray):
        """The MultiTable request's host tensors."""
        ints = [t.idx.ravel() for t in mt.tables] + list(mt.row_ids)
        floats = [t.weight.ravel() for t in mt.tables] + [mt.in_degrees]
        if self.d_edge:
            floats += [t.edge_feat.ravel() for t in mt.tables]
        return self._pack_all(ints, floats, Xp)

    def _pack_csr(self, g: Graph, Xp: np.ndarray):
        """The CSR request's host tensors."""
        ints = [g.src, g.dst, g.row_ptr, g.src_order, g.src_sorted]
        floats = [g.weight, g.in_degrees]
        if self.d_edge:
            floats.append(g.edge_feat.ravel())
        return self._pack_all(ints, floats, Xp)

    # ---- device side ----------------------------------------------------

    def _split(self, buf, li: int, lf: int):
        """The carrier's (int buffer (li,) int32, float buffer (lf,) of the
        dtype) by slices, bit views and, for uint16 indices, shifts."""
        wi, wf = self._wi(li), self._wf(lf)
        iw = buf[:wi]
        if self._idx16:      # element 2k in a word's low half, 2k + 1 high
            iw = torch.stack([iw & 0xFFFF, (iw >> 16) & 0xFFFF],
                             dim=1).reshape(-1)[:li]
        return iw, buf[wi:wi + wf].view(self.dtype)[:lf]

    def _unpack_x(self, buf, li: int, lf: int):
        """The carrier's X (max_nodes, d_in): d_in from the carrier's
        length (with a 2-byte dtype, at most one padding element, so exact
        for max_nodes >= 2)."""
        R = self.max_nodes
        xw = buf[self._wi(li) + self._wf(lf):].view(self.dtype)
        d_in = xw.shape[0] // R
        return xw[:R * d_in].reshape(R, d_in)

    def _route(self, unpack, li, lf):
        """One route's forward from the request's device tensors."""
        def forward(*bufs):
            if self._single:
                buf, = bufs
                X = self._unpack_x(buf, li, lf)
                graph = unpack(*self._split(buf, li, lf))
            else:
                X, ib, fb = bufs
                graph = unpack(ib, fb)
            with torch.inference_mode():
                return self.model(X, graph)
        return forward

    def _unpack(self, ib, fb):
        """MultiTable int and float buffers on the device -> MultiTable by
        slices; nothing is copied but the index widening to int64."""
        R, de = self.max_nodes, self.d_edge
        off = self._offsets
        tot = int(off[-1])
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
        return MultiTable(tables=tuple(tables), row_ids=tuple(row_ids),
                          in_degrees=fb[tot:tot + R], num_nodes=R,
                          num_recipients=R, num_edges=self.max_edges)

    def _unpack_csr(self, ib, fb):
        """CSR int and float buffers on the device -> Graph, as `_unpack`."""
        E, R, de = self.max_edges, self.max_nodes, self.d_edge
        ib = ib.long()
        return Graph(src=ib[:E], dst=ib[E:2 * E], weight=fb[:E],
                     row_ptr=ib[2 * E:2 * E + R + 1], in_degrees=fb[E:E + R],
                     edge_feat=(fb[E + R:E + R + E * de].reshape(E, de) if de
                                else None),
                     src_order=ib[2 * E + R + 1:3 * E + R + 1],
                     src_sorted=ib[3 * E + R + 1:4 * E + R + 1],
                     num_nodes=R, num_recipients=R, num_edges=E)

    def _host_request(self, edge_index, features, edge_features=None):
        """Build, pad, check and route one request on the host: (route,
        its host tensors, N)."""
        features = np.asarray(features)
        N = features.shape[0]
        E = np.asarray(edge_index).shape[1]
        if N > self.max_nodes:
            raise ValueError(f'{N} nodes > server envelope {self.max_nodes}')
        if E > self.max_edges:
            raise ValueError(f'{E} edges > server envelope {self.max_edges}')
        if (edge_features is None) != (self.d_edge == 0):
            raise ValueError('edge_features presence must match d_edge')
        Xp = np.zeros((self.max_nodes, features.shape[1]), self._host_float)
        Xp[:N] = features
        g = from_edge_index(edge_index, self.max_nodes,
                            edge_features=edge_features,
                            pad_to=self.max_edges, dtype=self._host_float)
        if self.classes is not None and self._fits_envelope(g):
            mt = to_multi_table(g, classes=self.classes,
                                class_rows=self.class_rows)
            if not self.assume_uniform_w or all(t.uniform_w
                                                for t in mt.tables):
                return 'multi', self._pack(mt, Xp), N
            self.uniform_w_fallbacks += 1
        elif self.classes is not None:
            self.fallbacks += 1
        return 'csr', self._pack_csr(g, Xp), N

    def _dispatch(self, edge_index, features, edge_features=None):
        """Ship one request and launch its forward (the route's graph)
        without waiting for it; returns (device output, N)."""
        route, host, N = self._host_request(edge_index, features,
                                            edge_features)
        return self._graphs(route, *host), N

    @staticmethod
    def _numpy(out, N):
        out = out[:N].cpu()
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()

    def predict(self, edge_index, features, edge_features=None) -> np.ndarray:
        """edge_index (2, E), features (N, d_in); returns (N, out_dim)."""
        return self._numpy(*self._dispatch(edge_index, features,
                                           edge_features))

    def predict_many(self, requests, window: int = 16) -> list:
        """Pipelined batch: request k + 1 is built and launched before
        request k is read back, so the host work overlaps the device work.
        At most `window` requests are in flight (each output is its own
        copy of the route's output buffer).  `requests`: iterable of
        (edge_index, features[, edge_features]); returns the (N, out_dim)
        arrays in order."""
        window = max(1, int(window))
        results, pending = [], []
        for req in requests:
            pending.append(self._dispatch(*req))
            if len(pending) >= window:
                results.append(self._numpy(*pending.pop(0)))
        results.extend(self._numpy(*p) for p in pending)
        return results

    def warmup(self, d_in: int) -> int:
        """Serve one synthetic request through each route before real
        traffic, so that its kernels are built and its CUDA graph captured
        and the first real request pays none of it: a one-node request, and
        with an envelope a star that overflows it (not counted in
        `fallbacks`).  `d_in` is the real traffic's feature width (the
        graphs are keyed on it).  Returns the number of new captures: 2
        with an envelope, 1 without, 0 once warm."""
        before = self.num_compiles()
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
        return self.num_compiles() - before

    def num_compiles(self) -> int:
        """Graphs captured over both routes (on the CPU, keys first
        served): 1 a route after any number of requests of one feature
        width; monotone."""
        return self._graphs.num_compiles
