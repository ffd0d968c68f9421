"""GraphServer throughput: the degree-class envelope against the CSR route.

Counterpart of benchmarks/bench_serving.py.  `FSWGNN(hidden_dims=(64,
16))` (random weights, seed 0) behind two servers of one (max_nodes,
max_edges) envelope: one with the `multi` degree-class envelope sized from
a representative request (`multi_envelope`), one without it, which serves
every request through the CSR `Graph`.  Each route is one CUDA graph
(`utils.cache.CountingGraph`), captured at the first request; every request
is a fresh random graph padded into the envelope, so a request's time is
the whole online cost: the host's build and pack, the copy in, the graph's
replay and the copy out.  Latencies are the host clock around `predict`,
which returns host arrays (so the card has finished).

Per server: the first request's seconds (its capture), then SRV_REQUESTS
requests one at a time (req/s, p50, p90, max; `num_compiles()` must stay 1),
then the same requests through `predict_many` (one in flight while the next
is built).  Last, both routes on the last request: their largest difference
relative to the CSR route's scale, held to the port's float32 tolerance
TOL_REL (the JAX script allows 5e-3 for the TPU's bf16 passes; on the card
TF32 is off, `device.resolve_device`), printed with both routes' scales; the
script raises after the line when it is above.

On the card the envelope's route runs K1f (or K2f where a class is routed
there), the CSR route K3.  The CSR route carries the graph's padding edges
on its last recipient, whose sorted segment-sum one thread computes, so a
half-full request costs it more than a full one (ROADMAP §2, G2).

    python -m fsw_gnn_tpu_torch.benchmarks.bench_serving [--device cpu]

Knobs (the JAX script's, with its defaults): SRV_REQUESTS 32,
SRV_MAX_NODES 2048, SRV_MAX_EDGES 32768, SRV_DIN 64, SRV_DOUT 16.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..graph import from_edge_index
from ..models import FSWGNN
from ..serving import GraphServer, multi_envelope
from . import _timing

N_REQ = int(os.environ.get('SRV_REQUESTS', 32))
MAX_NODES = int(os.environ.get('SRV_MAX_NODES', 2048))
MAX_EDGES = int(os.environ.get('SRV_MAX_EDGES', 32768))
D_IN = int(os.environ.get('SRV_DIN', 64))
D_OUT = int(os.environ.get('SRV_DOUT', 16))
TOL_REL = 1e-4


def request(rng, n, d_in=D_IN, avg_deg=8):
    """A random request of n nodes: (edge_index without self loops,
    features (n, d_in) float32), drawn as the JAX scripts draw it."""
    E = n * avg_deg
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    keep = src != dst
    ei = np.stack([src[keep], dst[keep]])
    X = rng.standard_normal((n, d_in)).astype(np.float32)
    return ei, X


def model_and_envelope(rng, dev, max_nodes=MAX_NODES, d_in=D_IN,
                       d_out=D_OUT):
    """The served model (FSWGNN(hidden_dims=(64, d_out)), seed 0) and the
    envelope (classes, class_rows) of a representative request of
    max_nodes // 2 nodes, the first draw from `rng`."""
    ei0, _ = request(rng, max_nodes // 2, d_in)
    g0 = from_edge_index(ei0, max_nodes // 2)
    model = FSWGNN(in_channels=d_in, hidden_dims=(64, d_out),
                   minimize_slice_coherence=False, device=dev,
                   generator=torch.Generator().manual_seed(0))
    classes, class_rows = multi_envelope(g0, max_nodes=max_nodes)
    return model, classes, class_rows


def setup(dev, n_req=N_REQ, max_nodes=MAX_NODES):
    """The JAX script's draws from default_rng(0): the representative
    request, then the stream of n_req requests of max_nodes // 4 ..
    max_nodes // 2 nodes; and the model and envelope."""
    rng = np.random.default_rng(0)
    model, classes, class_rows = model_and_envelope(rng, dev, max_nodes)
    reqs = [request(rng, int(n))
            for n in rng.integers(max_nodes // 4, max_nodes // 2 + 1, n_req)]
    return model, classes, class_rows, reqs


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_serving')
    model, classes, class_rows, reqs = setup(dev)
    servers = [
        ('multi-envelope', GraphServer(model, MAX_NODES, MAX_EDGES,
                                       classes=classes,
                                       class_rows=class_rows, device=dev)),
        ('csr', GraphServer(model, MAX_NODES, MAX_EDGES, device=dev))]
    rows = {}
    for name, srv in servers:
        t0 = time.perf_counter()
        srv.predict(*reqs[0])
        _timing.emit(dev, server=name,
                     first_request_s=time.perf_counter() - t0)
        lat = []
        t_all = time.perf_counter()
        for ei, X in reqs:
            t0 = time.perf_counter()
            srv.predict(ei, X)
            lat.append(1e3 * (time.perf_counter() - t0))
        wall = time.perf_counter() - t_all
        row = {'server': name, 'requests': len(reqs),
               'req_per_s': len(reqs) / wall,
               **{k: v for k, v in _timing.spread(lat).items()
                  if k != 'min_ms'},
               'compiles': srv.num_compiles(), 'fallbacks': srv.fallbacks}
        _timing.emit(dev, **row)
        if srv.num_compiles() != 1:
            raise RuntimeError(f'{name}: {srv.num_compiles()} captures, '
                               f'not 1: a request was captured anew')
        t0 = time.perf_counter()
        srv.predict_many(reqs)
        wall_p = time.perf_counter() - t0
        _timing.emit(dev, server=name, mode='pipelined (predict_many)',
                     req_per_s=len(reqs) / wall_p,
                     compiles=srv.num_compiles())
        if srv.num_compiles() != 1:
            raise RuntimeError(f'{name}: predict_many captured anew')
        rows[name] = dict(row, pipelined_req_per_s=len(reqs) / wall_p)
    a = servers[0][1].predict(*reqs[-1])
    b = servers[1][1].predict(*reqs[-1])
    err = float(np.max(np.abs(a - b)) / (1e-6 + np.max(np.abs(b))))
    ok = err < TOL_REL
    _timing.emit(dev, cross_check_rel_err=err, tol_rel=TOL_REL, ok=ok,
                 scale_multi=float(np.max(np.abs(a))),
                 scale_csr=float(np.max(np.abs(b))))
    if not ok:
        raise RuntimeError(f'the envelope and CSR routes differ by {err:.3e} '
                           f'of the output scale (tolerance {TOL_REL})')
    rows['cross_check_rel_err'] = err
    return rows


if __name__ == '__main__':
    main()
