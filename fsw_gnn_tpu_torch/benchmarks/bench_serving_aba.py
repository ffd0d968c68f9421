"""GraphServer transfer layouts served in turns in one process.

Counterpart of benchmarks/bench_serving_aba.py.  Three servers of the same
model and degree-class envelope (bench_serving's) that differ only in how a
request crosses to the card:

    single+u16   one pinned int32 carrier, indices packed two to a word
                 (the default wherever every index fits 16 bits)
    single+i32   one carrier, int32 indices
    triple       X, the int buffer and the float buffer as three copies

Two runs in separate processes may land on different cards or clocks, so
the layouts are compared only here: each request of one stream is served
by all three back to back, in rotated order (abc, bca, cab, ...) so that
no layout always goes first.  Latencies are the host clock around
`predict` (which returns host arrays).  Each server captures one CUDA graph
(its first request); `num_compiles()` must stay 1.  Last, the three on the
last request: the layouts move the same bits, so their outputs must agree
within TOL_REL of the scale (the script raises otherwise).

    python -m fsw_gnn_tpu_torch.benchmarks.bench_serving_aba [--device cpu]

Knobs (the JAX script's, with its defaults): SRV_REQUESTS 24,
SRV_MAX_NODES 2048, SRV_MAX_EDGES 32768, SRV_DIN 64, SRV_DOUT 16.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..serving import GraphServer
from . import _timing
from .bench_serving import TOL_REL, model_and_envelope, request

N_REQ = int(os.environ.get('SRV_REQUESTS', 24))
MAX_NODES = int(os.environ.get('SRV_MAX_NODES', 2048))
MAX_EDGES = int(os.environ.get('SRV_MAX_EDGES', 32768))
D_IN = int(os.environ.get('SRV_DIN', 64))
D_OUT = int(os.environ.get('SRV_DOUT', 16))
LAYOUTS = (('single+u16', {}), ('single+i32', {'pack_indices': False}),
           ('triple', {'transfer_layout': 'triple'}))


def setup(dev, n_req=N_REQ, max_nodes=MAX_NODES):
    """The JAX script's draws from default_rng(0): the representative
    request, then n_req requests of max_nodes // 4 .. max_nodes // 2
    nodes; and the model and envelope."""
    rng = np.random.default_rng(0)
    model, classes, class_rows = model_and_envelope(rng, dev, max_nodes,
                                                    D_IN, D_OUT)
    reqs = [request(rng, int(n), D_IN)
            for n in rng.integers(max_nodes // 4, max_nodes // 2 + 1, n_req)]
    return model, classes, class_rows, reqs


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_serving_aba')
    model, classes, class_rows, reqs = setup(dev)
    servers = [(name, GraphServer(model, MAX_NODES, MAX_EDGES,
                                  classes=classes, class_rows=class_rows,
                                  device=dev, **kw))
               for name, kw in LAYOUTS]
    for name, srv in servers:
        t0 = time.perf_counter()
        srv.predict(*reqs[0])
        _timing.emit(dev, server=name,
                     first_request_s=time.perf_counter() - t0)
    lat = {name: [] for name, _ in servers}
    for k, req in enumerate(reqs):
        order = servers[k % 3:] + servers[:k % 3]     # rotate who goes first
        for name, srv in order:
            t0 = time.perf_counter()
            srv.predict(*req)
            lat[name].append(1e3 * (time.perf_counter() - t0))
    rows = {}
    for name, _ in servers:
        s = _timing.spread(lat[name])
        rows[name] = {'server': name, 'requests': len(lat[name]),
                      'p50_ms': s['p50_ms'], 'p90_ms': s['p90_ms']}
        _timing.emit(dev, **rows[name])
    a = servers[0][1].predict(*reqs[-1])
    bad = []
    for name, srv in servers[1:]:
        b = srv.predict(*reqs[-1])
        err = float(np.max(np.abs(a - b)) / (1e-6 + np.max(np.abs(a))))
        _timing.emit(dev, cross_check=f'single+u16 vs {name}', rel_err=err,
                     tol_rel=TOL_REL, ok=err < TOL_REL)
        rows[f'rel_err_{name}'] = err
        if not err < TOL_REL:
            bad.append(name)
    for name, srv in servers:
        if srv.num_compiles() != 1:
            raise RuntimeError(f'{name}: {srv.num_compiles()} captures, '
                               f'not 1')
    if bad:
        raise RuntimeError(f'layouts {bad} differ from single+u16 by more '
                           f'than {TOL_REL} of the scale')
    return rows


if __name__ == '__main__':
    main()
