"""A repeated request against fresh requests of the same shapes, on both
servers, then a copy of the same bytes against fresh bytes.

Counterpart of benchmarks/probe_serving_fresh.py.  The JAX script looked
for a payload cache in the remote link to its TPU; the card has none, so
here the arms isolate:

  repeat_same   `predict` of one request SRV_REPS times: the host builds
                and packs it anew each time (the server keeps nothing of a
                request), so against `fresh` it shows what the host's
                caches give a request whose arrays it has just read
  fresh         `predict` of SRV_REPS different requests of max_nodes // 2
                nodes (the padded shapes are the envelope's, one graph a
                route), on the envelope server and on the CSR server
  h2d           a 760 KB pageable float32 array copied to the card (and
                synchronized) SRV_REPS times: the same array, then a fresh
                array each time; a pageable copy goes through the driver's
                pinned staging buffer, so this isolates the host-side copy

Latencies are the host clock (p50 of SRV_REPS); `predict` returns host
arrays, and each copy ends with a synchronize.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_serving_fresh [--device cpu]

Knobs (the JAX script's, with its defaults): SRV_MAX_NODES 2048,
SRV_MAX_EDGES 32768, SRV_DIN 64, SRV_DOUT 16, SRV_REPS 8.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..serving import GraphServer
from . import _timing
from .bench_serving import model_and_envelope, request

MAX_NODES = int(os.environ.get('SRV_MAX_NODES', 2048))
MAX_EDGES = int(os.environ.get('SRV_MAX_EDGES', 32768))
D_IN = int(os.environ.get('SRV_DIN', 64))
D_OUT = int(os.environ.get('SRV_DOUT', 16))
REPS = int(os.environ.get('SRV_REPS', 8))
H2D_FLOATS = 190000


def setup(dev, reps=REPS, max_nodes=MAX_NODES):
    """The JAX script's draws: from default_rng(0) the representative
    request, then `reps` fresh requests of max_nodes // 2 nodes; the H2D
    arrays from default_rng(1) (the same) and default_rng(i + 2) (fresh);
    and the model."""
    rng = np.random.default_rng(0)
    model, classes, class_rows = model_and_envelope(rng, dev, max_nodes,
                                                    D_IN, D_OUT)
    fresh = [request(rng, max_nodes // 2, D_IN) for _ in range(reps)]
    same = np.random.default_rng(1).standard_normal(H2D_FLOATS).astype(
        np.float32)
    bufs = [np.random.default_rng(i + 2).standard_normal(H2D_FLOATS)
            .astype(np.float32) for i in range(reps)]
    return model, classes, class_rows, fresh, same, bufs


def _p50(ts):
    return _timing.spread(ts)['p50_ms']


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_serving_fresh')
    model, classes, class_rows, fresh, same, bufs = setup(dev)
    servers = [('multi', GraphServer(model, MAX_NODES, MAX_EDGES,
                                     classes=classes, class_rows=class_rows,
                                     device=dev)),
               ('csr', GraphServer(model, MAX_NODES, MAX_EDGES, device=dev))]
    rows = {}
    for name, srv in servers:
        srv.predict(*fresh[0])                 # capture

        def run(stream):
            ts = []
            for ei, X in stream:
                t0 = time.perf_counter()
                srv.predict(ei, X)
                ts.append(1e3 * (time.perf_counter() - t0))
            return _p50(ts)

        rows[name] = {'server': name,
                      'repeat_same_p50_ms': run([fresh[0]] * REPS),
                      'fresh_p50_ms': run(fresh),
                      'compiles': srv.num_compiles()}
        _timing.emit(dev, **rows[name])
        if srv.num_compiles() != 1:
            raise RuntimeError(f'{name}: {srv.num_compiles()} captures, '
                               f'not 1')

    def h2d(arrs):
        ts = []
        for a in arrs:
            t0 = time.perf_counter()
            torch.from_numpy(a).to(dev)
            _timing.drain(dev)
            ts.append(1e3 * (time.perf_counter() - t0))
        return _p50(ts)

    h2d([same])                                # first copy: set-up
    rows['h2d'] = {'h2d_760KB_same_p50_ms': h2d([same] * REPS),
                   'h2d_760KB_fresh_p50_ms': h2d(bufs)}
    _timing.emit(dev, **rows['h2d'])
    return rows


if __name__ == '__main__':
    main()
