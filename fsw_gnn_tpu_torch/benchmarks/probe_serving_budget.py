"""A served request's time by stage: host build, copy in, execution, copy
out, and the whole `predict`.

Counterpart of benchmarks/probe_serving_budget.py, on bench_serving's
envelope server (`FSWGNN(hidden_dims=(64, 16))`, seed 0) and one request of
max_nodes // 2 nodes.  Each stage alone:

  build            the host's work of a request (`GraphServer._host_request`:
                   pad, CSR build, the envelope check, `to_multi_table`,
                   packing into the pinned carrier); host clock
  h2d              the pinned carrier's non-blocking copy to the card;
                   CUDA events (the bytes and the GB/s beside it)
  exec_1           one replay of the route's CUDA graph on inputs already
                   staged in its buffers; CUDA events
  exec_pipelined8  eight replays back to back, the ms of one; CUDA events
  d2h_full         the route's whole (max_nodes, d_out) output to the host;
                   host clock with a synchronize
  predict_e2e      `GraphServer.predict` of the request; host clock

SRV_REPS windows a stage (one call each); p50, min and max.  On the CPU the
route runs eagerly (no graph, no copy): exec is its forward on the request's
tensors and h2d a copy between host tensors.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_serving_budget [--device cpu]

Knobs (the JAX script's, with its defaults): SRV_MAX_NODES 2048,
SRV_MAX_EDGES 32768, SRV_DIN 64, SRV_DOUT 16, SRV_REPS 10.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..serving import GraphServer
from ..utils.cache import CountingGraph
from . import _timing
from .bench_serving import model_and_envelope, request

MAX_NODES = int(os.environ.get('SRV_MAX_NODES', 2048))
MAX_EDGES = int(os.environ.get('SRV_MAX_EDGES', 32768))
D_IN = int(os.environ.get('SRV_DIN', 64))
D_OUT = int(os.environ.get('SRV_DOUT', 16))
REPS = int(os.environ.get('SRV_REPS', 10))


def setup(dev, max_nodes=MAX_NODES):
    """The JAX script's draws from default_rng(0): the representative
    request (the envelope), then the probed request of max_nodes // 2
    nodes; and the model."""
    rng = np.random.default_rng(0)
    model, classes, class_rows = model_and_envelope(rng, dev, max_nodes,
                                                    D_IN, D_OUT)
    ei, X = request(rng, max_nodes // 2, D_IN)
    return model, classes, class_rows, ei, X


def staged(srv, route, host):
    """(exec, output) of the route's graph with the request's inputs copied
    into its buffers once; on the CPU the route's forward on the host
    tensors."""
    entry = srv._graphs._graphs[CountingGraph._key(route, host)]
    if srv.device.type != 'cuda':
        fn = srv._graphs._fns[route]
        out = fn(*host)
        return (lambda: fn(*host)), out
    entry._copy_in(host)
    torch.cuda.synchronize(srv.device)
    return entry.graph.replay, entry.output


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_serving_budget')
    model, classes, class_rows, ei, X = setup(dev)
    srv = GraphServer(model, MAX_NODES, MAX_EDGES, classes=classes,
                      class_rows=class_rows, device=dev)
    srv.predict(ei, X)                                   # capture
    route, host, _ = srv._host_request(ei, X)
    nbytes = sum(t.numel() * t.element_size() for t in host)
    _timing.emit(dev, route=route, carrier_bytes=nbytes,
                 transfers=len(host))
    dst = [torch.empty_like(t, device=dev) for t in host]

    def h2d():
        for d, s in zip(dst, host):
            d.copy_(s, non_blocking=True)

    exec_1, out = staged(srv, route, host)

    def exec_8():
        for _ in range(8):
            exec_1()

    stages = {}
    stages['build'] = _timing.host_ms(lambda: srv._host_request(ei, X), dev,
                                      REPS)
    stages['h2d'] = _timing.windows_ms(h2d, dev, 1, REPS)
    stages['exec_1'] = _timing.windows_ms(exec_1, dev, 1, REPS)
    stages['exec_pipelined8'] = [t / 8 for t in _timing.windows_ms(
        exec_8, dev, 1, REPS)]
    stages['d2h_full'] = _timing.host_ms(lambda: out.cpu(), dev, REPS)
    stages['predict_e2e'] = _timing.host_ms(lambda: srv.predict(ei, X), dev,
                                            REPS)
    clock = {'build': 'host', 'd2h_full': 'host', 'predict_e2e': 'host'}
    rows = {}
    for name, ts in stages.items():
        s = _timing.spread(ts)
        kind = clock.get(name, 'cuda_events' if dev.type == 'cuda'
                         else 'host')
        row = {'stage': name, 'clock': kind, 'p50_ms': s['p50_ms'],
               'min_ms': s['min_ms'], 'max_ms': s['max_ms']}
        if name == 'h2d' and dev.type == 'cuda':
            row['gb_per_s'] = nbytes / (s['p50_ms'] * 1e6)
        _timing.emit(dev, **row)
        rows[name] = row
    if srv.num_compiles() != 1:
        raise RuntimeError(f'{srv.num_compiles()} captures, not 1')
    return rows


if __name__ == '__main__':
    main()
