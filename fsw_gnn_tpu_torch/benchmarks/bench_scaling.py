"""The edge-partitioned train step at each process count.

Counterpart of benchmarks/bench_scaling.py.  A random graph of FSW_SC_NODES
nodes (FSW_SC_DEG draws an edge a node, self loops dropped; seed 0), d_in
FSW_SC_DIN, `FSWGNN(hidden_dims=(FSW_SC_HIDDEN, 8))` (random weights, seed
0), Adam(1e-3), every node labelled.  At each process count n, one process
a device is started through `parallel.launch` (NCCL with rank r on cuda:r;
gloo on the CPU): each rank partitions the graph (`partition_graph`), takes
its shard (`shard_node_features`, `shard_recipient_labels`) and runs
`make_distributed_train_step` (the all-gather exchange): one step, then
FSW_SC_ITERS steps timed (host clock with a synchronize; CUDA events on the
card).  Printed: ms a step, edges/s and the efficiency against n times the
one-process rate.  The first step's loss is held against a single-device
step of the same model in this process (within TOL_REL; the script raises
otherwise).

On the card n runs over 1 .. torch.cuda.device_count() (1, 2, 4, 8, 16,
32); with one card only n = 1 runs (a one-rank NCCL group), and a line
says that n > 1 was not measured.  `--device cpu` runs n = 1 and 2 on gloo,
the counterpart of the JAX script's virtual CPU mesh.  Rank 0's kernel
launches are counted in its process and printed; `main` returns the rows
and, under 'launches', those counts summed over the process counts.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_scaling [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_SC_NODES 4096,
FSW_SC_DEG 16, FSW_SC_DIN 32, FSW_SC_HIDDEN 32, FSW_SC_ITERS 10.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..graph import auto_layout, from_edge_index
from ..models import FSWGNN
from ..ops import launch_counts, reset_launches
from ..parallel.dist import masked_softmax_cross_entropy
from . import _timing
from .bench_csr_vs_table import normal32, random_edges

N_NODES = int(os.environ.get('FSW_SC_NODES', 4096))
AVG_DEG = int(os.environ.get('FSW_SC_DEG', 16))
D_IN = int(os.environ.get('FSW_SC_DIN', 32))
HIDDEN = int(os.environ.get('FSW_SC_HIDDEN', 32))
N_CLASSES = 8
ITERS = int(os.environ.get('FSW_SC_ITERS', 10))
TOL_REL = 1e-4
COUNTS = (1, 2, 4, 8, 16, 32)


def setup(n_nodes=N_NODES, avg_deg=AVG_DEG, d_in=D_IN):
    """The JAX script's draws from default_rng(0): (edge_index without
    self loops, X (n, d_in) float32, y (n,))."""
    rng = np.random.default_rng(0)
    ei = random_edges(rng, n_nodes, avg_deg)
    X = normal32(rng, (n_nodes, d_in))
    y = rng.integers(0, N_CLASSES, n_nodes)
    return ei, X, y


def make_model(dev):
    return FSWGNN(in_channels=D_IN, hidden_dims=(HIDDEN, N_CLASSES),
                  minimize_slice_coherence=False, device=dev,
                  generator=torch.Generator().manual_seed(0))


def rank_step(edge_index, X, y, iters, device):
    """One rank of the launch: the first step's loss, ms a step over
    `iters` steps (host clock; 'device_ms' by CUDA events on the card) and
    this process's kernel launches over all the steps."""
    from ..parallel import (make_distributed_train_step, make_graph_mesh,
                            partition_graph, shard_node_features,
                            shard_recipient_labels)
    mesh = make_graph_mesh(device=device)
    dev = mesh.device
    n = X.shape[0]
    g = from_edge_index(edge_index, n, dtype=np.float32)
    model = make_model(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    shards = partition_graph(g, mesh.size)
    Xs = shard_node_features(X, shards)
    labels, mask = shard_recipient_labels(y, np.ones(n, np.float32), shards)
    step = make_distributed_train_step(model, opt, shards, mesh)
    Xl = torch.as_tensor(Xs[mesh.rank]).to(dev)
    lab = torch.as_tensor(labels[mesh.rank]).long().to(dev)
    msk = torch.as_tensor(mask[mesh.rank]).float().to(dev)
    reset_launches()
    loss0 = float(step(Xl, lab, msk))
    out = {'loss_first': loss0, 'rank': mesh.rank}
    _timing.drain(dev)
    if dev.type == 'cuda':
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step(Xl, lab, msk)
    if dev.type == 'cuda':
        b.record()
    _timing.drain(dev)
    out['ms_per_step'] = 1e3 * (time.perf_counter() - t0) / iters
    if dev.type == 'cuda':
        out['device_ms_per_step'] = a.elapsed_time(b) / iters
    out['loss_last'] = float(loss)
    out['launches'] = launch_counts()
    return out


def reference_loss(edge_index, X, y, dev):
    """The first step's loss of the same model on one device (no group):
    the forward on the whole graph in the layout auto_layout picks."""
    n = X.shape[0]
    g = auto_layout(from_edge_index(edge_index, n, dtype=np.float32)).to(dev)
    model = make_model(dev).train()
    with torch.no_grad():
        s, c = masked_softmax_cross_entropy(
            model(torch.as_tensor(X).to(dev), g),
            torch.as_tensor(y).long().to(dev),
            torch.ones(n, dtype=torch.float32, device=dev))
    return float(s / c)


def main(argv=None):
    from ..parallel.launch import launch
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_scaling')
    edge_index, X, y = setup()
    E_real = from_edge_index(edge_index, X.shape[0]).num_edges
    if dev.type == 'cuda':
        avail = torch.cuda.device_count()
        counts = [n for n in COUNTS if n <= avail]
    else:
        counts = [1, 2]
    ref = reference_loss(edge_index, X, y, dev)
    results, base = [], None
    for n_dev in counts:
        reports = launch(n_dev, 'fsw_gnn_tpu_torch.benchmarks.bench_scaling:'
                         'rank_step',
                         dict(edge_index=edge_index, X=X, y=y, iters=ITERS,
                              device=dev.type),
                         device=dev.type, timeout=900)
        ms = max(r['ms_per_step'] for r in reports)
        eps = E_real / (ms * 1e-3)
        base = base or eps
        err = abs(reports[0]['loss_first'] - ref) / max(1.0, abs(ref))
        row = {'devices': n_dev, 'ms_per_step': ms, 'edges_per_s': eps,
               'scaling_efficiency': eps / (base * n_dev),
               'loss_first': reports[0]['loss_first'],
               'single_device_loss': ref, 'loss_rel_err': err,
               'tol_rel': TOL_REL, 'launches': reports[0]['launches']}
        if dev.type == 'cuda':
            row['device_ms_per_step'] = max(r['device_ms_per_step']
                                            for r in reports)
        _timing.emit(dev, **row)
        results.append(row)
        if not err <= TOL_REL:
            raise RuntimeError(f'{n_dev} processes: first loss '
                               f'{reports[0]["loss_first"]} against the '
                               f'single device {ref} ({err:.2e})')
    if dev.type == 'cuda' and max(counts) == 1:
        _timing.emit(dev, devices_not_measured='n > 1',
                     why=f'{torch.cuda.device_count()} CUDA device(s) here; '
                         f'NCCL takes one card a rank')
    launches = {}
    for row in results:
        for k, v in row['launches'].items():
            launches[k] = launches.get(k, 0) + v
    return {'rows': results, 'launches': launches}


if __name__ == '__main__':
    main()
