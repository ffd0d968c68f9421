"""Train briefly, export the forward, and serve request graphs.

Counterpart of examples/demo_serving.py: a `Trainer` fit (one hidden layer
of 16, 20 epochs, learning rate 2e-2) on `synthetic_planted_partition(300,
3, 16)`; the trained forward closed over the training graph exported with
`torch.export` (`serving.export_forward`), saved, loaded and run; then a
`GraphServer` with a degree-class envelope (sized from a 128-node request)
serving a stream of requests of 30, 77 and 128 nodes through the envelope
route and one 128-node star whose hub overflows the envelope, through the
CSR route: one CUDA graph a route on the card, so `num_compiles()` ends at
2.

    python -m fsw_gnn_tpu_torch.examples.demo_serving [--device cpu]
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..data import synthetic_planted_partition
from ..device import resolve_device
from ..graph import from_edge_index
from ..serving import (GraphServer, export_forward, load_artifact,
                       multi_envelope, save_artifact)
from ..train import TrainConfig, Trainer
from ._args import parser

MAX_NODES, MAX_EDGES = 128, 2048


def _random_request(rng, n, d, p=0.1):
    A = rng.random((n, n)) < p
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    return (np.stack([src, dst]),
            rng.standard_normal((n, d)).astype(np.float32))


def main(argv=None, epochs=20):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    data = synthetic_planted_partition(num_nodes=300, num_classes=3,
                                       feat_dim=16, p_in=0.08, p_out=0.01)
    tr = Trainer(data, TrainConfig(hidden_dims=(16,), epochs=epochs,
                                   eval_every=10, learning_rate=2e-2),
                 device=dev)
    out = tr.fit()
    print(f"trained: test_acc={out['final']['test_acc']:.3f} "
          f"(device: {dev})")

    # 1) a frozen artifact for the training graph (offline scoring)
    blob = export_forward(tr.model, tr.X, tr.compute_graph, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'fswgnn_demo.pt2')
        save_artifact(path, blob)
        fwd = load_artifact(path)
    with torch.no_grad():
        logits = fwd(tr.X)
        tr.model.eval()
        want = tr.model(tr.X, tr.compute_graph)
    err = float((logits - want).abs().max() / (1e-6 + want.abs().max()))
    print(f'artifact: {len(blob)} bytes, logits {tuple(logits.shape)}, '
          f'against the module {err:.2e}')
    if not err < 1e-4:
        raise RuntimeError(f'the artifact differs from the module by {err}')

    # 2) the online server: an envelope route and the CSR route
    rng = np.random.default_rng(0)
    d = data.features.shape[1]
    ref, _ = _random_request(rng, MAX_NODES, d)
    classes, class_rows = multi_envelope(from_edge_index(ref, MAX_NODES),
                                         max_nodes=MAX_NODES)
    srv = GraphServer(tr.model, MAX_NODES, MAX_EDGES, classes=classes,
                      class_rows=class_rows, device=dev)
    stream = [_random_request(rng, n, d) for n in (30, 77, 128)]
    hub = MAX_NODES - 1
    stream.append((np.stack([np.arange(1, hub + 1), np.zeros(hub, np.int64)]),
                   rng.standard_normal((MAX_NODES, d)).astype(np.float32)))
    for ei, X in stream:
        pred = srv.predict(ei, X)
        print(f'request n={X.shape[0]:4d}: predictions {pred.shape}, '
              f'outside the envelope so far: {srv.fallbacks}, '
              f'compiles so far: {srv.num_compiles()}')
        if not np.isfinite(pred).all():
            raise RuntimeError('a prediction is not finite')
    if srv.num_compiles() != 2 or srv.fallbacks != 1:
        raise RuntimeError(f'{srv.num_compiles()} captures and '
                           f'{srv.fallbacks} fallbacks, not 2 and 1')
    return out


if __name__ == '__main__':
    main()
