"""The doubly-stochastic graph metric of a graph against an isomorphic copy
and against an unrelated graph.

Counterpart of examples/demo_dsmetric.py (`utils/dsmetric.py`, the
entropic mirror-descent solver): a random symmetric graph of `--n` nodes
(edge probability 0.3) with D = 4 features a node (seed 0), a
permuted copy (the metric should be near zero) and an unrelated graph (it
should be clearly positive).  `--steps` is the solver's outer iterations
(500, as the JAX demo; fewer for a quick run on the CPU).

    python -m fsw_gnn_tpu_torch.examples.demo_dsmetric [--device cpu]
        [--n 12] [--steps 500]
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..utils.dsmetric import dsmetric
from ._args import parser

D = 4


def graphs(n, d=D):
    """The JAX demo's draws from default_rng(0): (A1, V1), its permuted
    copy (A2, V2) and an unrelated (A3, V3)."""
    rng = np.random.default_rng(0)
    A1 = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(A1, 0)
    A1 = np.maximum(A1, A1.T)
    V1 = rng.standard_normal((n, d))
    perm = rng.permutation(n)
    P = np.eye(n)[perm]
    A2, V2 = P @ A1 @ P.T, P @ V1
    A3 = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(A3, 0)
    A3 = np.maximum(A3, A3.T)
    V3 = rng.standard_normal((n, d))
    return (A1, V1), (A2, V2), (A3, V3)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument('--n', type=int, default=12)
    ap.add_argument('--steps', type=int, default=500)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    (A1, V1), (A2, V2), (A3, V3) = graphs(args.n)
    d_iso = dsmetric(A1, V1, A2, V2, n_outer=args.steps, device=dev)
    d_rand = dsmetric(A1, V1, A3, V3, n_outer=args.steps, device=dev)
    print(f'dsmetric(G, isomorphic(G)) = {d_iso:.4f}')
    print(f'dsmetric(G, random H)      = {d_rand:.4f}')
    if not (np.isfinite(d_iso) and np.isfinite(d_rand)):
        raise RuntimeError('a metric is not finite')
    return d_iso, d_rand


if __name__ == '__main__':
    main()
