"""Dataset loaders for node-classification benchmarks (numpy only).

The port's own copy of `fsw_gnn_tpu/data/datasets.py`, so that the port
imports nothing of the JAX package.  Loaders read preprocessed local files
when present (FSW_DATA_DIR, else `data/` at the repository root, npz
format) and otherwise generate synthetic planted-partition graphs with the
same interface and the same arrays as the JAX package's for a seed.

npz schema: edge_index (2, E) int64, features (N, d) float32, labels (N,)
int64, train_mask/val_mask/test_mask (N,) bool.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class NodeClassificationData:
    name: str
    edge_index: np.ndarray       # (2, E)
    features: np.ndarray         # (N, d)
    labels: np.ndarray           # (N,)
    train_mask: np.ndarray       # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


def data_dir() -> str:
    return os.environ.get('FSW_DATA_DIR',
                          os.path.join(os.path.dirname(os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__)))),
                              'data'))


def load_npz(name: str) -> Optional[NodeClassificationData]:
    path = os.path.join(data_dir(), f'{name}.npz')
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return NodeClassificationData(
        name=name, edge_index=z['edge_index'], features=z['features'],
        labels=z['labels'], train_mask=z['train_mask'],
        val_mask=z['val_mask'], test_mask=z['test_mask'])


def synthetic_planted_partition(name: str = 'synthetic',
                                num_nodes: int = 600,
                                num_classes: int = 4,
                                feat_dim: int = 32,
                                p_in: float = 0.05,
                                p_out: float = 0.005,
                                train_frac: float = 0.3,
                                val_frac: float = 0.2,
                                seed: int = 0) -> NodeClassificationData:
    """Planted-partition graph: intra-class edges denser than inter-class,
    class-dependent feature means -- learnable by a GNN, solvable offline."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    A = rng.random((num_nodes, num_nodes)) < prob
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    edge_index = np.stack([src, dst]).astype(np.int64)

    means = rng.standard_normal((num_classes, feat_dim)) * 1.5
    features = (means[labels] +
                rng.standard_normal((num_nodes, feat_dim))).astype(np.float32)

    order = rng.permutation(num_nodes)
    n_tr = int(train_frac * num_nodes)
    n_va = int(val_frac * num_nodes)
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[order[:n_tr]] = True
    val_mask[order[n_tr:n_tr + n_va]] = True
    test_mask[order[n_tr + n_va:]] = True

    return NodeClassificationData(name=name, edge_index=edge_index,
                                  features=features, labels=labels,
                                  train_mask=train_mask, val_mask=val_mask,
                                  test_mask=test_mask)


_SYNTH_SIZES = {
    'cora': dict(num_nodes=2708, num_classes=7, feat_dim=1433,
                 p_in=0.004, p_out=0.0004),
    'citeseer': dict(num_nodes=3327, num_classes=6, feat_dim=3703,
                     p_in=0.003, p_out=0.0003),
    'ogbn-arxiv': dict(num_nodes=16000, num_classes=40, feat_dim=128,
                       p_in=0.002, p_out=0.0001),
}


def load(name: str, allow_synthetic: bool = True) -> NodeClassificationData:
    """Load a named dataset; fall back to a size-matched synthetic graph."""
    real = load_npz(name)
    if real is not None:
        return real
    if not allow_synthetic:
        raise FileNotFoundError(
            f'{name}.npz not found under {data_dir()} and synthetic fallback '
            f'disabled')
    kwargs = _SYNTH_SIZES.get(name, {})
    return synthetic_planted_partition(name=f'{name}-synthetic', **kwargs)
