"""The work model's counts against hand-worked counts on a 3-node graph:
edges 1 -> 0, 2 -> 0, 0 -> 1, so in-degrees (2, 1, 0)."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import workmodel as wm

# one FSWConv(2, 2) with one Linear: embed 4, 3 slices, head 6 -> 2
MODEL = {'kind': 'fsw_conv', 'in_channels': 2, 'out_channels': 2,
         'mlp_layers': 1}
DEG = np.array([2, 1, 0])


def test_rank_ops():
    # 2 log2 2 + 2 = 4, 1 log2 1 + 1 = 1, 0
    assert wm.rank_ops(DEG) == 5.0


def test_layer_dims_and_params():
    assert wm.layer_dims(MODEL) == [(2, 3, [(6, 2)], False)]
    # slices 3 x 2, freqs 3, Linear 6 x 2 + 2
    assert wm.num_params(MODEL) == 23


def test_step_work():
    w = wm.step_work(MODEL, {'optimizer': 'sgd'}, DEG, 3, 3)
    # 3 slices x (rank 5 + 3 entries x 20) forward, 3 x 3 x 45 backward
    assert w['ops'] == 3 * (5 + 60) + 3 * 3 * 45
    # X V^T and dV: 2 x 3 nodes x 2 x 3, twice; the head: forward and dW
    # 2 x 3 x 2 x 6 each, d(input) on the 3 slice columns 2 x 3 x 2 x 3
    assert w['mma_ops'] == 2 * 36 + 2 * 72 + 36
    # X 3 x 2, edges 2 x 3, SGD 3 passes over 23 parameters, 4 bytes each
    assert w['bytes'] == 4 * (6 + 6 + 69)
    assert w['floor_s'] == pytest.approx(max(
        w['ops'] / 67e12, 3 * w['mma_ops'] / 495e12, w['bytes'] / 3.35e12))


def test_adam_bytes_and_input_gradient():
    gnn = {'kind': 'fsw_gnn', 'in_channels': 2, 'hidden_dims': [2],
           'num_classes': 2, 'mlp_layers': 1}
    dims = wm.layer_dims(gnn)
    assert [d[3] for d in dims] == [False, True]
    w = wm.step_work(gnn, {'optimizer': 'adam'}, DEG, 3, 3)
    assert w['bytes'] == 4 * (6 + 6 + 7 * 2 * 23)
    # the second layer also takes dX (2 x 3 x 2 x 3) and the head's own
    # features' gradient (2 x 3 x 2 x 2)
    assert w['mma_ops'] == 2 * (2 * 36 + 2 * 72 + 36) + 36 + 24


def test_k1_work():
    fwd = max(3 * (5 + 60) / 67e12, 3 * (3 * 3 * 2 * 2) / 495e12,
              4 * (6 + 6 + 2 + 3 + 6 + 6) / 3.35e12)
    bwd = max(3 * (5 + 135) / 67e12, 3 * (3 * 3 * 2 * 2 * 2) / 495e12,
              4 * (6 + 6 + 2 + 6 + 12 + 6) / 3.35e12)
    assert wm.k1_work(MODEL, DEG, 3)['floor_s'] == pytest.approx(fwd + bwd)
