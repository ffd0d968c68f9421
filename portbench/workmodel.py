"""The H100's floor of a training step and of the K1 kernels' calls: the
least time the card could take for the work, whatever implements it.

A frozen copy of the program's bound model (fsw_gnn_tpu_torch/utils/
bounds.py: the published peaks at 700 W, ranking counted as a stable sort
plus a cumsum on the real entries only, the trig of an entry-slice at
about 20 operations forward and 45 backward), with two corrections:
  * bytes are what must move once: the features X, the edge list (sender
    and weight of every real entry), the parameters and the optimizer
    state, and each call's outputs; not the padded, gathered R x B x D
    table that one implementation reads;
  * the step's floor covers all of the step: every layer's FSW embedding
    forward and backward, the projections and the MLP head's products,
    and the optimizer's bytes.
The step's projections are counted once a node (X @ V^T, its dV and, where
the layer's input takes a gradient, its dX), the least any route needs;
K1's own floor counts them once an entry, as that kernel's function
projects every gathered entry.  Every product runs at the 3xTF32 rate
(495 / 3 TFLOP/s, float32's accuracy on the tensor cores), every other
operation at float32's 67 TFLOP/s, bytes at 3.35 TB/s, and the pipes
overlap, so a floor is the largest of the three times.
"""
from __future__ import annotations

import numpy as np

PEAK_F32_OPS = 67e12          # H100 SXM, float32 outside the tensor cores
PEAK_TF32_OPS = 495e12        # TF32 on the tensor cores; 3xTF32 a third
PEAK_BYTES = 3.35e12          # HBM3
TRIG_OPS, BWD_TRIG_OPS = 20, 45
F32 = 4


def floor_s(ops, mma_ops, nbytes):
    """Seconds: the largest of the float32 operations', the 3xTF32
    products' and the bytes' times."""
    return max(ops / PEAK_F32_OPS, 3.0 * mma_ops / PEAK_TF32_OPS,
               nbytes / PEAK_BYTES)


def rank_ops(deg):
    """Operations that rank d real entries at the least, summed over the
    rows: a stable sort's d log2 d compares and a cumsum's d adds."""
    deg = np.asarray(deg, np.float64)
    return float((deg * np.log2(np.maximum(deg, 1.0)) + deg).sum())


def layer_dims(model: dict) -> list:
    """(d_in, slices, head widths [(in, out)], input takes a gradient) of
    every FSWConv of the configuration's model."""
    if model['kind'] == 'fsw_conv':
        dims = [(model['in_channels'], model['out_channels'])]
    else:
        outs = list(model['hidden_dims']) + [model['num_classes']]
        ins = [model['in_channels']] + outs[:-1]
        dims = list(zip(ins, outs))
    out = []
    for i, (d_in, d_out) in enumerate(dims):
        E = 2 * max(d_in, d_out)
        hidden = max(d_in, d_out)
        widths, w = [], E + d_in
        for j in range(model['mlp_layers']):
            o = d_out if j == model['mlp_layers'] - 1 else hidden
            widths.append((w, o))
            w = o
        out.append((d_in, E - 1, widths, i > 0))
    return out


def num_params(model: dict) -> int:
    total = 0
    for d_in, S, widths, _ in layer_dims(model):
        total += S * d_in + S + sum(i * o + o for i, o in widths)
    return total


def step_work(model: dict, train: dict, deg, num_nodes: int,
              num_edges: int) -> dict:
    """(float32 operations, 3xTF32 product operations, bytes) of one
    training step on a graph of in-degrees `deg` (real entries a
    recipient), and its floor in seconds."""
    N = num_nodes
    n_real = float(np.sum(deg))
    ops = mma = 0.0
    for d_in, S, widths, needs_dx in layer_dims(model):
        # the embedding: rank and trig forward, trig backward (the forward's
        # order kept), the projection once a node forward and backward
        ops += S * (rank_ops(deg) + n_real * TRIG_OPS)
        ops += S * n_real * BWD_TRIG_OPS
        mma += 2.0 * N * d_in * S * (3 if needs_dx else 2)
        for j, (i, o) in enumerate(widths):
            # forward and weight gradient; the input's gradient where
            # something before it takes one: of the first layer's input,
            # the slices' columns, and the own features only where the
            # layer's input takes a gradient (the degree column never)
            d_part = i if j > 0 else i - 1 - (0 if needs_dx else d_in)
            mma += 2.0 * N * o * (2 * i + d_part)
    d0 = layer_dims(model)[0][0]
    # read p and g, write p (SGD); Adam also reads and writes m and v
    passes = 3 if train['optimizer'] == 'sgd' else 7
    nbytes = F32 * (N * d0 + 2 * num_edges + passes * num_params(model))
    return {'ops': ops, 'mma_ops': mma, 'bytes': float(nbytes),
            'floor_s': floor_s(ops, mma, nbytes)}


def k1_work(model: dict, deg, num_nodes: int) -> dict:
    """The floor, in seconds, of one step's K1f and K1b calls (the fused
    projection kernels) over every real entry of every layer, counted as
    one call each way: K1f ranks, projects every entry (2 D a slice) and
    runs the trig; K1b ranks again, recomputes the projections, forms dV
    and, where the layer's input takes a gradient, dZ.  Bytes: the
    senders' rows, the entries' senders and weights, the phantom masses,
    the slices and frequencies, the output (forward) or its cotangent and
    the gradients (backward)."""
    deg = np.asarray(deg, np.float64)
    n_real = float(deg.sum())
    R = int((deg > 0).sum())
    total = 0.0
    for d_in, S, _, needs_dx in layer_dims(model):
        rows = min(num_nodes, n_real) * d_in
        fwd = floor_s(S * (rank_ops(deg) + n_real * TRIG_OPS),
                      S * n_real * 2 * d_in,
                      F32 * (rows + 2 * n_real + R + S + d_in * S + R * S))
        bwd = floor_s(S * (rank_ops(deg) + n_real * BWD_TRIG_OPS),
                      S * n_real * 2 * d_in * (3 if needs_dx else 2),
                      F32 * (rows * (2 if needs_dx else 1) + 2 * n_real + R
                             + 2 * S + 2 * d_in * S + R * S))
        total += fwd + bwd
    return {'floor_s': total}
