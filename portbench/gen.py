"""The benchmark's inputs, made from `--seed`: graphs, features, labels,
split masks and every initial parameter of the model.

Frozen copies of the program's generators, kept here so that a change to
the program cannot change the yardstick:
  * `simple_edges`: the headline graph (fsw_gnn_tpu_torch/bench.py,
    bench.py:100-110): n * draws (src, dst) draws, self loops dropped,
    duplicate pairs merged, every weight 1; N(0, 1) features;
  * `planted_classes`: chip_smoke.py's `arxiv_data`, a node-classification
    graph of given counts with planted labels, built in O(E), and
    features around the classes' means.
Each takes the configuration's `data` group and numpy Generators, and
gives numpy arrays.  The initial parameters are
drawn on the device by a torch.Generator seeded from the same seed, in one
call per distribution (`init_params`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = 2 ** 63 - 1


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & SEED_MASK)


def simple_edges(data: dict, g: np.random.Generator) -> dict:
    """bench.py's graph: n * draws (src, dst) draws, self loops dropped,
    duplicate pairs merged, every weight 1."""
    n, deg = int(data['num_nodes']), int(data['draws_per_node'])
    E = n * deg
    src = g.integers(0, n, E)
    dst = g.integers(0, n, E)
    keep = src != dst
    pairs = np.unique(src[keep].astype(np.int64) * n + dst[keep])
    return {'edge_index': np.stack([pairs // n, pairs % n]), 'num_nodes': n}


def normal_features(data: dict, g: np.random.Generator, graph: dict):
    """N(0, 1) features (float32)."""
    return g.standard_normal((graph['num_nodes'], int(data['features']))
                             ).astype(np.float32)


def planted_classes(data: dict, g: np.random.Generator) -> dict:
    """`arxiv_data`'s graph: planted labels, `same_class` of the edges
    drawn from the recipient's class (the rest uniform), no self loops
    (duplicates kept, as in the original: the program merges them), and
    the split sizes over a random permutation."""
    N, E = int(data['num_nodes']), int(data['num_edges'])
    C = int(data['classes'])
    labels = g.integers(0, C, N)
    by_class = np.argsort(labels, kind='stable')
    starts = np.searchsorted(labels[by_class], np.arange(C + 1))
    dst = g.integers(0, N, E)
    src = g.integers(0, N, E)
    same = g.random(E) < float(data['same_class'])
    cls = labels[dst[same]]
    size = starts[cls + 1] - starts[cls]
    src[same] = by_class[starts[cls] + (g.random(cls.shape[0])
                                        * size).astype(np.int64)]
    src = np.where(src == dst, (src + 1) % N, src)
    perm = g.permutation(N)
    n_tr, n_va, _ = (int(s) for s in data['split'])
    masks = []
    for lo, hi in ((0, n_tr), (n_tr, n_tr + n_va), (n_tr + n_va, N)):
        m = np.zeros(N, bool)
        m[perm[lo:hi]] = True
        masks.append(m)
    return {'edge_index': np.stack([src, dst]), 'labels': labels,
            'train_mask': masks[0], 'val_mask': masks[1],
            'test_mask': masks[2], 'num_nodes': N}


def class_features(data: dict, g: np.random.Generator, graph: dict):
    """`arxiv_data`'s features: N(mean of the node's class, 1), the class
    means N(0, mean_scale^2)."""
    F, C = int(data['features']), int(data['classes'])
    means = g.standard_normal((C, F)) * float(data['mean_scale'])
    return (means[graph['labels']] + g.standard_normal(
        (graph['num_nodes'], F))).astype(np.float32)


GENERATORS = {'simple_edges': (simple_edges, normal_features),
              'planted_classes': (planted_classes, class_features)}


def relabel(graph: dict, perm: np.ndarray) -> dict:
    """The same graph with node i renamed perm[i]: its edges, and its
    per-node arrays moved to their nodes' new names."""
    out = dict(graph)
    out['edge_index'] = perm[graph['edge_index']]
    for key in ('labels', 'train_mask', 'val_mask', 'test_mask'):
        if key in graph:
            moved = np.empty_like(graph[key])
            moved[perm] = graph[key]
            out[key] = moved
    return out


def make_data(data: dict, seed: int) -> dict:
    """The configuration's data from `seed`: the graph that
    `structure_seed` makes, its nodes renamed by a permutation drawn from
    `seed`, and features from `seed`.  Every seed then runs the same degree
    classes (the same work) on another labelling."""
    graph_of, features_of = GENERATORS[data['generator']]
    g = rng(seed)
    graph = graph_of(data, rng(data['structure_seed']))
    graph = relabel(graph, g.permutation(graph['num_nodes']))
    graph['features'] = features_of(data, g, graph)
    return graph


def coalesce(edge_index: np.ndarray, num_nodes: int):
    """(src, dst, weight) of a (2, E) edge list with duplicate pairs
    merged (their weights summed), sorted by (dst, src): the graph as the
    FSW aggregation sees it."""
    src = edge_index[0].astype(np.int64)
    dst = edge_index[1].astype(np.int64)
    key, count = np.unique(dst * num_nodes + src, return_counts=True)
    return key % num_nodes, key // num_nodes, count.astype(np.float64)


# ---------------------------------------------------------------------------
# the model's leaves, named as the program's state_dict names them

def conv_leaves(prefix: str, d_in: int, d_out: int, mlp_layers: int,
                embed_dim=None, mlp_hidden=None) -> list:
    """(name, shape, init) of one FSWConv with its defaults: concat_self,
    the degree encoding, learnable slices and frequencies ('spread'), no
    embedding bias under an MLP, `mlp_layers` Linear layers with biases.
    init: 'slices' (N(0, 1) rows, normalized), 'spread', 'one', or
    ('uniform', bound)."""
    if mlp_layers < 1:
        raise ValueError('the benchmark models an MLP head (mlp_layers >= 1)')
    E = embed_dim or 2 * max(d_in, d_out)
    S = E - 1                                     # one column is the degree
    hidden = mlp_hidden or max(d_in, d_out)
    out = [(f'{prefix}fsw_embed.proj_vecs', (S, d_in), 'slices'),
           (f'{prefix}fsw_embed.freqs', (S,), 'spread'),
           (f'{prefix}fsw_embed.total_mass_scale', (), 'one')]
    width = E + d_in
    for i in range(mlp_layers):
        o = d_out if i == mlp_layers - 1 else hidden
        b = 1.0 / math.sqrt(width)
        out += [(f'{prefix}head.dense.{i}.weight', (o, width), ('uniform', b)),
                (f'{prefix}head.dense.{i}.bias', (o,), ('uniform', b))]
        width = o
    return out


def model_leaves(model: dict) -> list:
    """Every leaf of the configuration's model."""
    if model['kind'] == 'fsw_conv':
        return conv_leaves('', model['in_channels'], model['out_channels'],
                           model['mlp_layers'])
    if model['kind'] == 'fsw_gnn':
        dims = list(model['hidden_dims']) + [model['num_classes']]
        out, d_in = [], model['in_channels']
        for i, d in enumerate(dims):
            out += conv_leaves(f'convs.{i}.', d_in, d, model['mlp_layers'])
            d_in = d
        return out
    raise ValueError(f"unknown model kind {model['kind']!r}")


def init_params(model: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} of every leaf, drawn on `device` from `seed`: one
    normal draw for all slice vectors, one uniform draw for all Linear
    layers (the program's own distributions: rows of N(0, 1) normalized,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))); the frequencies at the 'spread'
    quantiles u / (1 - u), u = (i + 1/2) / S; the degree scale 1."""
    leaves = model_leaves(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    n_norm = sum(math.prod(s) for _, s, k in leaves if k == 'slices')
    n_unif = sum(math.prod(s) for _, s, k in leaves if isinstance(k, tuple))
    normal = torch.randn(n_norm, generator=gen, device=device,
                         dtype=torch.float32)
    unif = torch.rand(n_unif, generator=gen, device=device,
                      dtype=torch.float32)
    out, i_n, i_u = {}, 0, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        if kind == 'slices':
            v = normal[i_n:i_n + n].reshape(shape).double()
            i_n += n
            v = v / torch.linalg.norm(v, dim=1, keepdim=True)
        elif kind == 'spread':
            u = (0.5 + torch.arange(shape[0], dtype=torch.float64,
                                    device=device)) / shape[0]
            v = u / (1 - u)
        elif kind == 'one':
            v = torch.ones(shape, dtype=torch.float64, device=device)
        else:
            b = kind[1]
            v = (unif[i_u:i_u + n].reshape(shape).double() * 2 - 1) * b
            i_u += n
        out[name] = v.to(dtype)
    return out


def trainable(name: str) -> bool:
    """Whether the program trains the leaf (the degree scale is a buffer)."""
    return not name.endswith('total_mass_scale')
