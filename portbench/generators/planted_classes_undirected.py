"""planted_classes_undirected: `gen.planted_classes`'s graph made
undirected, as OGB's and PyG's sampled ogbn-arxiv examples train it
(`adj_t.to_symmetric()`, `ToUndirected`): every edge also in the reverse
direction, duplicate pairs merged.  Labels, split and features as
`planted_classes` gives them."""
from __future__ import annotations

import numpy as np

from portbench import gen


def graph(data: dict, g: np.random.Generator) -> dict:
    out = gen.planted_classes(data, g)
    src, dst = out['edge_index']
    n = out['num_nodes']
    key = np.unique(np.concatenate([dst * n + src, src * n + dst]))
    out['edge_index'] = np.stack([key % n, key // n])
    return out


features = gen.class_features
