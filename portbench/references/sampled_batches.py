"""Reference of a neighbour-sampled minibatch cell: the first training
steps, each on the batch the program's sampler drew for it.

Each batch is rebuilt from the seed by the frozen copy of the program's
sampler (`portbench/sampler.py`): the train nodes' permutation, the hops'
draws and the local ids.  A step is `reference.py`'s on the batch's real
nodes (its node ids' features, its edges with duplicates merged), the loss
the configuration's over the batch's seeds, the first `num_seeds` local
ids.  Plain PyTorch in `ar`'s arithmetic; nothing of the program.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench import reference
from portbench.gen import SEED_MASK
from portbench.sampler import Sampler, epoch_batches


def batches(cfg: dict, inputs: dict, n_steps: int, dtype):
    """(graph, features, data) of the first `n_steps` batches."""
    train = cfg['train']
    seed = inputs['seed'] & SEED_MASK
    dev = inputs['features'].device
    sampler = Sampler(inputs['edge_index'], inputs['num_nodes'],
                      train['fanouts'], seed)
    labels = torch.as_tensor(inputs['labels'], device=dev)
    train_nodes = np.nonzero(inputs['train_mask'])[0]
    for b in itertools.islice(epoch_batches(sampler, train_nodes,
                                            int(train['batch_size']), seed),
                              n_steps):
        ids = torch.as_tensor(b['node_ids'], device=dev)
        mask = torch.zeros(len(ids), dtype=dtype, device=dev)
        mask[:b['num_seeds']] = 1.0
        yield (reference.Graph(b['edge_index'], len(ids), dev),
               inputs['features'][ids].to(dtype),
               {'labels': labels[ids], 'train_mask': mask})


def train_steps(cfg: dict, inputs: dict, n_steps: int, ar, wl: dict) -> dict:
    return reference.steps_on(cfg, inputs,
                              batches(cfg, inputs, n_steps, ar.dtype), ar,
                              wl.get('reference_slice_block'))
