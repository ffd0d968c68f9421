"""Functions for `launch.launch` to run on every rank of a CPU process
group (gloo): the distributed forward, train step, overlapped embedding,
data-parallel step and epoch, and the Trainer with checkpoints.  Each
takes plain values (numpy arrays, dicts of them), builds what it needs on
its rank and returns numpy results, so a test can hold every rank's
result against a reference computed elsewhere.

A `case` names a graph ('edge_index', 'n', optional 'edge_feat'), the
float type ('dtype': 'float32' or 'float64'), the model's constructor
arguments ('model') and the JAX-layout variables to carry in ('variables',
as `bridge.fswgnn_from_jax` takes them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Graph, from_edge_index
from .dist import make_distributed_forward, make_distributed_train_step
from .dp import make_dp_train_step
from .partition import (local_graph, partition_graph, shard_node_features,
                        shard_recipient_labels)
from .runtime import make_graph_mesh


def _np(t):
    return t.detach().cpu().numpy()


def _graph(case):
    return from_edge_index(case['edge_index'], case['n'],
                           edge_features=case.get('edge_feat'),
                           dtype=np.dtype(case['dtype']))


def _model(case):
    from ..bridge import fswgnn_from_jax
    return fswgnn_from_jax(case['variables'], device='cpu',
                           dtype=getattr(torch, case['dtype']),
                           **case['model'])


def _state(model):
    """(gradients by parameter name, BatchNorm running statistics by
    buffer name)."""
    grads = {k: _np(p.grad) for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: _np(b) for k, b in model.named_buffers()
             if k.endswith(('running_mean', 'running_var'))}
    return grads, stats


def graph_cases(cases):
    """Every case on this rank: kind 'forward' (eval-mode logits of the
    exchange), 'step' (one SGD(1.0) step of make_distributed_train_step:
    the loss, the summed gradients and the running statistics after it)
    'overlap_embed' (`fsw_embed_local_overlap` with the chunked
    all-gather, forward and the gradients of sum(out * G)) or 'pipelined'
    (`make_overlapped_forward` on one table a shard).  Returns one
    dict a case; rows are this rank's (R_shard, ...) rows."""
    mesh = make_graph_mesh(device='cpu')
    return [_CASES[c['kind']](c, mesh) for c in cases]


def _forward(case, mesh):
    g = _graph(case)
    shards = partition_graph(g, mesh.size, layout=case.get('layout', 'auto'))
    model = _model(case).eval()
    Xs = shard_node_features(case['X'], shards)
    fwd = make_distributed_forward(model, shards, mesh,
                                   exchange=case['exchange'],
                                   overlap_chunks=case.get('chunks', 4))
    with torch.no_grad():
        out = fwd(torch.as_tensor(Xs[mesh.rank]))
    return {'rows': _np(out)}


def _step(case, mesh):
    g = _graph(case)
    shards = partition_graph(g, mesh.size, layout=case.get('layout', 'auto'))
    model = _model(case)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=1.0)
    step = make_distributed_train_step(model, opt, shards, mesh,
                                       exchange=case['exchange'],
                                       overlap_chunks=case.get('chunks', 4))
    Xs = shard_node_features(case['X'], shards)
    labels, mask = shard_recipient_labels(case['y'], case['mask'], shards)
    loss = step(torch.as_tensor(Xs[mesh.rank]),
                torch.as_tensor(labels[mesh.rank]).long(),
                torch.as_tensor(mask[mesh.rank]).to(
                    getattr(torch, case['dtype'])))
    grads, stats = _state(model)
    return {'loss': float(loss), 'grads': grads, 'stats': stats}


def _overlap_embed(case, mesh):
    from ..embedding import FSWConfig
    from .collectives import start_all_gather
    from .overlap import fsw_embed_local_overlap
    dt = getattr(torch, case['dtype'])
    cfg = FSWConfig(**case['cfg'])
    shards = partition_graph(_graph(case), mesh.size)
    g = local_graph(shards, mesh.rank).to('cpu')
    X = torch.as_tensor(shard_node_features(case['X'], shards)[mesh.rank])
    G = torch.as_tensor(shard_node_features(case['G'], shards)[mesh.rank])
    X.requires_grad_(True)
    proj = torch.tensor(case['proj'], dtype=dt, requires_grad=True)
    freqs = torch.tensor(case['freqs'], dtype=dt, requires_grad=True)
    out = fsw_embed_local_overlap(
        X, g, proj, freqs, cfg,
        proj_gather_fn=start_all_gather,
        n_chunks=case['chunks'], aggregate=case.get('aggregate', 'auto'))
    torch.sum(out * G).backward()
    return {'rows': _np(out), 'dX': _np(X.grad), 'dproj': _np(proj.grad),
            'dfreqs': _np(freqs.grad)}


def _pipelined(case, mesh):
    from ..embedding import FSWConfig
    from .overlap import make_overlapped_forward
    dt = getattr(torch, case['dtype'])
    shards = partition_graph(_graph(case), mesh.size, layout='table')
    fwd = make_overlapped_forward(
        shards, mesh, FSWConfig(**case['cfg']),
        torch.tensor(case['proj'], dtype=dt),
        torch.tensor(case['freqs'], dtype=dt), n_chunks=case['chunks'])
    X = torch.as_tensor(shard_node_features(case['X'], shards)[mesh.rank])
    return {'rows': _np(fwd(X))}


_CASES = {'forward': _forward, 'step': _step,
          'overlap_embed': _overlap_embed, 'pipelined': _pipelined}


def dp_step(case, batches):
    """One SGD(1.0) step of make_dp_train_step on this rank's batch of
    `batches` (one dict a rank: the Graph's fields, 'X', 'labels',
    'mask'): the wave's loss, the summed gradients and the running
    statistics after it."""
    mesh = make_graph_mesh(device='cpu')
    b = dict(batches[mesh.rank])
    X, labels, mask = b.pop('X'), b.pop('labels'), b.pop('mask')
    g = Graph(**b).to('cpu')
    model = _model(case)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=1.0)
    step = make_dp_train_step(model, opt, mesh)
    loss = step(g, torch.as_tensor(X), torch.as_tensor(labels).long(),
                torch.as_tensor(mask))
    grads, stats = _state(model)
    return {'loss': float(loss), 'grads': grads, 'stats': stats}


def dp_epoch(data_kwargs, config, batch_size, fanouts):
    """One epoch of MinibatchTrainer(num_devices=world) on the CPU, the
    sampler on its numpy path (no rank builds the native helper): the
    batches this rank built (the Graph's fields, its node ids' features,
    labels and mask, as numpy), the epoch's loss and the model's state
    after it."""
    from ..data import sampler as sampler_mod
    from ..data.datasets import synthetic_planted_partition
    from ..train import MinibatchTrainer, TrainConfig
    sampler_mod._LIB, sampler_mod._LIB_TRIED = None, True
    mesh = make_graph_mesh(device='cpu')
    data = synthetic_planted_partition(**data_kwargs)
    tr = MinibatchTrainer(data, TrainConfig(**config, num_devices=mesh.size),
                          batch_size=batch_size, fanouts=tuple(fanouts),
                          device='cpu')
    built, real = [], tr._build_batch

    def build(seeds):
        out = real(seeds)
        g = out[0]
        built.append({'src': _np(g.src), 'dst': _np(g.dst),
                      'weight': _np(g.weight), 'row_ptr': _np(g.row_ptr),
                      'X': _np(out[1]), 'labels': _np(out[2]),
                      'mask': _np(out[3])})
        return out
    tr._build_batch = build
    loss = tr.train_epoch()
    return {'batches': built, 'loss': loss,
            'state': {k: _np(v) for k, v in tr.model.state_dict().items()}}


def trainer_fit(data_kwargs, config, runs):
    """`Trainer(num_devices=world).fit()` on the CPU once for each config
    override in `runs` (the same checkpoint_dir resumes): each run's
    history, the steps whose checkpoint this rank wrote, the epoch it
    resumed from (0: a fresh start), its final metrics and the model's
    state."""
    from ..data.datasets import synthetic_planted_partition
    from ..train import TrainConfig, Trainer
    mesh = make_graph_mesh(device='cpu')
    data = synthetic_planted_partition(**data_kwargs)
    out = []
    for over in runs:
        tr = Trainer(data, TrainConfig(**dict(config, **over),
                                       num_devices=mesh.size), device='cpu')
        written, write = [], tr._write_checkpoint

        def spy():
            written.append(tr.step_count)
            write()
        tr._write_checkpoint = spy
        res = tr.fit()
        out.append({'history': tr.history,
                    'written': written,
                    'resumed_from': tr.history[0]['epoch'] - 1
                    if tr.history else None,
                    'final': res['final'],
                    'state': {k: _np(v)
                              for k, v in tr.model.state_dict().items()}})
    return out


def mesh_refusal(num_devices):
    """The message of `make_graph_mesh(num_devices)` refusing this
    group's world size (None where it does not refuse)."""
    try:
        make_graph_mesh(num_devices, device='cpu')
    except RuntimeError as e:
        return str(e)
    return None


def tasks(tasks):
    """Several of this module's functions in one launch: `tasks` a list of
    (function name, keyword arguments); returns their results in order."""
    return [globals()[name](**kwargs) for name, kwargs in tasks]
