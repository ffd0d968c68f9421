"""Carry the JAX package's FSWConv or FSWGNN variables into the port.

The JAX package keeps a module's variables in collections: 'params'
(learnable), 'fsw_fixed' (non-learnable embedding parameters) and
'batch_stats' (BatchNorm running statistics).  Given them as nested dicts
of numpy arrays, `fswconv_from_jax` / `fswgnn_from_jax` build the port
module with the same constructor arguments and copy every array in.  Flax
`Dense.kernel` (in, out) becomes `Linear.weight` (out, in).

This is how the tests make the two packages compute the same function:
their random initializers draw different numbers from the same seed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .conv import FSWConv
from .device import resolve_device
from .models.gnn import FSWGNN


def _flatten(tree: Mapping, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _targets(conv: FSWConv) -> dict:
    """(collection-free JAX path) -> (tensor, transpose?) for every array
    of the port module."""
    t = {}
    emb = conv.fsw_embed
    for name in ('proj_vecs', 'freqs', 'bias', 'total_mass_scale'):
        if hasattr(emb, name):
            t[('fsw_embed', name)] = (getattr(emb, name), False)
    head = conv.head
    for i, layer in enumerate(head.dense):
        t[('head', f'dense_{i}', 'kernel')] = (layer.weight, True)
        if layer.bias is not None:
            t[('head', f'dense_{i}', 'bias')] = (layer.bias, False)
    for key, bn in head.bn.items():
        name = 'bn_final' if key == 'final' else f'bn_{key}'
        t[('head', name, 'scale')] = (bn.weight, False)
        t[('head', name, 'bias')] = (bn.bias, False)
        t[('head', name, 'mean')] = (bn.running_mean, False)
        t[('head', name, 'var')] = (bn.running_var, False)
    return t


def _collections(variables: Mapping) -> dict:
    """(path -> array) over the three collections; a path in two of them
    raises."""
    leaves = {}
    for coll in ('params', 'fsw_fixed', 'batch_stats'):
        for path, arr in _flatten(variables.get(coll, {})).items():
            if path in leaves:
                raise ValueError(f'{"/".join(path)} appears in two '
                                 f'collections')
            leaves[path] = arr
    return leaves


def _load(targets: dict, leaves: dict):
    """Copy every array into its place; every array must find its place
    and every place an array, or this raises."""
    missing = sorted('/'.join(p) for p in targets if p not in leaves)
    extra = sorted('/'.join(p) for p in leaves if p not in targets)
    if missing or extra:
        raise ValueError(f'variables do not match the module: missing '
                         f'{missing}, unexpected {extra}')
    with torch.no_grad():
        for path, (tensor, transpose) in targets.items():
            arr = leaves[path].T if transpose else leaves[path]
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f'{"/".join(path)}: shape {arr.shape} '
                                 f'!= {tuple(tensor.shape)}')
            tensor.copy_(torch.from_numpy(np.array(arr, order='C')))


def fswconv_from_jax(variables: Mapping, *, device=None, dtype=torch.float32,
                     **conv_kwargs) -> FSWConv:
    """A port FSWConv on `device` (None: the card) holding the JAX
    FSWConv's variables.

    `variables`: {'params': ..., 'fsw_fixed': ..., ['batch_stats': ...]}
    as nested dicts of numpy arrays (e.g. `jax.tree_util.tree_map(
    np.asarray, variables)` of `FSWConv.init`).  `conv_kwargs` are the
    JAX module's constructor arguments.  The port module is built with
    minimize_slice_coherence=False, since the only effect of that flag is
    on the initial slice vectors, which are replaced here.  Every array
    must find its place and every place an array, or this raises."""
    device = resolve_device(device)
    conv_kwargs = dict(conv_kwargs, minimize_slice_coherence=False)
    conv = FSWConv(dtype=dtype, device='cpu', **conv_kwargs)
    _load(_targets(conv), _collections(variables))
    return conv.to(device)


def fswgnn_from_jax(variables: Mapping, *, device=None, dtype=torch.float32,
                    **gnn_kwargs) -> FSWGNN:
    """A port FSWGNN on `device` (None: the card) holding the JAX FSWGNN's
    variables: each 'conv_{i}' subtree goes into `convs[i]` as
    `fswconv_from_jax` places it.  `gnn_kwargs` are the JAX module's
    constructor arguments (minimize_slice_coherence is set False, as
    there)."""
    device = resolve_device(device)
    gnn_kwargs = dict(gnn_kwargs, minimize_slice_coherence=False)
    gnn = FSWGNN(dtype=dtype, device='cpu', **gnn_kwargs)
    targets = {}
    for i, conv in enumerate(gnn.convs):
        for path, t in _targets(conv).items():
            targets[(f'conv_{i}',) + path] = t
    _load(targets, _collections(variables))
    return gnn.to(device)
