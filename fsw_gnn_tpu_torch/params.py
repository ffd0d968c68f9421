"""Embedding parameter generation on an explicit `torch.Generator`.

Counterpart of `fsw_gnn_tpu/params.py`: slice vectors are drawn N(0, 1)
and row-normalized, frequencies follow one of four schemes, the bias
starts at zero.  Values are drawn in float64 on the CPU (so a seed gives
the same parameters on every device), then moved and cast; the slice
vectors' coherence minimizer runs on the target device in float64, before
the cast.  The two packages draw different numbers from the same seed; the
bridge (`bridge.py`) carries one package's parameters into the other.
"""
from __future__ import annotations

import numbers
from typing import Tuple

import torch

from .device import resolve_device
from .embedding import FSWConfig
from .ops.coherence import minimize_mutual_coherence


def generate_proj_vecs(generator: torch.Generator, cfg: FSWConfig,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Row-normalized random slice vectors, (nSlices, d_in + d_edge), on
    `device` (None: the card), coherence-minimized (in float64, on
    `device`) when cfg.minimize_slice_coherence."""
    device = resolve_device(device)
    V = torch.randn((cfg.nSlices, cfg.proj_dim), generator=generator,
                    dtype=torch.float64)
    V = (V / torch.linalg.norm(V, dim=1, keepdim=True)).to(device)
    if cfg.minimize_slice_coherence and cfg.nSlices > 1 and cfg.proj_dim > 0:
        V = minimize_mutual_coherence(V)
    return V.to(dtype)


def generate_freqs(generator: torch.Generator, cfg: FSWConfig,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Frequency initialization, on `device` (None: the card): a
    constant, an equispaced interval, 'random' (i.i.d. with density
    1/(1+x)^2, sorted) or 'spread' (the equi-probability quantiles of that
    density)."""
    device = resolve_device(device)
    f64 = torch.float64
    nF = cfg.nFreqs
    fi = cfg.freqs_init
    if nF == 0:
        freqs = torch.zeros((0,), dtype=f64)
    elif isinstance(fi, numbers.Real) and not isinstance(fi, bool):
        freqs = torch.full((nF,), float(fi), dtype=f64)
    elif isinstance(fi, tuple):
        a, b = float(fi[0]), float(fi[1])
        if a > b:
            raise ValueError(f'freqs_init interval {fi} is reversed')
        if nF == 1:
            freqs = torch.full((1,), a + (b - a) / 2, dtype=f64)
        else:
            freqs = a + (b - a) * (torch.arange(nF, dtype=f64) / (nF - 1))
    elif fi == 'random':
        u = torch.sort(torch.rand((nF,), generator=generator,
                                  dtype=f64)).values
        freqs = u / (1 - u)
    elif fi == 'spread':
        u = (0.5 + torch.arange(nF, dtype=f64)) / nF
        freqs = u / (1 - u)
    else:
        raise ValueError(f'invalid freqs_init {fi!r}')
    return freqs.to(device=device, dtype=dtype)


def bias_shape(cfg: FSWConfig) -> Tuple[int, ...]:
    """Shape of the embedding's bias."""
    if cfg.cartesian_mode and not cfg.collapse_freqs:
        return (cfg.nSlices, cfg.nFreqs)
    if cfg.cartesian_mode and cfg.collapse_freqs:
        return (cfg.nSlices * cfg.nFreqs + cfg.total_mass_dim,)
    return (cfg.nSlices + cfg.total_mass_dim,)


def generate_params(generator: torch.Generator, cfg: FSWConfig,
                    dtype=torch.float32, device=None) -> dict:
    """Every parameter of one FSW embedding, as a dict of tensors on
    `device` (None: the card): proj_vecs, freqs, and bias and
    total_mass_scale where the configuration has them.  The generator is
    drawn from in this order: the slice vectors first, then the
    frequencies."""
    device = resolve_device(device)
    params = {
        'proj_vecs': generate_proj_vecs(generator, cfg, dtype, device),
        'freqs': generate_freqs(generator, cfg, dtype, device),
    }
    if cfg.enable_bias:
        params['bias'] = torch.zeros(bias_shape(cfg), dtype=dtype,
                                     device=device)
    if cfg.encode_total_mass:
        params['total_mass_scale'] = torch.tensor(
            cfg.total_mass_encoding_scale, dtype=dtype, device=device)
    return params
