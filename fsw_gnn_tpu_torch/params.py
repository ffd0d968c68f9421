"""Embedding parameter generation on an explicit `torch.Generator`.

Counterpart of `fsw_gnn_tpu/params.py`: slice vectors are drawn N(0, 1)
and row-normalized, frequencies follow one of four schemes, the bias
starts at zero.  Values are drawn in float64 on the CPU (so a seed gives
the same parameters on every device), then cast and moved.  The two
packages draw different numbers from the same seed; the bridge
(`bridge.py`) carries one package's parameters into the other.
"""
from __future__ import annotations

import numbers
from typing import Tuple

import torch

from .embedding import FSWConfig


def generate_proj_vecs(generator: torch.Generator, cfg: FSWConfig,
                       dtype=torch.float32, device='cpu') -> torch.Tensor:
    """Row-normalized random slice vectors, (nSlices, d_in + d_edge)."""
    if cfg.minimize_slice_coherence and cfg.nSlices > 1 and cfg.proj_dim > 0:
        raise NotImplementedError(
            'minimize_slice_coherence=True needs the coherence minimizer '
            '(ops/coherence.py, item 9 in ROADMAP.md), which is not ported '
            'yet: pass minimize_slice_coherence=False, or carry trained '
            'weights across with bridge.fswconv_from_jax')
    V = torch.randn((cfg.nSlices, cfg.proj_dim), generator=generator,
                    dtype=torch.float64)
    V = V / torch.linalg.norm(V, dim=1, keepdim=True)
    return V.to(device=device, dtype=dtype)


def generate_freqs(generator: torch.Generator, cfg: FSWConfig,
                   dtype=torch.float32, device='cpu') -> torch.Tensor:
    """Frequency initialization: a constant, an equispaced interval,
    'random' (i.i.d. with density 1/(1+x)^2, sorted) or 'spread' (the
    equi-probability quantiles of that density)."""
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
