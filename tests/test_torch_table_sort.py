"""Kernel A1's plain version (fsw_gnn_tpu_torch/benchmarks/attic/fsw_table.py)
against the JAX attic kernel `fsw_table_forward(..., interpret=True)`
(benchmarks/attic/fsw_table_pallas.py, loaded by path as its own test does)
and against JAX's `fsw_embed_table`, on the attic test's two setups and the
same numpy inputs.

Tolerance: rtol 2e-5, atol 2e-6, the attic test's own: both sides compute
in float32 and differ in the cumsum's order (the TPU kernel doubles, the
plain version adds in order) and in the trig's rounding.  The network is
the same, so the sorted pairs agree exactly, ties included.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fsw_gnn_tpu import (FSWConfig, from_edge_index, fsw_embed_table,
                         to_neighbor_table)
from fsw_gnn_tpu.embedding import lowclamp
from fsw_gnn_tpu_torch.benchmarks.attic import fsw_table as A1
from fsw_gnn_tpu_torch.kernels import KernelError

_ATTIC = (Path(__file__).resolve().parent.parent / 'benchmarks' / 'attic'
          / 'fsw_table_pallas.py')
_spec = importlib.util.spec_from_file_location('_fsw_table_pallas', _ATTIC)
JA1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JA1)


def _setup(rng, n=64, d_in=8, S=16, B=16, p=0.15):
    """The attic test's `_setup`, returning numpy inputs."""
    A = rng.random((n, n)) < p
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    g = from_edge_index(np.stack([src, dst]), n, dtype=jnp.float32)
    t = to_neighbor_table(g, bucket_size=B)
    X = jnp.asarray(rng.standard_normal((n, d_in)), jnp.float32)
    cfg = FSWConfig(d_in=d_in, d_out=S, enable_bias=False)
    proj = rng.standard_normal((S, d_in))
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    proj = jnp.asarray(proj, jnp.float32)
    freqs = jnp.abs(jnp.asarray(rng.standard_normal(S), jnp.float32)) + 0.2
    w_sum = t.weight.sum(axis=1)
    w_sum_padded = lowclamp(w_sum, cfg.total_mass_pad_thresh)
    pad_norm = lowclamp(cfg.total_mass_pad_thresh - w_sum, 0.0) / w_sum_padded
    wn = t.weight / w_sum_padded[:, None]
    Xp = X @ proj.T
    return t, X, cfg, proj, freqs, wn, pad_norm, Xp


@pytest.mark.parametrize('seed,n,S,B,p,tile', [(2, 64, 16, 16, 0.15, 8),
                                               (3, 128, 32, 32, 0.1, 16)])
def test_plain_matches_the_jax_attic_kernel_and_table_path(seed, n, S, B, p,
                                                           tile):
    rng = np.random.default_rng(seed)
    t, X, cfg, proj, freqs, wn, pad_norm, Xp = _setup(rng, n=n, S=S, B=B,
                                                      p=p)
    want_kernel = np.asarray(JA1.fsw_table_forward(
        t.idx, wn, pad_norm, Xp, freqs, tile_r=tile, tile_s=tile,
        interpret=True))
    want_table = np.asarray(fsw_embed_table(X, t, proj, freqs, cfg))
    args = [torch.from_numpy(np.array(a)) for a in
            (t.idx, wn, pad_norm, Xp, freqs)]
    got = A1.fsw_table_forward_plain(*args).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, want_table, rtol=2e-5, atol=2e-6)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(A1.fsw_table_forward(*args).numpy(), got)


@pytest.mark.parametrize('B', [2, 8, 16, 64])
def test_network_sorts_and_keeps_the_pairs_as_jax(B):
    """Random keys: sorted, and the weights follow their keys; coarse
    integer keys (many ties): the (p, w) arrays are JAX's network's exactly
    and the multiset of pairs is kept."""
    rng = np.random.default_rng(B)
    x = rng.standard_normal((5, B, 3)).astype(np.float32)
    w = rng.standard_normal((5, B, 3)).astype(np.float32)
    ps, ws = A1.sort_pairs_plain(torch.from_numpy(x), torch.from_numpy(w))
    order = np.argsort(x, axis=1, kind='stable')
    np.testing.assert_array_equal(ps.numpy(),
                                  np.take_along_axis(x, order, axis=1))
    np.testing.assert_array_equal(ws.numpy(),
                                  np.take_along_axis(w, order, axis=1))
    xt = rng.integers(0, 3, (4, B, 2)).astype(np.float32)
    wt = rng.standard_normal((4, B, 2)).astype(np.float32)
    jp, jw = JA1._sort_pairs_along_b(jnp.asarray(xt), jnp.asarray(wt))
    tp, tw = A1.sort_pairs_plain(torch.from_numpy(xt), torch.from_numpy(wt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for r in range(4):
        for s in range(2):
            assert sorted(zip(xt[r, :, s], wt[r, :, s])) == sorted(
                zip(tp[r, :, s].tolist(), tw[r, :, s].tolist()))


def test_width_rules():
    """A width that is not a power of two raises before any work, on the
    CPU too; the register network holds B up to 1024 and refuses 2048."""
    P = torch.zeros((2, 12, 4))
    with pytest.raises(KernelError, match='power of two'):
        A1.fsw_table_sort(P, torch.zeros((2, 12)), torch.zeros(2),
                          torch.ones(4))
    from fsw_gnn_tpu_torch.ops.fsw_rank import table_sort_lanes
    for B in (2, 8, 64, 256, 512, 1024):
        assert table_sort_lanes(B) > 0
        A1._width_fits(B)
    assert table_sort_lanes(2048) == 0
    with pytest.raises(KernelError, match='1024'):
        A1._width_fits(2048)
