"""`segcumsum_rows` (kernel K3's row form, fsw_gnn_tpu_torch/ops/segcumsum.py)
and its gradient against the JAX package: each row of a (rows, m) array is
scanned on its own over one is_end mask (m,) that every row shares, which
is `jax.vmap` of the flat restart scan over the rows (the JAX CSR path maps
its slices so, fsw_gnn_tpu/embedding.py).  On the CPU the row form runs its
plain version, as the kernel's wrapper does for CPU tensors.

Tolerances, as tests/test_torch_segment.py: 1e-12 in float64 against
`segment_cumsum` (both restart at every segment and differ only in
summation order); 2e-5 (rtol and atol) in float32 against `segcumsum_pallas`
in interpret mode, on nonnegative values (its mask kernel's contract).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsw_gnn_tpu.ops import segment as JS
from fsw_gnn_tpu.ops.segcumsum_pallas import (segcumsum_pallas,
                                              segment_boundaries as jsb)
from fsw_gnn_tpu_torch.ops import segment as TS
from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum_rows,
                                             segcumsum_rows_plain,
                                             segment_boundaries)

# jitted: the restart scan runs op by op for many seconds otherwise
_rows_jax = jax.jit(jax.vmap(JS.segment_cumsum, in_axes=(0, None)))


def _grad_jax(v, ids, g):
    return jax.jit(jax.grad(lambda x: jnp.sum(
        jax.vmap(JS.segment_cumsum, in_axes=(0, None))(x, ids) * g)))(v)


SHAPES = [(1, 1), (3, 17), (5, 600), (2, 4097), (7, 1000)]


@pytest.mark.parametrize('rows,m', SHAPES)
@pytest.mark.parametrize('nseg', [1, 40, 'singletons'])
def test_rows_and_gradient_match_vmapped_jax(rows, m, nseg):
    """float64 values and their gradient against jax.vmap of the restart
    scan over the rows."""
    rng = np.random.default_rng(rows * m)
    ids = (np.arange(m, dtype=np.int32) if nseg == 'singletons' else
           np.sort(rng.integers(0, nseg, m)).astype(np.int32))
    v, g = rng.standard_normal((rows, m)), rng.standard_normal((rows, m))
    mask = segment_boundaries(torch.from_numpy(ids))
    vt = torch.from_numpy(v).requires_grad_(True)
    out = segcumsum_rows(vt, mask)
    (out * torch.from_numpy(g)).sum().backward()
    want = np.asarray(_rows_jax(jnp.asarray(v), jnp.asarray(ids)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        vt.grad.numpy(), np.asarray(_grad_jax(jnp.asarray(v), jnp.asarray(
            ids), jnp.asarray(g))), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('rows,m,nseg', [(3, 128, 1), (4, 1000, 37),
                                         (2, 3000, 2), (3, 4096, 4096)])
def test_rows_match_vmapped_pallas_f32(rows, m, nseg):
    """Nonnegative float32 values against the JAX mask kernel in interpret
    mode, vmapped over the rows, each package's mask from its own
    segment_boundaries."""
    rng = np.random.default_rng(m + nseg)
    ids = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    v = np.abs(rng.standard_normal((rows, m))).astype(np.float32)
    mask = np.asarray(jsb(jnp.asarray(ids)))
    tmask = segment_boundaries(torch.from_numpy(ids))
    np.testing.assert_array_equal(tmask.numpy(), mask)
    want = jax.vmap(lambda x: segcumsum_pallas(
        x, None, interpret=True, nonnegative=True,
        boundaries=jnp.asarray(mask)))(jnp.asarray(v))
    got = segcumsum_rows(torch.from_numpy(v), tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize('shape', [(300, 7), (200, 2, 3), (1, 5)])
def test_segment_cumsum_columns_and_gradient_match_jax(shape):
    """segment_cumsum's multi-column branch (the row form over its columns)
    and its gradient against JAX's, float64."""
    rng = np.random.default_rng(len(shape) + shape[0])
    n = shape[0]
    ids = np.sort(rng.integers(0, 20, n)).astype(np.int32)
    v, g = rng.standard_normal(shape), rng.standard_normal(shape)
    vt = torch.from_numpy(v).requires_grad_(True)
    out = TS.segment_cumsum(vt, torch.from_numpy(ids))
    (out * torch.from_numpy(g)).sum().backward()
    fn = jax.jit(lambda x: JS.segment_cumsum(x, jnp.asarray(ids)))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(fn(jnp.asarray(v))), rtol=1e-12,
                               atol=1e-12)
    want = jax.jit(jax.grad(lambda x: jnp.sum(fn(x) * g)))(jnp.asarray(v))
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_rows_refuse_bad_arguments():
    mask = torch.ones(5, dtype=torch.int8)
    with pytest.raises(ValueError, match='rows, m'):
        segcumsum_rows(torch.zeros(5), mask)
    with pytest.raises(ValueError, match='mask entries'):
        segcumsum_rows(torch.zeros(2, 4), mask)
    with pytest.raises(ValueError, match='rows, m'):
        segcumsum_rows_plain(torch.zeros(2, 2, 5), mask)
