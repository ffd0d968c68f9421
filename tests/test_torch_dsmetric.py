"""The port's Sinkhorn dsmetric (ops/sinkhorn.py, utils/dsmetric.py)
against the JAX package's, in float64 with n_outer = 50.

Tolerances: the Sinkhorn projection within 1e-12 (the same log-domain
steps; logsumexp rounds alike up to summation order); the solver's
objective and S within rtol 1e-9 (fifty mirror-descent steps of those
projections, the gradient in closed form on the port's side and by
autodiff on JAX's: the same function, rounded in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fsw_gnn_tpu.ops.sinkhorn import dsmetric_batched as jax_batched
from fsw_gnn_tpu.ops.sinkhorn import dsmetric_solve as jax_solve
from fsw_gnn_tpu.ops.sinkhorn import sinkhorn_project as jax_project
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch.ops.sinkhorn import (_objective, _objective_grad,
                                            dsmetric_batched, dsmetric_solve,
                                            sinkhorn_project)

N_OUTER = 50


def _rand_graph(rng, n, d, p=0.4):
    A = (rng.random((n, n)) < p).astype(np.float64)
    np.fill_diagonal(A, 0)
    A = np.maximum(A, A.T)
    return A, rng.standard_normal((n, d))


def _pair(seed, n=8, d=3):
    rng = np.random.default_rng(seed)
    return _rand_graph(rng, n, d) + _rand_graph(rng, n, d)


@pytest.mark.parametrize('shape', [(7, 7), (3, 6, 6)])
def test_sinkhorn_project_matches_jax(shape):
    logS = np.random.default_rng(0).standard_normal(shape) * 3
    got = sinkhorn_project(torch.from_numpy(logS), 40).numpy()
    if len(shape) == 2:
        want = np.asarray(jax_project(jnp.asarray(logS), 40))
    else:
        want = np.stack([np.asarray(jax_project(jnp.asarray(x), 40))
                         for x in logS])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the columns, normalized last, sum to one
    np.testing.assert_allclose(got.sum(-2), 1.0, atol=1e-12)


@pytest.mark.parametrize('squared', [False, True])
def test_objective_gradient_is_the_objectives(squared):
    """The closed-form gradient against autograd of the objective."""
    rng = np.random.default_rng(1)
    A1, V1, A2, V2 = (torch.from_numpy(a) for a in _pair(1))
    D = torch.cdist(V1, V2)
    S = torch.from_numpy(rng.random((8, 8))).requires_grad_(True)
    args = (A1, A2, D, 0.7, squared, 1e-12)
    _objective(S, *args).backward()
    np.testing.assert_allclose(_objective_grad(S.detach(), *args).numpy(),
                               S.grad.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize('squared', [False, True])
def test_dsmetric_solve_matches_jax(squared):
    A1, V1, A2, V2 = _pair(2)
    kw = dict(lambda_features=0.8, use_squared_dists=squared,
              n_outer=N_OUTER, return_S=True)
    want_obj, want_S = jax_solve(*(jnp.asarray(a) for a in (A1, V1, A2, V2)),
                                 **kw)
    obj, S = dsmetric_solve(A1, V1, A2, V2, device='cpu',
                            dtype=torch.float64, **kw)
    assert obj.dtype == S.dtype == torch.float64
    np.testing.assert_allclose(obj.item(), float(want_obj), rtol=1e-9)
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S), rtol=1e-9,
                               atol=1e-12)


def test_dsmetric_batched_matches_jax():
    pairs = [_pair(10 + k, n=6, d=2) for k in range(4)]
    A1, V1, A2, V2 = (np.stack(x) for x in zip(*pairs))
    want = np.asarray(jax_batched(*(jnp.asarray(a) for a in
                                    (A1, V1, A2, V2)), n_outer=N_OUTER))
    got = dsmetric_batched(A1, V1, A2, V2, n_outer=N_OUTER, device='cpu',
                           dtype=torch.float64)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    one = [dsmetric_solve(*p, n_outer=N_OUTER, device='cpu',
                          dtype=torch.float64).item() for p in pairs]
    np.testing.assert_allclose(got.numpy(), one, rtol=1e-12)


def test_dsmetric_matches_jax_and_rejects_shape_mismatch():
    from fsw_gnn_tpu.utils import dsmetric as jax_dsmetric
    A1, V1, A2, V2 = _pair(5)
    want, want_S = jax_dsmetric(A1, V1, A2, V2, return_S=True,
                                n_outer=N_OUTER, dtype=jnp.float64)
    got, S = T.dsmetric(A1, V1, A2, V2, return_S=True, n_outer=N_OUTER,
                        dtype=torch.float64, device='cpu')
    assert isinstance(got, float) and isinstance(S, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(S, want_S, rtol=1e-9, atol=1e-12)
    rng = np.random.default_rng(5)
    B1, W1 = _rand_graph(rng, 5, 2)
    B2, W2 = _rand_graph(rng, 6, 2)
    with pytest.raises(ValueError, match='number of nodes'):
        T.dsmetric(B1, W1, B2, W2, device='cpu')
    with pytest.raises(ValueError, match='Feature dimensions'):
        T.dsmetric(B1, W1, B1, W1[:, :1], device='cpu')


def test_demo_pair_isomorphic_near_zero_random_positive():
    """examples/demo_dsmetric.py's graphs: an isomorphic copy comes out
    near zero, an unrelated graph clearly positive."""
    rng = np.random.default_rng(0)
    n, d = 12, 4
    A1 = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(A1, 0)
    A1 = np.maximum(A1, A1.T)
    V1 = rng.standard_normal((n, d))
    P = np.eye(n)[rng.permutation(n)]
    A2, V2 = P @ A1 @ P.T, P @ V1
    A3 = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(A3, 0)
    A3 = np.maximum(A3, A3.T)
    V3 = rng.standard_normal((n, d))
    d_iso = T.dsmetric(A1, V1, A2, V2, dtype=torch.float64, device='cpu')
    d_rand = T.dsmetric(A1, V1, A3, V3, dtype=torch.float64, device='cpu')
    assert 0 <= d_iso < 1e-3 * d_rand, (d_iso, d_rand)
    assert d_rand > 1.0
