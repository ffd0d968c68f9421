"""The port's fused-projection rank aggregation against the JAX package's
`fsw_rank_aggregate_proj` (its Pallas kernel in interpret mode).

Tolerances:
  * float64: rtol 1e-10.  Both sides compute the same expressions in the
    same order up to the projection's summation order.
  * float32: |port - jax| <= 2e-5 * max|jax| + 1e-5 * |jax|.  The JAX
    float32 path evaluates sin/cos with its own degree-13 polynomial
    (about 1.6 ulp), the port with libm; both projections round
    differently.  Each output is a signed sum of B terms of the row's
    scale, so the error is bounded relative to the largest output.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fsw_gnn_tpu.ops.fsw_rank_pallas import \
    fsw_rank_aggregate_proj as jax_rank_proj
from fsw_gnn_tpu_torch.ops.fsw_rank import (fsw_rank_aggregate_proj,
                                            fsw_rank_aggregate_proj_plain)


def _args(rng, R, B, D, S, uniform_w):
    """Ties (identical sender rows), zero-weight padding, an f = 0 slice
    and one high 'spread'-range frequency."""
    Z = rng.standard_normal((R, B, D))
    Z[:, 1::4, :] = Z[:, 0::4, :]
    V = rng.standard_normal((D, S))
    real = rng.random((R, B)) < 0.7
    real[:, 0] = True
    if uniform_w:
        w = real.astype(np.float64)
    else:
        w = np.abs(rng.standard_normal((R, B))) * real
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    wn = w / wsp[:, None]
    pad = np.maximum(1.0 - w_sum, 0.0) / wsp
    freqs = np.abs(rng.standard_normal(S)) + 0.1
    freqs[1] = 0.0
    freqs[-1] = 2.0 * S - 1.0
    return Z, wn, pad, freqs, V


def _jax(args, uniform_w):
    out = jax_rank_proj(*(jnp.asarray(a) for a in args), None, True, False,
                        uniform_w)
    return np.asarray(out)


def _port(args, uniform_w):
    out = fsw_rank_aggregate_proj(*(torch.from_numpy(a) for a in args),
                                  uniform_w=uniform_w)
    return out.numpy()


@pytest.mark.parametrize('B', [8, 24, 32, 64])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank_proj_f64_matches_jax(B, uniform_w):
    rng = np.random.default_rng(B)
    args = _args(rng, 9, B, 5, 20, uniform_w)
    np.testing.assert_allclose(_port(args, uniform_w),
                               _jax(args, uniform_w), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize('B', [8, 32])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank_proj_f32_matches_jax(B, uniform_w):
    rng = np.random.default_rng(100 + B)
    args = tuple(a.astype(np.float32)
                 for a in _args(rng, 13, B, 7, 30, uniform_w))
    want = _jax(args, uniform_w)
    got = _port(args, uniform_w)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-5 * np.abs(want).max())


def test_zero_weight_entries_contribute_nothing():
    """Moving the projections of zero-weight entries changes nothing, with
    and without uniform_w (their sin(pi f w) must be exactly 0)."""
    rng = np.random.default_rng(3)
    for unif in (False, True):
        Z, wn, pad, freqs, V = _args(rng, 6, 16, 4, 10, unif)
        dead = wn == 0
        assert dead.any()
        Z2 = Z.copy()
        Z2[dead] += 3.0
        a = _port((Z, wn, pad, freqs, V), unif)
        b = _port((Z2, wn, pad, freqs, V), unif)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_plain_version_differentiable_matches_jax_grads():
    """On the CPU the plain version is differentiable by autograd; its
    gradients match the JAX kernel's analytic backward (float64)."""
    import jax
    rng = np.random.default_rng(4)
    args = _args(rng, 5, 8, 3, 6, False)
    G = rng.standard_normal((5, 6))

    def jloss(*a):
        return jnp.sum(jax_rank_proj(*a, None, True, True, False) * G)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (fsw_rank_aggregate_proj(*ts) * torch.from_numpy(G)).sum().backward()
    for t, w, name in zip(ts, want, ['dZ', 'dwn', 'dpad', 'dfreqs', 'dV']):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


def test_cpu_wrapper_is_plain_version():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a.astype(np.float32))
            for a in _args(rng, 4, 8, 3, 6, True)]
    before = fsw_rank_aggregate_proj.launches
    a = fsw_rank_aggregate_proj(*args, uniform_w=True)
    b = fsw_rank_aggregate_proj_plain(*args, uniform_w=True)
    assert torch.equal(a, b)
    assert fsw_rank_aggregate_proj.launches == before   # no kernel on CPU


def test_other_devices_raise():
    args = [torch.zeros(s, device='meta') for s in
            [(2, 8, 3), (2, 8), (2,), (4,), (3, 4)]]
    with pytest.raises(ValueError, match='unsupported device'):
        fsw_rank_aggregate_proj(*args)
