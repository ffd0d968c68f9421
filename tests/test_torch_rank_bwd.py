"""The port's backward of the fused-projection rank aggregation (the plain
version of kernel K1b, and the autograd Function around both directions)
against `jax.vjp` of the JAX package's `fsw_rank_aggregate_proj` (its
Pallas kernels in interpret mode).

Inputs (tests/test_torch_rank.py `_args`): tied projections (repeated
sender rows), zero-weight padding, an f = 0 slice and f = 2S - 1.

Tolerances, per output, relative to that output's largest entry:
  * float64: |port - jax| <= 1e-12 * max|jax| + 1e-10 * |jax|.  Both sides
    evaluate the same formulas; only summation orders differ (measured
    below 1e-15 of the scale).
  * float32: |port - jax| <= 1e-5 * max|jax| + 1e-4 * |jax|.  JAX's float32
    trig is its own degree-13 polynomial (about 1.6 ulp), the port's libm;
    each output is a signed sum of B (or B * S, R * B) terms of the
    output's scale (measured below 1e-6 of the scale).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsw_gnn_tpu.ops.fsw_rank_pallas import \
    fsw_rank_aggregate_proj as jax_rank_proj
from fsw_gnn_tpu_torch.ops.fsw_rank import (
    fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_bwd,
    fsw_rank_aggregate_proj_bwd_plain, fsw_rank_aggregate_proj_plain)
from test_torch_rank import _args

NAMES = ('dZ', 'dwn', 'dpad', 'df', 'dV')


def _jax_vjp(args, G, with_dw, uniform_w):
    _, vjp = jax.vjp(
        lambda *a: jax_rank_proj(*a, None, True, with_dw, uniform_w),
        *(jnp.asarray(a) for a in args))
    return [np.asarray(w) for w in vjp(jnp.asarray(G))]


def _port_bwd(args, G, with_dw, uniform_w):
    return fsw_rank_aggregate_proj_bwd_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(G),
        uniform_w=uniform_w, with_dw=with_dw)


def _close(got, want, rtol, atol_rel, name):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('with_dw', [False, True])
@pytest.mark.parametrize('uniform_w', [False, True])
@pytest.mark.parametrize('B', [8, 24])
def test_bwd_plain_matches_jax_vjp(dtype, with_dw, uniform_w, B):
    rng = np.random.default_rng(B)
    args = tuple(a.astype(dtype) for a in _args(rng, 9, B, 5, 20, uniform_w))
    G = rng.standard_normal((9, 20)).astype(dtype)
    want = _jax_vjp(args, G, with_dw, uniform_w)
    got = _port_bwd(args, G, with_dw, uniform_w)
    rtol, atol = (1e-10, 1e-12) if dtype == 'float64' else (1e-4, 1e-5)
    for g, w, name in zip(got, want, NAMES):
        if g is None:
            # with_dw=False: JAX returns zero cotangents, the port none
            assert name in ('dwn', 'dpad') and not with_dw
            assert not np.any(w), name
            continue
        assert g.dtype == getattr(torch, dtype)
        _close(g.numpy(), w, rtol, atol, name)


def test_zero_weight_entries_get_exactly_zero_dz():
    """Padded entries gather sender 0's (non-zero) row: their dZ must be
    exactly 0, or the scatter-add into dX corrupts sender 0."""
    rng = np.random.default_rng(7)
    for unif in (False, True):
        for dt in (np.float64, np.float32):
            args = tuple(a.astype(dt)
                         for a in _args(rng, 6, 16, 4, 10, unif))
            dead = args[1] == 0
            assert dead.any()
            G = rng.standard_normal((6, 10)).astype(dt)
            for with_dw in (False, True):
                dZ = _port_bwd(args, G, with_dw, unif)[0].numpy()
                assert np.all(dZ[dead] == 0.0)
                assert np.all(dZ[~dead].any(axis=-1))


@pytest.mark.parametrize('B', [8, 16])
def test_bwd_plain_matches_autograd_of_plain_forward(B):
    """float64: the analytic backward equals autograd through the plain
    forward (the mask is piecewise constant, so autograd differentiates
    the same almost-everywhere formula); rtol 1e-10."""
    rng = np.random.default_rng(30 + B)
    args = _args(rng, 7, B, 4, 12, False)
    G = rng.standard_normal((7, 12))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (fsw_rank_aggregate_proj_plain(*ts) * torch.from_numpy(G)).sum() \
        .backward()
    got = _port_bwd(args, G, True, False)
    for t, g, name in zip(ts, got, NAMES):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-10,
                                   atol=1e-12 * t.grad.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize('with_dw', [False, True])
def test_function_backward_is_plain_backward_on_cpu(with_dw):
    """On CPU tensors the autograd Function's backward is the plain
    backward, bit for bit; no kernel launches; with_dw=False gives wn and
    pad_norm no gradient."""
    rng = np.random.default_rng(11)
    args = _args(rng, 5, 8, 3, 9, True)
    G = torch.from_numpy(rng.standard_normal((5, 9)))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    before = (fsw_rank_aggregate_proj.launches,
              fsw_rank_aggregate_proj_bwd.launches)
    out = fsw_rank_aggregate_proj(*ts, uniform_w=True, with_dw=with_dw)
    (out * G).sum().backward()
    want = fsw_rank_aggregate_proj_bwd(
        *(torch.from_numpy(a) for a in args), G, uniform_w=True,
        with_dw=with_dw)
    for t, w, name in zip(ts, want, NAMES):
        if w is None:
            assert t.grad is None, name
        else:
            assert torch.equal(t.grad, w), name
    assert (fsw_rank_aggregate_proj.launches,
            fsw_rank_aggregate_proj_bwd.launches) == before


def test_function_honours_needs_input_grad():
    """Only the inputs that require grad get one; the forward output
    equals the plain forward."""
    rng = np.random.default_rng(12)
    args = [torch.from_numpy(a) for a in _args(rng, 4, 8, 3, 6, False)]
    Z = args[0].clone().requires_grad_(True)
    out = fsw_rank_aggregate_proj(Z, *args[1:])
    assert torch.equal(out.detach(), fsw_rank_aggregate_proj_plain(*args))
    out.sum().backward()
    assert Z.grad is not None and Z.grad.shape == Z.shape
    assert all(not a.requires_grad and a.grad is None for a in args[1:])


def test_bwd_other_devices_raise():
    args = [torch.zeros(s, device='meta') for s in
            [(2, 8, 3), (2, 8), (2,), (4,), (3, 4), (2, 4)]]
    with pytest.raises(ValueError, match='unsupported device'):
        fsw_rank_aggregate_proj_bwd(*args)
