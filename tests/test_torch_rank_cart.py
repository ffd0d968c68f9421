"""The port's cartesian rank aggregation K4 (`fsw_rank_aggregate_cart`: the
forward and backward plain versions, and the custom ops on the CPU)
against the JAX package's `fsw_rank_aggregate_cart` (its Pallas kernels in
interpret mode) and `jax.vjp` of it.

Inputs: ties (every fourth entry repeats the one before it) or none,
zero-weight entries, rows whose total mass is below 1 (a phantom mass), a
'spread'-range frequency 2S - 1, and an (S, F) frequency matrix whose rows
differ from slice to slice or are all the same (the broadcast grid); an
f = 0 column where a test says so.

Tolerance: float64, rtol 1e-10, atol 1e-12 * each output's scale.  Both
sides compute the same expressions; only summation orders differ.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsw_gnn_tpu.ops.fsw_rank_pallas import \
    fsw_rank_aggregate_cart as jax_cart
from fsw_gnn_tpu_torch.ops.fsw_rank import (
    fsw_rank_aggregate_cart, fsw_rank_aggregate_cart_bwd,
    fsw_rank_aggregate_cart_bwd_plain, fsw_rank_aggregate_cart_plain)

NAMES = ('dP', 'dwn', 'dpad', 'df')


def _args(rng, R, B, S, F, ties=True, uniform_w=False, shared_rows=False,
          f_zero=False):
    P = rng.standard_normal((R, B, S))
    if ties:
        P[:, 1::4] = P[:, 0:B - 1:4]
    real = rng.random((R, B)) < 0.7
    real[:, 0] = True
    w = (real.astype(np.float64) * 0.3 if uniform_w
         else np.abs(rng.standard_normal((R, B))) * real * 0.4)
    w[::2] *= 0.1                   # light rows: a phantom mass
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    if shared_rows:
        freqs = np.broadcast_to(np.abs(rng.standard_normal(F)) * 2 + 0.1,
                                (S, F)).copy()
    else:
        freqs = np.abs(rng.standard_normal((S, F))) * 2 + 0.1
    freqs[-1, -1] = 2.0 * S - 1.0
    if f_zero:
        freqs[:, 1 % F] = 0.0
    return (P, w / wsp[:, None], np.maximum(1.0 - w_sum, 0.0) / wsp, freqs)


def _jax_fwd(args, uniform_w=False):
    return np.asarray(jax_cart(*(jnp.asarray(a) for a in args), None, True,
                               True, uniform_w))


def _jax_bwd(args, G, with_dw, uniform_w=False):
    _, vjp = jax.vjp(lambda *a: jax_cart(*a, None, True, with_dw, uniform_w),
                     *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(G))]


def _close(got, want, name=''):
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize('R,B,S,F', [(5, 8, 6, 3), (17, 16, 130, 5),
                                     (3, 32, 128, 9)])
@pytest.mark.parametrize('ties', [False, True])
def test_cart_f64_forward_matches_jax(R, B, S, F, ties):
    args = _args(np.random.default_rng(R + B + S + F), R, B, S, F, ties)
    assert (args[2] > 0).any() and (args[1] == 0).any()
    want = _jax_fwd(args)
    got = fsw_rank_aggregate_cart_plain(*(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == (R, S, F) == want.shape
    _close(got.numpy(), want)


def _port_grads(args, G, with_dw, uniform_w=False):
    """The gradients of sum(out * G) through the custom op on the
    CPU (the plain backward)."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fsw_rank_aggregate_cart(*ts, uniform_w=uniform_w, with_dw=with_dw)
    (out * torch.from_numpy(G)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _check_grads(got, want, with_dw):
    for g, w, name in zip(got, want, NAMES):
        if not with_dw and name in ('dwn', 'dpad'):
            # JAX gives zero cotangents, the port none at all
            assert g is None and not w.any(), name
            continue
        _close(g.numpy(), w, name)


@pytest.mark.parametrize('B', [16, 48])
@pytest.mark.parametrize('with_dw', [False, True])
@pytest.mark.parametrize('ties', [False, True])
def test_cart_f64_grads_match_jax(B, with_dw, ties):
    """dP, dwn, dpad and the (S, F) df through the K4 op against
    jax.vjp of the JAX kernel."""
    rng = np.random.default_rng(100 + B)
    R, S, F = 7, 10, 4
    args = _args(rng, R, B, S, F, ties)
    G = rng.standard_normal((R, S, F))
    _, got = _port_grads(args, G, with_dw)
    assert tuple(got[3].shape) == (S, F)
    _check_grads(got, _jax_bwd(args, G, with_dw), with_dw)


@pytest.mark.parametrize('with_dw', [False, True])
def test_cart_f64_f_zero_column_matches_jax(with_dw):
    """An f = 0 column takes the exact limit 2 w cos A, forward and every
    gradient; with the frequency rows shared by the slices."""
    rng = np.random.default_rng(3)
    args = _args(rng, 6, 13, 9, 3, shared_rows=True, f_zero=True)
    G = rng.standard_normal((6, 9, 3))
    out, got = _port_grads(args, G, with_dw)
    _close(out.numpy(), _jax_fwd(args))
    _check_grads(got, _jax_bwd(args, G, with_dw), with_dw)


def test_cart_f64_uniform_w_matches_jax():
    """uniform_w (row-constant weights): the forward, and the gradients
    without with_dw, the only case where the flag is honoured."""
    rng = np.random.default_rng(4)
    args = _args(rng, 9, 11, 12, 5, uniform_w=True)
    G = rng.standard_normal((9, 12, 5))
    got = fsw_rank_aggregate_cart_plain(*(torch.from_numpy(a) for a in args),
                                        uniform_w=True)
    _close(got.numpy(), _jax_fwd(args, uniform_w=True))
    _, grads = _port_grads(args, G, False, uniform_w=True)
    _check_grads(grads, _jax_bwd(args, G, False, uniform_w=True), False)


def test_cart_per_slice_rows_differ_from_a_shared_grid():
    """Per-slice frequency rows are honoured: each slice's output is the
    one its own row gives, equal to a call with that row shared by every
    slice; against JAX too."""
    rng = np.random.default_rng(5)
    P, wn, pad, freqs = _args(rng, 4, 8, 6, 3)
    assert not np.allclose(freqs[0], freqs[1])
    want = _jax_fwd((P, wn, pad, freqs))
    got = fsw_rank_aggregate_cart_plain(
        *(torch.from_numpy(a) for a in (P, wn, pad, freqs))).numpy()
    _close(got, want)
    for s in (0, 3):
        shared = np.broadcast_to(freqs[s], freqs.shape).copy()
        one = fsw_rank_aggregate_cart_plain(
            *(torch.from_numpy(a) for a in (P, wn, pad, shared))).numpy()
        _close(got[:, s], one[:, s])


def test_cart_zero_weight_padding_contributes_zero():
    """Five zero-weight entries with arbitrary projections appended to
    every row leave the output and the other entries' gradients as they
    were; their own dP is exactly 0 (and JAX agrees)."""
    rng = np.random.default_rng(6)
    R, B, S, F = 4, 8, 6, 3
    P, wn, pad, freqs = _args(rng, R, B, S, F)
    P2 = np.concatenate([P, 3.0 * rng.standard_normal((R, 5, S))], axis=1)
    wn2 = np.concatenate([wn, np.zeros((R, 5))], axis=1)
    G = torch.from_numpy(rng.standard_normal((R, S, F)))
    t = [torch.from_numpy(a) for a in (P, wn, pad, freqs)]
    t2 = [torch.from_numpy(a) for a in (P2, wn2, pad, freqs)]
    a = fsw_rank_aggregate_cart_plain(*t)
    b = fsw_rank_aggregate_cart_plain(*t2)
    torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-13)
    _close(b.numpy(), _jax_fwd((P2, wn2, pad, freqs)))
    ga = fsw_rank_aggregate_cart_bwd_plain(*t, G, with_dw=True)
    gb = fsw_rank_aggregate_cart_bwd_plain(*t2, G, with_dw=True)
    assert torch.all(gb[0][:, B:] == 0)
    torch.testing.assert_close(gb[0][:, :B], ga[0], rtol=1e-12, atol=1e-13)
    for x, y in zip(ga[2:], gb[2:]):                     # dpad, df
        torch.testing.assert_close(y, x, rtol=1e-11, atol=1e-13)


def test_cart_autograd_is_the_plain_backward():
    """On the CPU the custom op's forward and backward are the
    plain versions (no launch is counted), and only the inputs that need a
    gradient get one: without a weight gradient the with_dw loop is
    skipped."""
    rng = np.random.default_rng(8)
    args = [torch.from_numpy(a) for a in _args(rng, 5, 6, 9, 4, True,
                                               uniform_w=True)]
    G = torch.from_numpy(rng.standard_normal((5, 9, 4)))
    before = (fsw_rank_aggregate_cart.launches,
              fsw_rank_aggregate_cart_bwd.launches)
    P = args[0].clone().requires_grad_(True)
    f = args[3].clone().requires_grad_(True)
    out = fsw_rank_aggregate_cart(P, args[1], args[2], f, uniform_w=True,
                                  with_dw=False)
    assert torch.equal(out.detach(), fsw_rank_aggregate_cart_plain(
        *args, uniform_w=True))
    (out * G).sum().backward()
    want = fsw_rank_aggregate_cart_bwd(*args, G, uniform_w=True,
                                       with_dw=False)
    assert want[1] is None and want[2] is None
    assert torch.equal(P.grad, want[0]) and torch.equal(f.grad, want[3])
    assert (fsw_rank_aggregate_cart.launches,
            fsw_rank_aggregate_cart_bwd.launches) == before


def test_cart_other_devices_raise():
    args = [torch.zeros(s, device='meta') for s in
            [(2, 8, 3), (2, 8), (2,), (3, 4)]]
    with pytest.raises(ValueError, match='unsupported device'):
        fsw_rank_aggregate_cart(*args)
