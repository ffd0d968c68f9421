"""The backward entry kernel's formulation of the transposed term (kernels
K1b, K2b and K4b, `rank_bwd_entry_kernel` in
fsw_gnn_tpu_torch/csrc/fsw_rank_common.cuh), emulated in numpy float64 and
held against the plain PyTorch backward versions and `jax.vjp` of the JAX
package's `fsw_rank_aggregate` and `fsw_rank_aggregate_cart` (their Pallas
kernels in interpret mode).

The kernel splits a slice's entries over K threads, each ranking every
K-th group of 8 entries against the whole column (the tie rule settled by
ranges: a j below the group precedes on <=, a j above it on <, the group's
own entries both ways), and counts each entry's position under the tie
rule of M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)] beside its rank.
The transposed term sum_i dc_i M_ij is then the sum of dc over the
positions from j's on: dc scattered to its positions, summed from the end
once, read at each entry's position.  The emulation does exactly that, so
it checks the algorithm, its index ranges and its tie rule on the CPU,
where no kernel can run.

Inputs: columns full of ties (projections on a grid of five values, zero
among them), an f = 0 slice (K4: an f = 0 column), zero-weight padding, a
phantom mass where a row's total is below 1, a 'spread'-range frequency
2S - 1, and widths B at the boundaries where the threads a slice change
with weight gradients (K = 1 up to B = 8, 2 up to 16, 3 up to 24, 4
beyond).

Tolerance: float64, rtol 1e-10, atol 1e-10 * each output's scale.  The
sides compute the same expressions in other summation orders (dwn's
transposed term in sorted order here, in the order i = 0 .. B-1 in the
plain versions); the ranks are bit-equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsw_gnn_tpu.ops.fsw_rank_pallas import (
    fsw_rank_aggregate as jax_rank, fsw_rank_aggregate_cart as jax_cart)
from fsw_gnn_tpu_torch.ops import fsw_rank as FR

NAMES = ('dP', 'dwn', 'dpad', 'df')
NI, KMAX = 8, 4


def _parts(B):
    """Threads a slice: one a group of NI entries, at most KMAX
    (`entry_shape` at one or eight frequencies)."""
    return FR.entry_shape(B, 1, True)[0]


def _rank_and_positions(P, wn, pad, K):
    """c and the positions as the kernel's threads compute them: thread h
    of a slice ranks the groups h, h + K, ... of NI entries against every
    j in the order j = 0 .. B-1, by ranges, counting the predicate it adds
    c over; the position is that count less the entry itself."""
    R, B, S = P.shape
    c = np.zeros_like(P)
    n = np.zeros(P.shape, np.int64)
    for h in range(K):
        for i0 in range(h * NI, B, K * NI):
            for i in range(i0, min(i0 + NI, B)):
                p_i = P[:, i, :]
                for j in range(B):
                    p_j = P[:, j, :]
                    if j < i0:
                        a = p_j <= p_i
                    elif j < min(i0 + NI, B):
                        a = (p_j < p_i) | ((p_j == p_i) & (j <= i))
                    else:
                        a = p_j < p_i
                    c[:, i, :] += np.where(a, wn[:, j, None], 0.0)
                    n[:, i, :] += a
    c += np.where(P > 0, pad[:, None, None], 0.0)
    return c, np.maximum(n - 1, 0)


def _sincos2pi(u):
    a = 2.0 * np.pi * (u - np.round(u))
    return np.sin(a), np.cos(a)


def _emulate(P, wn, pad, freqs, G, K):
    """(dP, dwn, dpad, df) of K4's backward with with_dw, freqs (S, F) and
    G (R, S, F), by the entry kernel's algorithm (see the module
    docstring)."""
    c, pos = _rank_and_positions(P, wn, pad, K)
    ws = wn[:, :, None]
    two_c_w = 2.0 * c - ws
    dP = np.zeros_like(P)
    dc = np.zeros_like(P)
    dd = np.zeros_like(P)
    df = np.zeros(freqs.shape)
    for k in range(freqs.shape[1]):
        f = freqs[:, k]
        fz = f == 0
        inv_f = np.where(fz, 0.0, 1.0 / np.where(fz, 1.0, f))
        g1 = ((1.0 + f) * G[:, :, k])[:, None, :]
        sin_fw, cos_fw = _sincos2pi(0.5 * f * ws)
        sin_t, cos_t = _sincos2pi(0.5 * f * two_c_w)
        sd = np.where(fz, 2.0 * ws, (2.0 / np.pi) * inv_f * sin_fw) * cos_t
        dP += g1 * sd
        phi_f = 2.0 * inv_f * (ws * cos_fw * cos_t
                               - (inv_f / np.pi) * sin_fw * cos_t
                               - two_c_w * sin_fw * sin_t)
        q = (P * sd).sum(1)
        qf = (P * phi_f).sum(1)
        df[:, k] = (G[:, :, k] * (q + (1.0 + f) * qf)).sum(0)
        dc += g1 * P * (-4.0) * sin_fw * sin_t
        dd += g1 * P * 2.0 * (cos_fw * cos_t + sin_fw * sin_t)
    x = np.zeros_like(dc)
    np.put_along_axis(x, pos, dc, axis=1)              # dc at its position
    suffix = np.flip(np.cumsum(np.flip(x, 1), 1), 1)   # from the end, once
    T = np.take_along_axis(suffix, pos, axis=1)        # read at pos_j
    dwn = (dd + T).sum(2)
    dpad = np.where(P > 0, dc, 0.0).sum((1, 2))
    return dP, dwn, dpad, df


def _args(rng, R, B, S, F):
    """Tie-heavy projections, zero-weight entries, light rows (a phantom
    mass), an f = 0 column and f = 2S - 1."""
    P = rng.integers(-2, 3, (R, B, S)) * 0.5
    real = rng.random((R, B)) < 0.7
    real[:, -1] = False
    real[:, 0] = True
    w = np.abs(rng.standard_normal((R, B))) * real * 3.2 / max(B, 8)
    w[::2] *= 0.1
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    freqs = np.abs(rng.standard_normal((S, F))) * 2 + 0.1
    freqs[:, 1 % F] = 0.0
    freqs[-1, -1] = 2.0 * S - 1.0
    G = rng.standard_normal((R, S, F))
    return P, w / wsp[:, None], np.maximum(1.0 - w_sum, 0.0) / wsp, freqs, G


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max(), err_msg=name)


BOUNDARIES = [1, 8, 9, 16, 17, 24, 25, 33]


@pytest.mark.parametrize('B', BOUNDARIES + [100])
def test_positions_are_the_stable_order_and_ranks_are_the_plain_ones(B):
    """The range-split counts give every entry its place in the stable
    sort of its column (a permutation), and c equals the plain version's
    ranks bit for bit."""
    P, wn, pad, _, _ = _args(np.random.default_rng(B), 4, B, 6, 1)
    c, pos = _rank_and_positions(P, wn, pad, _parts(B))
    order = np.argsort(P, axis=1, kind='stable')
    want = np.empty_like(pos)
    np.put_along_axis(want, order, np.arange(B)[None, :, None], axis=1)
    assert np.array_equal(pos, want)
    plain = FR._rank(torch.from_numpy(P), torch.from_numpy(wn),
                     torch.from_numpy(pad)).numpy()
    assert np.array_equal(c, plain)


@pytest.mark.parametrize('B', BOUNDARIES + [100])
@pytest.mark.parametrize('F', [1, 8, 3])
def test_emulation_matches_plain_backward(B, F):
    """dwn and dpad by positions, and dP and df, against the plain
    versions (K2's at one frequency, K4's at several)."""
    P, wn, pad, freqs, G = _args(np.random.default_rng(100 * F + B), 5, B,
                                 7, F)
    assert (pad > 0).any() and ((wn == 0).any() or B == 1)
    got = _emulate(P, wn, pad, freqs, G, _parts(B))
    t = [torch.from_numpy(a) for a in (P, wn, pad, freqs, G)]
    if F == 1:
        want = FR.fsw_rank_aggregate_bwd_plain(t[0], t[1], t[2], t[3][:, 0],
                                               t[4][..., 0], with_dw=True)
        want = list(want[:3]) + [want[3][:, None]]
    else:
        want = FR.fsw_rank_aggregate_cart_bwd_plain(*t, with_dw=True)
    for g, w, name in zip(got, want, NAMES):
        _close(g, w.numpy(), name)
    assert np.all(got[0][wn == 0] == 0)


@pytest.mark.parametrize('B', BOUNDARIES)
@pytest.mark.parametrize('F', [1, 8])
def test_emulation_matches_jax_vjp(B, F):
    """dwn and dpad by positions, and dP and df, against jax.vjp of the JAX
    package's kernels in interpret mode (K2 at one frequency, K4 at
    eight)."""
    P, wn, pad, freqs, G = _args(np.random.default_rng(200 * F + B), 3, B,
                                 6, F)
    got = _emulate(P, wn, pad, freqs, G, _parts(B))
    if F == 1:
        fn, args, g = jax_rank, (P, wn, pad, freqs[:, 0]), G[..., 0]
    else:
        fn, args, g = jax_cart, (P, wn, pad, freqs), G
    _, vjp = jax.vjp(lambda *a: fn(*a, None, True, True, False),
                     *(jnp.asarray(a) for a in args))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    if F == 1:
        want[3] = want[3][:, None]
    for gv, w, name in zip(got, want, NAMES):
        _close(gv, w, name)
