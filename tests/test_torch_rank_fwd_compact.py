"""The forward rank kernels' order of work (kernels K2f and K4f,
fsw_gnn_tpu_torch/csrc/fsw_rank_fwd.cu and fsw_rank_cart_fwd.cu, with
`stage_kept`, `rank_core` and `rank_fwd_slice` in fsw_rank_common.cuh),
emulated in numpy float32 and held against an emulation of the previous
design's order, the plain PyTorch versions and the JAX package's
`fsw_rank_aggregate` and `fsw_rank_aggregate_cart` (their Pallas kernels in
interpret mode).

The kernels keep only a row's entries of nonzero weight, in their order,
and rank and sum over those d entries as if the width were d.  The rank
loop takes NI = 8 entries a pass and settles the tie rule by ranges: a j
below the group precedes on <=, a j above it on <, and the group's own
8 x 8 pairs, unrolled, on <= for j <= i and < otherwise; a pair adds w_j s
(s = 0 or 1) to c with one fused multiply-add, which rounds as c + w_j or
leaves c.  K4f at F = 8 keeps a group's ranks in registers and adds each
entry's term to the 8 frequencies' accumulators in turn; at other F it
sums one frequency at a time.  Either way every sum runs in order, one
thread a slice.  The previous design ranked every entry of the row
(j = 0 .. B-1, the tie rule j <= i on the index) and summed every entry
in order.

Bit-equality with the previous order (np.array_equal, no tolerance): a
zero weight adds exactly 0 to every rank, and a padded entry's term is
(2/(pi f)) sin(pi f 0) cos(.) p = +-0, which leaves a sum unchanged.  Both
emulations share the float32 arithmetic (every operation rounded to
float32; a fused multiply-add as an exact float64 product and sum rounded
to float32, and sin(pi x), cos(pi x) of the wrapped argument), so what
they test is the order and the dropped entries.

Against the plain versions (float32) and JAX (float32, interpret mode):
rtol 1e-5, atol 2e-5 x each output's scale, the kernels' tolerance on the
card; the ranks agree to the bit, the trig differs in rounding.

Inputs: zero weights at random positions (not only trailing), a row with
every weight zero, columns full of ties (a grid of five values, zero among
them), an f = 0 slice (K4: an f = 0 column), a phantom mass where a row's
total is below 1, the 'spread' frequency 2S - 1, uniform_w on and off,
and widths B around the group of 8 and up to 128.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fsw_gnn_tpu.ops.fsw_rank_pallas import (
    fsw_rank_aggregate as jax_rank, fsw_rank_aggregate_cart as jax_cart)
from fsw_gnn_tpu_torch.ops import fsw_rank as FR

NI, NF_WIDE = 8, 8
F32 = np.float32
WIDTHS = [1, 7, 8, 9, 33, 100, 128]


def _fma(a, b, c):
    """a b + c rounded to float32 (the product exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _sinpi(x):
    """sin(pi x) of float32 x, the period 2 reduced exactly."""
    x = x.astype(np.float64)
    return np.sin(np.pi * (x - 2.0 * np.round(0.5 * x))).astype(F32)


def _cospi(x):
    x = x.astype(np.float64)
    return np.cos(np.pi * (x - 2.0 * np.round(0.5 * x))).astype(F32)


def _freq_consts(f, wr, uniform_w):
    """(1/f zeroed at f = 0, (2/pi)/f, the uniform row's sin(pi f wr)) of
    float32 frequencies f, as the kernels compute them."""
    fz = f == 0
    inv_f = np.where(fz, F32(0), F32(1) / np.where(fz, F32(1), f))
    c2f = F32(0.636619772367581343) * inv_f
    sin_row = (_sinpi(F32(2) * (F32(0.5) * f * wr)) if uniform_w
               else np.zeros_like(f))
    return fz, c2f, sin_row


def _sd(f, consts, w, c, uniform_w):
    """sd of entries of weight w (a scalar) and ranks c (S,) at f (S,)."""
    fz, c2f, sin_row = consts
    if uniform_w:
        sin_fw = np.where(w == 0, F32(0), sin_row)
    else:
        sin_fw = _sinpi(F32(2) * (F32(0.5) * f * w))
    u = F32(0.5) * f * (F32(2) * c - w)
    cos_t = _cospi(F32(2) * u)
    return np.where(fz, F32(2) * w, c2f * sin_fw) * cos_t


def _ranks_previous(p, w, pad):
    """c (B, S) of one row by the previous order: every entry, j = 0 ..
    B-1, the tie rule j <= i on the index."""
    B = p.shape[0]
    idx = np.arange(B)[:, None]
    c = np.zeros_like(p)
    for j in range(B):
        s = (p[j] < p) | ((p[j] == p) & (j <= idx))
        c = _fma(np.broadcast_to(w[j], p.shape), s.astype(F32), c)
    return c + np.where(p > 0, pad, F32(0))


def _ranks_new(p, w, pad):
    """c (d, S) of one row's kept entries by `rank_core`'s ranges."""
    d = p.shape[0]
    c = np.zeros_like(p)
    i = np.arange(d)[:, None]
    g0 = i // NI * NI
    for j in range(d):
        in_group = (j >= g0) & (j < g0 + NI)
        le = (j < g0) | (in_group & (j <= i))
        s = np.where(le, p[j] <= p, p[j] < p)
        c = _fma(np.broadcast_to(w[j], p.shape), s.astype(F32), c)
    return c + np.where(p > 0, pad, F32(0))


def _row_max(w):
    wr = F32(0)
    for x in w:
        wr = np.fmax(wr, x)
    return wr


def _forward(P, wn, pad, freqs, uniform_w, new):
    """out (R, S, F) of K4f (K2f at F = 1) for freqs (S, F), and the ranks
    of every row (the kept entries' with `new`)."""
    R, B, S = P.shape
    F = freqs.shape[1]
    out = np.zeros((R, S, F), F32)
    ranks = []
    for r in range(R):
        p, w = P[r], wn[r]
        if new:
            keep = w != 0
            p, w = p[keep], w[keep]
            c = _ranks_new(p, w, pad[r])
        else:
            c = _ranks_previous(p, w, pad[r])
        ranks.append(c)
        wr = _row_max(w)
        consts = [_freq_consts(freqs[:, k], wr, uniform_w) for k in range(F)]
        acc = np.zeros((F, S), F32)
        if new and F == NF_WIDE:
            # a group's ranks in registers, each entry's term added to the
            # 8 frequencies' accumulators in turn
            for i0 in range(0, p.shape[0], NI):
                for i in range(i0, min(i0 + NI, p.shape[0])):
                    for k in range(F):
                        acc[k] = _fma(p[i], _sd(freqs[:, k], consts[k], w[i],
                                                c[i], uniform_w), acc[k])
        else:
            for k in range(F):
                for i in range(p.shape[0]):
                    acc[k] = _fma(p[i], _sd(freqs[:, k], consts[k], w[i],
                                            c[i], uniform_w), acc[k])
        out[r] = ((F32(1) + freqs.T) * acc).T
    return out, ranks


def _args(rng, R, B, S, F, uniform_w):
    """float32 inputs: tie-heavy projections on a grid of five values with
    zero among them (every other row) or normal, zero weights at random
    positions, the last row all zero, light rows (a phantom mass), an
    f = 0 column and f = 2S - 1."""
    P = rng.standard_normal((R, B, S))
    P[::2] = rng.integers(-2, 3, (len(range(0, R, 2)), B, S)) * 0.5
    real = rng.random((R, B)) < 0.6
    real[0, 0] = True
    real[-1] = False
    w = (real.astype(np.float64) if uniform_w
         else np.abs(rng.standard_normal((R, B))) * real)
    w[1::3] *= 0.1
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    freqs = np.abs(rng.standard_normal((S, F))) * 2 + 0.1
    freqs[1 % S, 1 % F] = 0.0
    freqs[-1, -1] = 2.0 * S - 1.0
    return [a.astype(F32) for a in
            (P, w / wsp[:, None], np.maximum(1.0 - w_sum, 0.0) / wsp, freqs)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize('B', WIDTHS)
@pytest.mark.parametrize('F', [1, 8, 3])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_kept_entries_keep_the_previous_bits(B, F, uniform_w):
    """c of every real entry and every output equal the previous order's
    to the bit; rows without a real entry give (1 + f) 0."""
    P, wn, pad, freqs = _args(np.random.default_rng(10 * B + F), 5, B, 9, F,
                              uniform_w)
    assert (wn == 0).any() and (pad > 0).any()
    got, c_new = _forward(P, wn, pad, freqs, uniform_w, True)
    want, c_old = _forward(P, wn, pad, freqs, uniform_w, False)
    assert np.array_equal(got, want)
    for r in range(P.shape[0]):
        assert np.array_equal(c_new[r], c_old[r][wn[r] != 0])
    assert np.array_equal(got[-1], np.zeros_like(got[-1]))


@pytest.mark.parametrize('B', WIDTHS)
def test_non_finite_padding_contributes_zero(B):
    """A padded entry whose projection is not finite leaves the new
    forward's output as it is with a finite one: it is never read."""
    P, wn, pad, freqs = _args(np.random.default_rng(B), 4, B, 7, 8, False)
    want, _ = _forward(P, wn, pad, freqs, False, True)
    Pn = P.copy()
    Pn[np.broadcast_to((wn == 0)[:, :, None], P.shape)] = np.nan
    Pn[:, ::3][np.broadcast_to((wn[:, ::3] == 0)[:, :, None],
                               Pn[:, ::3].shape)] = np.inf
    got, _ = _forward(Pn, wn, pad, freqs, False, True)
    assert np.array_equal(got, want)


@pytest.mark.parametrize('B', WIDTHS)
@pytest.mark.parametrize('F', [1, 8, 5])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_new_forward_matches_plain(B, F, uniform_w):
    """The new order against the plain PyTorch forwards (K2's at one
    frequency, K4's at several), in float32."""
    P, wn, pad, freqs = _args(np.random.default_rng(300 + 10 * B + F), 5, B,
                              8, F, uniform_w)
    got, _ = _forward(P, wn, pad, freqs, uniform_w, True)
    t = [torch.from_numpy(a) for a in (P, wn, pad, freqs)]
    if F == 1:
        want = FR.fsw_rank_aggregate_plain(*t[:3], t[3][:, 0],
                                           uniform_w=uniform_w)[..., None]
    else:
        want = FR.fsw_rank_aggregate_cart_plain(*t, uniform_w=uniform_w)
    _close(got, want.numpy())


@pytest.mark.parametrize('B', [1, 8, 9, 33, 128])
@pytest.mark.parametrize('F', [1, 8])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_new_forward_matches_jax(B, F, uniform_w):
    """The new order against the JAX package's kernels in interpret mode
    (K2 at one frequency, K4 at eight), in float32."""
    P, wn, pad, freqs = _args(np.random.default_rng(500 + 10 * B + F), 3, B,
                              6, F, uniform_w)
    got, _ = _forward(P, wn, pad, freqs, uniform_w, True)
    if F == 1:
        want = np.asarray(jax_rank(*(jnp.asarray(a) for a in
                                     (P, wn, pad, freqs[:, 0])),
                                   None, True, False, uniform_w))[..., None]
    else:
        want = np.asarray(jax_cart(*(jnp.asarray(a) for a in
                                     (P, wn, pad, freqs)),
                                   None, True, False, uniform_w))
    _close(got, want)
