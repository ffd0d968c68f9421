"""The port's unfused rank aggregation K2 (`fsw_rank_aggregate`: forward
and backward plain versions, and the custom ops on the CPU) against
the JAX package's `fsw_rank_aggregate` (its Pallas kernels in interpret
mode) and `jax.vjp` of it; and the table path's unfused 'rank' route
(d_in + d_edge >= slices) through FSWConv.

Inputs: ties (every fourth entry repeats the one before it), zero-weight
padding, widths B that are no multiple of 8 (JAX pads those with zero
weights), an f = 0 slice, one 'spread'-range frequency 2S - 1, and a
phantom mass where a row's total is below 1.

Tolerances:
  * float64: rtol 1e-10, atol 1e-12 * the output's scale.  Both sides
    compute the same expressions; only summation orders differ.
  * float32 forward: |port - jax| <= 2e-5 * max|jax| + 1e-5 * |jax|.  The
    JAX float32 path evaluates sin/cos with its own degree-13 polynomial
    (about 1.6 ulp), the port with libm; each output is a signed sum of B
    terms of the row's scale.
  * float32 backward, each output on its own scale: 1e-4 * max|jax| +
    1e-4 * |jax| (the trig, and the sums over S and R of dwn and df).
  * FSWConv, float32, both on their rank route: as test_torch_conv.py,
    |port - jax| <= 2e-5 * max|jax| + 1e-4 * |jax| for the output, and
    1e-4 of each gradient's scale + 1e-4 * |jax| for the gradients in the
    features and the slice vectors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu.ops.fsw_rank_pallas import \
    fsw_rank_aggregate as jax_rank
from fsw_gnn_tpu_torch.ops.fsw_rank import (fsw_rank_aggregate,
                                            fsw_rank_aggregate_bwd_plain,
                                            fsw_rank_aggregate_plain)

NAMES = ('dP', 'dwn', 'dpad', 'df')


def _args(rng, R, B, S, uniform_w):
    P = rng.standard_normal((R, B, S))
    P[:, 1::4] = P[:, 0:B - 1:4]
    real = rng.random((R, B)) < 0.7
    real[:, 0] = True
    w = (real.astype(np.float64) * 0.3 if uniform_w
         else np.abs(rng.standard_normal((R, B))) * real * 0.4)
    w[::2] *= 0.1                   # light rows: a phantom mass
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    freqs = np.abs(rng.standard_normal(S)) * 2 + 0.1
    freqs[1] = 0.0
    freqs[-1] = 2.0 * S - 1.0
    return (P, w / wsp[:, None], np.maximum(1.0 - w_sum, 0.0) / wsp, freqs)


def _jax_fwd(args, uniform_w):
    return np.asarray(jax_rank(*(jnp.asarray(a) for a in args), None, True,
                               True, uniform_w))


def _jax_bwd(args, G, uniform_w, with_dw):
    _, vjp = jax.vjp(lambda *a: jax_rank(*a, None, True, with_dw, uniform_w),
                     *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(G))]


@pytest.mark.parametrize('B', [5, 13, 16])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank2_f64_forward_matches_jax(B, uniform_w):
    args = _args(np.random.default_rng(B), 9, B, 20, uniform_w)
    assert (args[2] > 0).any() and (args[1] == 0).any()
    want = _jax_fwd(args, uniform_w)
    got = fsw_rank_aggregate_plain(*(torch.from_numpy(a) for a in args),
                                   uniform_w=uniform_w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('B', [5, 13])
@pytest.mark.parametrize('uniform_w', [False, True])
@pytest.mark.parametrize('with_dw', [False, True])
def test_rank2_f64_backward_matches_jax_vjp(B, uniform_w, with_dw):
    """dP, dwn, dpad, df of the plain backward against jax.vjp (whose wn
    and pad cotangents are zeros without with_dw, where the port's are
    None)."""
    rng = np.random.default_rng(100 + B)
    args = _args(rng, 7, B, 12, uniform_w)
    G = rng.standard_normal((7, 12))
    want = _jax_bwd(args, G, uniform_w, with_dw)
    got = fsw_rank_aggregate_bwd_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(G),
        uniform_w=uniform_w, with_dw=with_dw)
    for g, w, name in zip(got, want, NAMES):
        if g is None:
            assert not with_dw and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize('with_dw', [False, True])
def test_rank2_f32_matches_jax(with_dw):
    """float32 forward and, through the custom op, backward."""
    rng = np.random.default_rng(7)
    args = tuple(a.astype(np.float32) for a in _args(rng, 16, 13, 40, False))
    G = rng.standard_normal((16, 40)).astype(np.float32)
    want = _jax_fwd(args, False)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fsw_rank_aggregate(*ts, with_dw=with_dw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=2e-5 * np.abs(want).max())
    (out * torch.from_numpy(G)).sum().backward()
    for t, w, name in zip(ts, _jax_bwd(args, G, False, with_dw), NAMES):
        if not with_dw and name in ('dwn', 'dpad'):
            assert t.grad is None and not w.any(), name
            continue
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_rank2_autograd_is_the_plain_backward():
    """On the CPU the custom op's forward and backward are the
    plain versions (no launch is counted), and only the inputs that need a
    gradient get one: without a weight gradient the with_dw loop is
    skipped."""
    rng = np.random.default_rng(8)
    args = [torch.from_numpy(a) for a in _args(rng, 5, 6, 9, True)]
    G = torch.from_numpy(rng.standard_normal((5, 9)))
    before = (fsw_rank_aggregate.launches,)
    P = args[0].clone().requires_grad_(True)
    out = fsw_rank_aggregate(P, *args[1:], uniform_w=True, with_dw=False)
    assert torch.equal(out.detach(), fsw_rank_aggregate_plain(
        *args, uniform_w=True))
    (out * G).sum().backward()
    want = fsw_rank_aggregate_bwd_plain(*args, G, uniform_w=True,
                                        with_dw=False)
    assert torch.equal(P.grad, want[0])
    assert (fsw_rank_aggregate.launches,) == before


def test_rank2_zero_weight_entries_contribute_nothing():
    """Moving the projections of zero-weight entries changes neither the
    output nor any other entry's gradient, with and without uniform_w,
    and their own dP is exactly 0."""
    rng = np.random.default_rng(9)
    for unif in (False, True):
        P, wn, pad, freqs = (torch.from_numpy(a) for a in
                             _args(rng, 6, 11, 10, unif))
        G = torch.from_numpy(rng.standard_normal((6, 10)))
        dead = wn == 0
        assert dead.any()
        P2 = P.clone()
        P2[dead] += 3.0
        for Pq in (P, P2):
            torch.testing.assert_close(
                fsw_rank_aggregate_plain(Pq, wn, pad, freqs, unif),
                fsw_rank_aggregate_plain(P, wn, pad, freqs, unif),
                rtol=1e-12, atol=1e-12)
            dP = fsw_rank_aggregate_bwd_plain(Pq, wn, pad, freqs, G, unif,
                                              with_dw=False)[0]
            assert torch.all(dP[dead] == 0)


def test_rank2_other_devices_raise():
    args = [torch.zeros(s, device='meta') for s in
            [(2, 8, 3), (2, 8), (2,), (3,)]]
    with pytest.raises(ValueError, match='unsupported device'):
        fsw_rank_aggregate(*args)


def _edges(rng, n):
    p = np.linspace(0.0, 0.6, n)[rng.permutation(n)]
    A = rng.random((n, n)) < p[None, :]
    np.fill_diagonal(A, False)
    return np.stack(np.nonzero(A)).astype(np.int64)


@pytest.mark.parametrize('layout', ['multi', 'table'])
def test_table_path_unfused_rank_matches_jax(layout):
    """FSWConv(4, 4, embed_dim=4): d_in 4 >= 3 slices, so both packages'
    'rank' route runs the unfused kernel on gathered projections (and the
    port's 'auto' does too).  Forward and the gradients in the features
    and the slice vectors, float32."""
    from fsw_gnn_tpu_torch.embedding import _resolve_aggregate
    rng = np.random.default_rng(11)
    n = 24
    ei = _edges(rng, n)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    jg = J.from_edge_index(ei, n, dtype=jnp.float32)
    tg = T.from_edge_index(ei, n, dtype=np.float32)
    jl, tl = ((J.to_multi_table(jg), T.to_multi_table(tg)) if layout ==
              'multi' else (J.to_neighbor_table(jg), T.to_neighbor_table(tg)))
    kw = dict(in_channels=4, out_channels=4, embed_dim=4, mlp_layers=2)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float32, **kw)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.asarray(X), jl))
    tm = T.fswconv_from_jax(variables, device='cpu', **kw).eval()
    cfg = tm.embed_cfg
    assert cfg.proj_dim >= cfg.nSlices
    for table in tl.tables if layout == 'multi' else [tl]:
        assert _resolve_aggregate('auto', cfg, table.bucket_size,
                                  cfg.nSlices) == 'rank'
    G = rng.standard_normal((n, 4)).astype(np.float32)

    def jloss(X, proj):
        v = dict(variables, params=dict(variables['params']))
        v['params']['fsw_embed'] = dict(v['params']['fsw_embed'],
                                        proj_vecs=proj)
        out = jm.apply(v, X, jl, aggregate='rank')
        return jnp.sum(out * G), out

    proj = variables['params']['fsw_embed']['proj_vecs']
    (_, want), (gx, gp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(X), jnp.asarray(proj))
    want = np.asarray(want)
    Xt = torch.tensor(X, requires_grad=True)
    out = tm(Xt, tl, aggregate='rank')
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                               atol=2e-5 * np.abs(want).max())
    (out * torch.from_numpy(G)).sum().backward()
    for got, w, name in ((Xt.grad, gx, 'X'),
                         (tm.fsw_embed.proj_vecs.grad, gp, 'proj_vecs')):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
