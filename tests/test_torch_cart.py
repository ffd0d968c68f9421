"""Cartesian mode (an n_slices x n_freqs grid) on the port's rank route
(kernel K4, `fsw_rank_aggregate_cart`, its plain versions on the CPU)
against the JAX package's rank route (its cartesian Pallas kernels in
interpret mode): `fsw_embed_table`, `fsw_embed_multi_table` and
`fsw_embed_multiset`, collapsed and not, with the total mass encoded under
collapse, with `slice_chunk` (a padded last chunk), with W given and
W = None; the gradients of X, the weights and the frequencies with
`weights_grad` both ways; a JAX `FSWEmbedding` with learnable slices and
frequencies carried in by `fswembedding_from_jax`; and the route table.

Inputs are drawn with numpy from seeds: weighted graphs whose in-degrees
spread over 0 .. ~14 (several degree classes, empty and light
neighborhoods, so a phantom mass), multisets with zero weights among
them.

Tolerance, float32 on both sides: |port - jax| <= 1e-4 * max|jax| +
1e-4 * |jax|, for outputs and for each gradient on its own scale.  JAX's
float32 kernel evaluates sin/cos with its own degree-13 polynomial (about
1.6 ulp), the port with libm, and the projections X V are summed in
another order; each output is a signed sum of B terms of its scale.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu import embedding as JE
from fsw_gnn_tpu import modules as JM
from fsw_gnn_tpu_torch import embedding as TE
from fsw_gnn_tpu_torch.ops import fsw_rank as TR

N, D_IN = 24, 3
LEAD = (2, 3)
CFGS = {
    'cart': dict(n_slices=5, n_freqs=3),
    'cart_collapse_tm': dict(n_slices=5, n_freqs=3, collapse_freqs=True,
                             encode_total_mass=True,
                             total_mass_encoding_method='homog'),
}


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _graph(rng):
    """A weighted graph of N nodes whose in-degrees spread over 0..~14."""
    p = np.linspace(0.0, 0.6, N)[rng.permutation(N)]
    A = rng.random((N, N)) < p[None, :]
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    return ei, (rng.random(ei.shape[1]) * 0.5 + 0.05).astype(np.float32)


def _setup(rng, cfg_kw):
    jcfg = JE.FSWConfig(d_in=D_IN, **cfg_kw)
    tcfg = TE.FSWConfig(d_in=D_IN, **cfg_kw)
    V = rng.standard_normal((tcfg.nSlices, D_IN)).astype(np.float32)
    freqs = (rng.random(tcfg.nFreqs) * 4.0).astype(np.float32)
    bias = rng.standard_normal(T.bias_shape(tcfg)).astype(np.float32)
    return jcfg, tcfg, (V, freqs, bias, np.asarray(0.7, np.float32))


def _layouts(ei, w, layout):
    jg = J.from_edge_index(ei, N, edge_weight=w, dtype=jnp.float32)
    tg = T.from_edge_index(ei, N, edge_weight=w, dtype=np.float32)
    if layout == 'multi':
        return J.to_multi_table(jg), T.to_multi_table(tg).to('cpu')
    return J.to_neighbor_table(jg), T.to_neighbor_table(tg).to('cpu')


def _jparams(params):
    V, freqs, bias, tms = (jnp.asarray(a) for a in params)
    return (V, freqs), dict(bias=bias, total_mass_scale=tms)


def _tparams(params):
    V, freqs, bias, tms = (torch.from_numpy(np.asarray(a)) for a in params)
    return (V, freqs), dict(bias=bias, total_mass_scale=tms)


@pytest.mark.parametrize('cfg', sorted(CFGS))
@pytest.mark.parametrize('layout', ['table', 'multi'])
@pytest.mark.parametrize('slice_chunk', [None, 2])
def test_cart_tables_rank_match_jax(cfg, layout, slice_chunk):
    """`fsw_embed_table` / `fsw_embed_multi_table`: the port's 'rank' and
    'auto' (widths <= 128: K4 too) against JAX's 'rank'."""
    rng = np.random.default_rng(1)
    jcfg, tcfg, params = _setup(rng, CFGS[cfg])
    ei, w = _graph(rng)
    jl, tl = _layouts(ei, w, layout)
    X = rng.standard_normal((N, D_IN)).astype(np.float32)
    jfn, tfn = ((JE.fsw_embed_table, TE.fsw_embed_table) if layout == 'table'
                else (JE.fsw_embed_multi_table, TE.fsw_embed_multi_table))
    ja, jkw = _jparams(params)
    want = jfn(jnp.asarray(X), jl, *ja, jcfg, slice_chunk=slice_chunk,
               aggregate='rank', **jkw)
    ta, tkw = _tparams(params)
    calls = []
    for agg in ('rank', 'auto'):
        before = TR.fsw_rank_aggregate_cart.launches
        got = tfn(torch.from_numpy(X), tl, *ta, tcfg, slice_chunk=slice_chunk,
                  aggregate=agg, **tkw)
        calls.append(TR.fsw_rank_aggregate_cart.launches - before)
        _close(got, want)
    assert calls == [0, 0]              # the CPU runs the plain versions


@pytest.mark.parametrize('cfg', sorted(CFGS))
@pytest.mark.parametrize('w', ['W', 'unit', 'uniform'])
@pytest.mark.parametrize('slice_chunk', [None, 2])
def test_cart_multiset_rank_matches_jax(cfg, w, slice_chunk):
    """`fsw_embed_multiset` on (2, 3) multisets of 9 points: W given, or
    W = None (uniform_w on the rank route)."""
    rng = np.random.default_rng(2)
    jcfg, tcfg, params = _setup(rng, CFGS[cfg])
    X = rng.standard_normal(LEAD + (9, D_IN)).astype(np.float32)
    W = (np.abs(rng.standard_normal(LEAD + (9,)))
         * (rng.random(LEAD + (9,)) < 0.8)).astype(np.float32)
    W[0] *= 0.05                                # light: a phantom mass
    W = W if w == 'W' else None
    kw = dict(w_mode='unit' if w == 'W' else w, slice_chunk=slice_chunk)
    ja, jkw = _jparams(params)
    want = JE.fsw_embed_multiset(jnp.asarray(X),
                                 None if W is None else jnp.asarray(W),
                                 *ja, jcfg, aggregate='rank', **kw, **jkw)
    ta, tkw = _tparams(params)
    for agg in ('rank', 'auto'):
        got = TE.fsw_embed_multiset(
            torch.from_numpy(X), None if W is None else torch.from_numpy(W),
            *ta, tcfg, aggregate=agg, **kw, **tkw)
        _close(got, want)


@pytest.mark.parametrize('weights_grad', [True, False])
def test_cart_table_grads_match_jax(weights_grad):
    """The gradients of X, the table's weights and the frequencies
    through a NeighborTable, collapsed with the total mass encoded.
    Without weights_grad the weights still take the total mass's
    gradient, and the kernel's none."""
    rng = np.random.default_rng(3)
    jcfg, tcfg, params = _setup(rng, CFGS['cart_collapse_tm'])
    ei, w = _graph(rng)
    jt, tt = _layouts(ei, w, 'table')
    X = rng.standard_normal((N, D_IN)).astype(np.float32)
    G = rng.standard_normal((N, tcfg.out_dim)).astype(np.float32)
    (V, freqs), jkw = _jparams(params)

    def jloss(X, wt, f):
        out = JE.fsw_embed_table(X, jt.replace(weight=wt), V, f, jcfg,
                                 aggregate='rank', weights_grad=weights_grad,
                                 **jkw)
        return jnp.sum(out * G)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(X), jt.weight,
                                               freqs)
    (Vt, ft), tkw = _tparams(params)
    Xt = torch.tensor(X, requires_grad=True)
    Wt = torch.tensor(np.asarray(jt.weight), requires_grad=True)
    ft = ft.clone().requires_grad_(True)
    out = TE.fsw_embed_table(Xt, dataclasses.replace(tt, weight=Wt), Vt, ft,
                             tcfg, weights_grad=weights_grad, **tkw)
    (out * torch.from_numpy(G)).sum().backward()
    for got, w_ in zip((Xt.grad, Wt.grad, ft.grad), want):
        _close(got, w_)


@pytest.mark.parametrize('weights_grad', [True, False])
def test_cart_multiset_grads_match_jax(weights_grad):
    """The gradients of X, W and the frequencies through multisets, not
    collapsed."""
    rng = np.random.default_rng(4)
    jcfg, tcfg, params = _setup(rng, CFGS['cart'])
    X = rng.standard_normal(LEAD + (9, D_IN)).astype(np.float32)
    W = (np.abs(rng.standard_normal(LEAD + (9,))) + 0.05).astype(np.float32)
    W[1] *= 0.05
    G = rng.standard_normal(LEAD + (tcfg.nSlices, tcfg.nFreqs)).astype(
        np.float32)
    (V, freqs), jkw = _jparams(params)

    def jloss(X, W, f):
        out = JE.fsw_embed_multiset(X, W, V, f, jcfg, aggregate='rank',
                                    weights_grad=weights_grad, **jkw)
        return jnp.sum(out * G)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(X), jnp.asarray(W),
                                               freqs)
    (Vt, ft), tkw = _tparams(params)
    Xt = torch.tensor(X, requires_grad=True)
    Wt = torch.tensor(W, requires_grad=True)
    ft = ft.clone().requires_grad_(True)
    out = TE.fsw_embed_multiset(Xt, Wt, Vt, ft, tcfg,
                                weights_grad=weights_grad, **tkw)
    assert out.shape == LEAD + (tcfg.nSlices, tcfg.nFreqs)
    (out * torch.from_numpy(G)).sum().backward()
    for got, w_ in zip((Xt.grad, Wt.grad, ft.grad), want):
        _close(got, w_)


@pytest.mark.parametrize('cfg', sorted(CFGS))
def test_cart_fswembedding_bridge_matches_jax(cfg):
    """A JAX FSWEmbedding in cartesian mode with learnable slices and
    frequencies, carried into the port by `fswembedding_from_jax`: the
    bias shape, and the forward and the gradients of the slice vectors
    and the (F,) frequencies (through K4's df) on a MultiTable and on
    multisets, both on their rank route."""
    rng = np.random.default_rng(5)
    kw = dict(d_in=D_IN, learnable_slices=True, learnable_freqs=True,
              **CFGS[cfg])
    jcfg, tcfg = JE.FSWConfig(**kw), TE.FSWConfig(**kw)
    X = rng.standard_normal(LEAD + (9, D_IN)).astype(np.float32)
    W = (np.abs(rng.standard_normal(LEAD + (9,))) + 0.05).astype(np.float32)
    jm = JM.FSWEmbedding(jcfg, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(W)))
    tm = T.fswembedding_from_jax(variables, tcfg, device='cpu')
    assert tuple(tm.bias.shape) == T.bias_shape(tcfg) == (
        (5, 3) if cfg == 'cart' else (16,))
    assert tuple(tm.freqs.shape) == (3,)
    ei, w = _graph(rng)
    jmt, tmt = _layouts(ei, w, 'multi')
    Xn = rng.standard_normal((N, D_IN)).astype(np.float32)
    for label, jargs, jcall, targs, tcall in (
            ('multi table', (jnp.asarray(Xn),), dict(graph=jmt),
             (torch.from_numpy(Xn),), dict(graph=tmt)),
            ('multisets', (jnp.asarray(X), jnp.asarray(W)), {},
             (torch.from_numpy(X), torch.from_numpy(W)), {})):
        def jloss(params):
            out = jm.apply(dict(variables, params=params), *jargs,
                           aggregate='rank', **jcall)
            return jnp.sum(jnp.sin(out)), out
        (_, want), grads = jax.value_and_grad(jloss, has_aux=True)(
            variables['params'])
        tm.zero_grad(set_to_none=True)
        out = tm(*targs, aggregate='auto', **tcall)
        _close(out, want)
        torch.sin(out).sum().backward()
        for name in ('proj_vecs', 'freqs', 'bias'):
            _close(getattr(tm, name).grad, grads[name])


def test_cart_route_table():
    """Cartesian 'auto' takes K4 ('rank') up to width 128 and 'sort' at
    129, with or without a fused-projection width; an explicit 'rank' is
    K4 at any width K4's blocks hold (423 with weight gradients at 8
    frequencies) and raises beyond, naming the width; cartesian mode never
    takes K1 ('rank_proj'), where the same widths outside it do."""
    cart = TE.FSWConfig(d_in=3, n_slices=128, n_freqs=8)
    flat = TE.FSWConfig(d_in=3, d_out=128)
    cap = TE.RANK_AGGREGATE_MAX_BUCKET_NO_DW
    assert cap == 128
    for s_eff in (None, 128):
        assert TE._resolve_aggregate('auto', cart, cap, s_eff) == 'rank'
        assert TE._resolve_aggregate('auto', cart, cap + 1, s_eff) == 'sort'
        assert TE._resolve_aggregate('rank', cart, 423, s_eff) == 'rank'
        with pytest.raises(ValueError, match='bucket width 1024 at 8 freq'):
            TE._resolve_aggregate('rank', cart, 1024, s_eff)
        assert TE._resolve_aggregate('sort', cart, 8, s_eff) == 'sort'
    assert TE._resolve_aggregate('auto', flat, cap, 128, True,
                                 1.0) == 'rank_proj'
    assert TE._resolve_aggregate('auto', flat, cap) == 'rank'
