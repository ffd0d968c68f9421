"""The slice as a whole: the JAX package's FSWConv variables carried into
the port by the bridge, forwards compared on a MultiTable and on a
NeighborTable (small widths: N = 64, d_in = d_out = 8, mlp_layers = 3,
BatchNorm with non-trivial running statistics).

Tolerances:
  * float64, aggregate='sort' on both sides: rtol 1e-10 (the same
    arithmetic up to summation order in the sorts' cumsum and the MLP's
    products).
  * float32, JAX aggregate='rank' (its Pallas kernel in interpret mode)
    against the port's 'auto' (the plain version of the rank kernel):
    |port - jax| <= 2e-5 * max|jax| + 1e-4 * |jax|.  The embedding alone
    agrees to about 4e-7 of its scale (tests/test_torch_rank.py: JAX's
    polynomial trig against libm); three Linear layers and BatchNorm
    carry that through with a gain of a few.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch.embedding import _resolve_aggregate, lowclamp

N, D_IN, D_OUT = 64, 8, 8


def _edges(rng, n):
    """Unit-weight graph whose in-degrees spread over 0..~40, so the
    MultiTable has several degree classes (and empty neighborhoods)."""
    p = np.linspace(0.0, 0.6, n)[rng.permutation(n)]
    A = rng.random((n, n)) < p[None, :]
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    return np.stack([src, dst]).astype(np.int64)


def _setup(layout, d_edge, f64, seed=0):
    rng = np.random.default_rng(seed)
    ei = _edges(rng, N)
    npdt = np.float64 if f64 else np.float32
    ef = (rng.standard_normal((ei.shape[1], d_edge)) if d_edge else None)
    X = rng.standard_normal((N, D_IN)).astype(npdt)
    jgr = J.from_edge_index(ei, N, ef, dtype=jnp.float64 if f64
                            else jnp.float32)
    tgr = T.from_edge_index(ei, N, ef, dtype=npdt)
    if layout == 'multi':
        jl, tl = J.to_multi_table(jgr), T.to_multi_table(tgr)
        assert len(tl.tables) >= 4
    else:
        jl, tl = J.to_neighbor_table(jgr), T.to_neighbor_table(tgr)
    kw = dict(in_channels=D_IN, out_channels=D_OUT, edgefeat_dim=d_edge,
              mlp_layers=3, batchnorm_hidden=True)
    jm = J.FSWConv(minimize_slice_coherence=False,
                   dtype=jnp.float64 if f64 else jnp.float32, **kw)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(X), jl))
    variables = jax.tree_util.tree_map(lambda a: a.copy(), variables)
    for bn in variables['batch_stats']['head'].values():
        bn['mean'] = rng.standard_normal(bn['mean'].shape).astype(npdt)
        bn['var'] = (0.5 + rng.random(bn['var'].shape)).astype(npdt)
    tm = T.fswconv_from_jax(variables, device='cpu',
                            dtype=torch.float64 if f64 else torch.float32,
                            **kw).eval()
    return jm, variables, tm, X, jl, tl


@pytest.mark.parametrize('layout,d_edge,slice_chunk', [
    ('multi', 0, None), ('table', 0, None), ('multi', 2, None),
    ('table', 2, None), ('multi', 2, 4)])
def test_fswconv_f64_sort_matches_jax(layout, d_edge, slice_chunk):
    jm, variables, tm, X, jl, tl = _setup(layout, d_edge, f64=True)
    want = np.asarray(jm.apply(variables, jnp.asarray(X), jl,
                               aggregate='sort', slice_chunk=slice_chunk))
    with torch.no_grad():
        got = tm(torch.from_numpy(X), tl, aggregate='sort',
                 slice_chunk=slice_chunk).numpy()
    assert got.shape == (N, D_OUT) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize('layout,d_edge', [('multi', 0), ('table', 0),
                                           ('multi', 2)])
def test_fswconv_f32_rank_matches_jax(layout, d_edge):
    jm, variables, tm, X, jl, tl = _setup(layout, d_edge, f64=False,
                                          seed=1)
    cfg = tm.embed_cfg
    for table in tl.tables if layout == 'multi' else [tl]:
        assert _resolve_aggregate('auto', cfg, table.bucket_size,
                                  cfg.nSlices, True,
                                  table.idx.size / N) == 'rank_proj'
    want = np.asarray(jm.apply(variables, jnp.asarray(X), jl,
                               aggregate='rank'))
    with torch.no_grad():
        got = tm(torch.from_numpy(X), tl).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=2e-5 * np.abs(want).max())


def test_fswconv_grads_f64_sort_match_jax():
    """Forward and backward of the port run on the CPU by autograd; the
    gradients of a loss in the input features and the slice vectors match
    JAX's (float64, sort path)."""
    jm, variables, tm, X, jl, tl = _setup('table', 0, f64=True, seed=2)

    def jloss(X, proj):
        v = dict(variables, params=dict(variables['params']))
        v['params']['fsw_embed'] = dict(v['params']['fsw_embed'],
                                        proj_vecs=proj)
        out = jm.apply(v, X, jl, aggregate='sort')
        return jnp.sum(jnp.sin(out))

    gx, gp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(X), jnp.asarray(variables['params']['fsw_embed']
                                    ['proj_vecs']))
    Xt = torch.tensor(X, requires_grad=True)
    torch.sin(tm(Xt, tl, aggregate='sort')).sum().backward()
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(gx),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(tm.fsw_embed.proj_vecs.grad.numpy(),
                               np.asarray(gp), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize('cfg_kw', [
    dict(d_out=9, encode_total_mass=True, total_mass_encoding_method='homog',
         total_mass_encoding_function='log'),
    dict(d_out=9, encode_total_mass=True,
         total_mass_encoding_method='homog_alt',
         total_mass_encoding_function='sqrt', total_mass_pad_thresh=3.0),
    dict(n_slices=4, n_freqs=3, collapse_freqs=True, encode_total_mass=True),
    dict(n_slices=4, n_freqs=3)], ids=['homog', 'homog_alt', 'cart_collapse',
                                       'cart'])
def test_embed_multi_table_sort_variants_match_jax(cfg_kw):
    """The embedding alone on the sort route, float64, rtol 1e-10: the
    total-mass encodings and cartesian mode, which FSWConv's defaults do
    not reach (cartesian mode's rank route: tests/test_torch_cart.py)."""
    from fsw_gnn_tpu import embedding as JE
    from fsw_gnn_tpu_torch import embedding as TE
    rng = np.random.default_rng(6)
    ei = _edges(rng, 32)
    ef = rng.standard_normal((ei.shape[1], 2))
    X = rng.standard_normal((32, 3))
    jt = J.to_multi_table(J.from_edge_index(ei, 32, ef, dtype=jnp.float64))
    tt = T.to_multi_table(T.from_edge_index(ei, 32, ef, dtype=np.float64))
    jcfg = JE.FSWConfig(d_in=3, d_edge=2, **cfg_kw)
    tcfg = TE.FSWConfig(d_in=3, d_edge=2, **cfg_kw)
    V = rng.standard_normal((tcfg.nSlices, 5))
    freqs = rng.random(tcfg.nFreqs) * 4.0
    bias = rng.standard_normal(T.bias_shape(tcfg))
    args = (V, freqs, bias, np.float64(0.7))
    want = JE.fsw_embed_multi_table(
        jnp.asarray(X), jt, *(jnp.asarray(a) for a in args[:2]), jcfg,
        bias=jnp.asarray(bias), total_mass_scale=jnp.asarray(args[3]),
        aggregate='sort')
    got = TE.fsw_embed_multi_table(
        torch.from_numpy(X), tt.to('cpu'),
        *(torch.from_numpy(a) for a in args[:2]), tcfg,
        bias=torch.from_numpy(bias), total_mass_scale=torch.tensor(args[3]),
        aggregate='sort')
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(want)).max())


def test_unported_routes_raise():
    rng = np.random.default_rng(5)
    ei = _edges(rng, 16)
    g = T.from_edge_index(ei, 16)
    X = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    conv = T.FSWConv(4, 4, minimize_slice_coherence=False, device='cpu')
    # a CSR Graph takes the CSR path: the same function as the tables'
    # rank route, up to float32 rounding
    with torch.no_grad():
        want = conv(X, T.to_multi_table(g))
        torch.testing.assert_close(conv(X, g), want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())
    # a graph given, W is ignored, as in the JAX package
    assert conv.fsw_embed(X, torch.ones(16, 16),
                          graph=T.to_multi_table(g)).shape == (
        16, conv.embed_cfg.d_out)
    # d_in + d_edge >= slices: 'rank' takes the unfused kernel K2
    wide = T.FSWConv(4, 4, embed_dim=4, minimize_slice_coherence=False,
                     device='cpu')
    got = wide(X, T.to_multi_table(g), aggregate='rank')
    assert got.shape == (16, 4) and torch.isfinite(got).all()
    assert wide(X, T.to_multi_table(g)).shape == (16, 4)   # 'auto': K2
    # the default minimize_slice_coherence=True builds: the same draws as
    # `conv`'s, coherence-minimized
    default = T.FSWConv(4, 4, device='cpu')
    with torch.no_grad():
        assert torch.isfinite(default(X, g)).all()
    assert (T.get_mutual_coherence(default.fsw_embed.proj_vecs.detach())
            < T.get_mutual_coherence(conv.fsw_embed.proj_vecs.detach()))


def test_generated_params_and_registry():
    """The port's own seeded initialization: reproducible from the
    generator, 'spread' frequencies equal to JAX's formula, unit-norm
    slice vectors; the registry and from_config."""
    from fsw_gnn_tpu_torch.registry import get_layer
    a = T.FSWConv(6, 5, mlp_layers=2, minimize_slice_coherence=False,
                  device='cpu', generator=torch.Generator().manual_seed(3))
    b = T.FSWConv.from_config(
        {'mlp_layers': 2, 'minimize_slice_coherence': False}, in_channels=6,
        out_channels=5, device='cpu',
        generator=torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    cfg = a.embed_cfg
    want = J.generate_freqs(jax.random.PRNGKey(0), J.FSWConfig(
        d_in=6, d_out=cfg.d_out, encode_total_mass=True,
        freqs_init='spread'), jnp.float32)
    np.testing.assert_allclose(a.fsw_embed.freqs.detach().numpy(),
                               np.asarray(want), rtol=1e-7)
    norms = torch.linalg.norm(a.fsw_embed.proj_vecs.detach(), dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms))
    assert get_layer('fsw_conv') is T.FSWConv
    with pytest.raises(ValueError, match='Invalid argument'):
        T.FSWConv.from_config({'no_such_arg': 1})


def test_lowclamp_passes_gradient_at_threshold():
    x = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64,
                     requires_grad=True)
    lowclamp(x, 1.0).sum().backward()
    assert x.grad.tolist() == [0.0, 1.0, 1.0]
