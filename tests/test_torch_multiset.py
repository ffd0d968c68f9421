"""The port's dense paths against the JAX package's: `fsw_embed_multiset`
(its rank, static-grid and sort routes), `fsw_embed_graph_dense`, the
bridged `FSWEmbedding` module, and the two slice-parameter helpers.

Inputs are drawn with numpy from seeds: batches with leading dims
(3, 2, 5) as in the reference demo, multisets of n = 7 .. 12 points with
zero weights among them, and rows whose total mass is below the threshold
(a phantom mass), so every total-mass encoding sees both cases.

Tolerances:
  * float64, sort and static-grid routes on both sides: rtol 1e-10, atol
    1e-12 * the output's scale (the same arithmetic up to summation order);
    gradients rtol 1e-8, atol 1e-10 * their scale.
  * float32, the rank route (the port's K2 plain version against JAX's
    Pallas kernel in interpret mode): |port - jax| <= 2e-5 * max|jax| +
    1e-4 * |jax| (JAX's polynomial trig against libm, and the two
    projections' rounding); gradients 1e-4 * their scale + 1e-4 * |jax|.
"""
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

LEAD = (3, 2, 5)

CFGS = {
    'plain': dict(d_out=9),
    'tm_log_homog': dict(d_out=9, encode_total_mass=True,
                         total_mass_encoding_method='homog',
                         total_mass_encoding_function='log'),
    'tm_sqrt_homog_alt': dict(d_out=9, encode_total_mass=True,
                              total_mass_encoding_method='homog_alt',
                              total_mass_encoding_function='sqrt',
                              total_mass_pad_thresh=3.0),
    'tm_identity_scaled': dict(d_out=10, encode_total_mass=True,
                               total_mass_encoding_scale=0.5),
    'cart_collapse': dict(n_slices=4, n_freqs=3, collapse_freqs=True,
                          encode_total_mass=True),
    'cart': dict(n_slices=4, n_freqs=3),
}


def _weights(rng, shape):
    """Nonnegative weights with zeros, every other multiset light (total
    mass below 1)."""
    W = np.abs(rng.standard_normal(shape)) * (rng.random(shape) < 0.8)
    W[..., 0] += 0.1
    W.reshape(-1, shape[-1])[::2] *= 0.05
    return W


def _setup(rng, cfg_kw, n=7, d=3, npdt=np.float64):
    jcfg, tcfg = JE.FSWConfig(d_in=d, **cfg_kw), TE.FSWConfig(d_in=d,
                                                                **cfg_kw)
    X = rng.standard_normal(LEAD + (n, d)).astype(npdt)
    W = _weights(rng, LEAD + (n,)).astype(npdt)
    V = rng.standard_normal((tcfg.nSlices, d)).astype(npdt)
    freqs = (rng.random(tcfg.nFreqs) * 4.0).astype(npdt)
    bias = rng.standard_normal(T.bias_shape(tcfg)).astype(npdt)
    tms = np.asarray(0.7, npdt)
    return jcfg, tcfg, X, W, (V, freqs, bias, tms)


def _jax(fn, jcfg, X, W, params, **kw):
    V, freqs, bias, tms = (jnp.asarray(a) for a in params)
    return fn(jnp.asarray(X), None if W is None else jnp.asarray(W), V,
              freqs, jcfg, bias=bias, total_mass_scale=tms, **kw)


def _port(fn, tcfg, X, W, params, **kw):
    V, freqs, bias, tms = (torch.from_numpy(np.asarray(a)) for a in params)
    X = X if isinstance(X, torch.Tensor) else torch.from_numpy(X)
    if W is not None and not isinstance(W, torch.Tensor):
        W = torch.from_numpy(W)
    return fn(X, W, V, freqs, tcfg, bias=bias, total_mass_scale=tms, **kw)


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize('cfg', sorted(CFGS))
@pytest.mark.parametrize('w', ['W', 'unit', 'uniform'])
def test_multiset_f64_sort_matches_jax(cfg, w):
    """The sort route (W given, or W=None in cartesian mode) and the
    static-grid route (W=None otherwise), float64."""
    rng = np.random.default_rng(1)
    jcfg, tcfg, X, W, params = _setup(rng, CFGS[cfg])
    W = W if w == 'W' else None
    kw = dict(w_mode='unit' if w == 'W' else w, aggregate='sort')
    want = _jax(JE.fsw_embed_multiset, jcfg, X, W, params, **kw)
    got = _port(TE.fsw_embed_multiset, tcfg, X, W, params, **kw)
    assert got.shape[:3] == LEAD
    _close(got, want, 1e-10, 1e-12)


@pytest.mark.parametrize('cfg', ['plain', 'tm_sqrt_homog_alt', 'cart'])
@pytest.mark.parametrize('w', ['W', 'uniform'])
def test_multiset_slice_chunk_matches_jax(cfg, w):
    """slice_chunk = 4 (padded last chunk) on the sort and static-grid
    routes, float64, against JAX's slice_chunk."""
    rng = np.random.default_rng(2)
    jcfg, tcfg, X, W, params = _setup(rng, CFGS[cfg])
    W = W if w == 'W' else None
    kw = dict(w_mode='uniform', aggregate='sort', slice_chunk=4)
    want = _jax(JE.fsw_embed_multiset, jcfg, X, W, params, **kw)
    _close(_port(TE.fsw_embed_multiset, tcfg, X, W, params, **kw), want,
           1e-10, 1e-12)


@pytest.mark.parametrize('cfg', ['plain', 'tm_log_homog',
                                 'tm_sqrt_homog_alt'])
@pytest.mark.parametrize('w', ['W', 'unit', 'uniform'])
@pytest.mark.parametrize('slice_chunk', [None, 4])
def test_multiset_f32_rank_matches_jax(cfg, w, slice_chunk):
    """float32: the port's 'rank' and 'auto' (n <= 128: the same K2 route)
    against JAX's 'rank'; W=None runs K2 with uniform_w."""
    rng = np.random.default_rng(3)
    jcfg, tcfg, X, W, params = _setup(rng, CFGS[cfg], n=12, d=4,
                                      npdt=np.float32)
    W = W if w == 'W' else None
    kw = dict(w_mode='unit' if w == 'W' else w, slice_chunk=slice_chunk)
    want = _jax(JE.fsw_embed_multiset, jcfg, X, W, params, aggregate='rank',
                **kw)
    for agg in ('rank', 'auto'):
        got = _port(TE.fsw_embed_multiset, tcfg, X, W, params, aggregate=agg,
                    **kw)
        _close(got, want, 1e-4, 2e-5)


def test_multiset_wide_auto_sorts():
    """n = 129 > 128: 'auto' takes the sort route, whatever the device;
    float64 against JAX's sort, and no rank kernel is called."""
    rng = np.random.default_rng(4)
    jcfg, tcfg, X, W, params = _setup(rng, CFGS['plain'], n=129)
    assert TE._resolve_aggregate('auto', tcfg, 129) == 'sort'
    assert TE._resolve_aggregate('auto', tcfg, 128) == 'rank'
    before = T.ops.fsw_rank.fsw_rank_aggregate.launches
    want = _jax(JE.fsw_embed_multiset, jcfg, X, W, params, aggregate='sort')
    _close(_port(TE.fsw_embed_multiset, tcfg, X, W, params), want, 1e-10,
           1e-12)
    assert T.ops.fsw_rank.fsw_rank_aggregate.launches == before


def _grads(jfn, tfn, jcfg, tcfg, X, W, params, G, **kw):
    """d/dX and d/dW of sum(out * G), JAX's and the port's."""
    def jloss(X, W):
        return jnp.sum(_jax(jfn, jcfg, X, W, params, **kw) * G)
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(X),
                                               jnp.asarray(W))
    Xt = torch.tensor(X, requires_grad=True)
    Wt = torch.tensor(W, requires_grad=True)
    (_port(tfn, tcfg, Xt, Wt, params, **kw) * torch.from_numpy(G)
     ).sum().backward()
    return (Xt.grad, jgx), (Wt.grad, jgw)


@pytest.mark.parametrize('cfg', ['tm_log_homog', 'cart_collapse'])
def test_multiset_grads_f64_sort_match_jax(cfg):
    rng = np.random.default_rng(5)
    jcfg, tcfg, X, W, params = _setup(rng, CFGS[cfg])
    G = rng.standard_normal(LEAD + (tcfg.out_dim,))
    for got, want in _grads(JE.fsw_embed_multiset, TE.fsw_embed_multiset,
                            jcfg, tcfg, X, W, params, G, aggregate='sort'):
        _close(got, want, 1e-8, 1e-10)


@pytest.mark.parametrize('weights_grad', [True, False])
def test_multiset_grads_f32_rank_match_jax(weights_grad):
    """The gradients of X and W through K2's plain backward (with_dw on
    with weights_grad, off without: W then gets only the total-mass
    encoding's gradient), float32, against JAX's rank route."""
    rng = np.random.default_rng(6)
    jcfg, tcfg, X, W, params = _setup(rng, CFGS['tm_log_homog'], n=12, d=4,
                                      npdt=np.float32)
    G = rng.standard_normal(LEAD + (tcfg.out_dim,)).astype(np.float32)
    for got, want in _grads(JE.fsw_embed_multiset, TE.fsw_embed_multiset,
                            jcfg, tcfg, X, W, params, G, aggregate='rank',
                            weights_grad=weights_grad):
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize('d_edge,edge_shape', [(0, None), (1, 'flat'),
                                               (2, 'full')])
@pytest.mark.parametrize('slice_chunk', [None, 4])
def test_graph_dense_f64_matches_jax(d_edge, edge_shape, slice_chunk):
    """Dense adjacency W (2, R, n) with zeros and light rows, X (2, n, 3),
    edge features (2, R, n) for d_edge 1 or (2, R, n, 2); forward and the
    gradients of X and W."""
    rng = np.random.default_rng(7)
    R, n = 5, 8
    kw = dict(d_out=9, encode_total_mass=True, d_edge=d_edge)
    jcfg, tcfg = JE.FSWConfig(d_in=3, **kw), TE.FSWConfig(d_in=3, **kw)
    X = rng.standard_normal((2, n, 3))
    W = _weights(rng, (2, R, n))
    Xe = (None if d_edge == 0 else rng.standard_normal(
        (2, R, n) + ((d_edge,) if edge_shape == 'full' else ())))
    params = (rng.standard_normal((tcfg.nSlices, 3 + d_edge)),
              rng.random(tcfg.nFreqs) * 4.0,
              rng.standard_normal(T.bias_shape(tcfg)), np.asarray(0.7))
    G = rng.standard_normal((2, R, tcfg.out_dim))
    ekw = dict(slice_chunk=slice_chunk)
    want = _jax(JE.fsw_embed_graph_dense, jcfg, X, W, params,
                X_edge=None if Xe is None else jnp.asarray(Xe), **ekw)
    got = _port(TE.fsw_embed_graph_dense, tcfg, X, W, params,
                X_edge=None if Xe is None else torch.from_numpy(Xe), **ekw)
    assert got.shape == (2, R, tcfg.out_dim)
    _close(got, want, 1e-10, 1e-12)
    if Xe is None:
        for got, want in _grads(JE.fsw_embed_graph_dense,
                                TE.fsw_embed_graph_dense, jcfg, tcfg, X, W,
                                params, G, **ekw):
            _close(got, want, 1e-8, 1e-10)


def test_fswembedding_module_matches_jax():
    """A JAX FSWEmbedding's variables (learnable slices and a learnable
    total-mass scale: both collections) carried into the port by
    `fswembedding_from_jax`: the multiset, W=None, graph_mode,
    NeighborTable and CSR Graph calls agree in float64."""
    rng = np.random.default_rng(8)
    kw = dict(d_in=3, d_out=11, encode_total_mass=True,
              learnable_slices=True,
              learnable_total_mass_encoding_scale=True)
    jcfg, tcfg = JE.FSWConfig(**kw), TE.FSWConfig(**kw)
    X = rng.standard_normal(LEAD + (7, 3))
    W = _weights(rng, LEAD + (7,))
    jm = JM.FSWEmbedding(jcfg, dtype=jnp.float64)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(W)))
    assert set(variables) == {'params', 'fsw_fixed'}
    tm = T.fswembedding_from_jax(variables, tcfg, device='cpu',
                                 dtype=torch.float64)
    for args, call in (((X, W), dict(aggregate='sort')),
                       ((X, None), dict(w_mode='uniform', aggregate='sort')),
                       ((X[0, 0], W[0, 0]), dict(aggregate='sort'))):
        want = jm.apply(variables, *(None if a is None else jnp.asarray(a)
                                     for a in args), **call)
        got = tm(*(None if a is None else torch.from_numpy(a)
                   for a in args), **call)
        _close(got, want, 1e-10, 1e-12)
    A = _weights(rng, (2, 4, 7))
    Xg = rng.standard_normal((2, 7, 3))
    want = jm.apply(variables, jnp.asarray(Xg), jnp.asarray(A),
                    graph_mode=True)
    got = tm(torch.from_numpy(Xg), torch.from_numpy(A), graph_mode=True)
    _close(got, want, 1e-10, 1e-12)

    ei = np.array([[1, 2, 3, 0], [0, 0, 1, 2]])
    table = T.to_neighbor_table(T.from_edge_index(ei, 4, dtype=np.float64))
    jt = J.to_neighbor_table(J.from_edge_index(ei, 4, dtype=jnp.float64))
    Xn = rng.standard_normal((4, 3))
    want_table = jm.apply(variables, jnp.asarray(Xn), graph=jt,
                          aggregate='sort')
    _close(tm(torch.from_numpy(Xn), graph=table, aggregate='sort'),
           want_table, 1e-10, 1e-12)
    # a CSR Graph takes the CSR path, as in the JAX module
    want = jax.jit(lambda x, g: jm.apply(variables, x, graph=g))(
        jnp.asarray(Xn), J.from_edge_index(ei, 4, dtype=jnp.float64))
    _close(tm(torch.from_numpy(Xn),
              graph=T.from_edge_index(ei, 4, dtype=np.float64)), want,
           1e-10, 1e-12)
    # the overlapped exchange with the identity exchange: the table path
    _close(tm(torch.from_numpy(Xn), graph=table, aggregate='sort',
              proj_gather_fn=lambda x: x, exchange_chunks=2), want_table,
           1e-10, 1e-12)
    with pytest.raises(ValueError, match='missing'):
        T.fswembedding_from_jax({'params': {}}, tcfg, device='cpu')


def test_fswembedding_zero_width_output():
    """out_dim == 0 gives zeros of the JAX module's shapes."""
    cfg = dict(d_in=3, d_out=0)
    jm = JM.FSWEmbedding(JE.FSWConfig(**cfg), dtype=jnp.float64)
    tm = T.FSWEmbedding(TE.FSWConfig(**cfg), device='cpu',
                        dtype=torch.float64)
    X = np.zeros(LEAD + (7, 3))
    A = np.ones((2, 4, 7))
    for args, call in (((X, X[..., 0]), {}),
                       ((X[0, 0, :2], A), dict(graph_mode=True))):
        want = jm.apply({}, *(jnp.asarray(a) for a in args), **call)
        got = tm(*(torch.from_numpy(a) for a in args), **call)
        assert tuple(got.shape) == want.shape and not got.any()
    ei = np.array([[1, 2, 3, 0], [0, 0, 1, 2]])
    want = jm.apply({}, jnp.zeros((4, 3)), graph=J.from_edge_index(ei, 4))
    got = tm(torch.zeros(4, 3, dtype=torch.float64),
             graph=T.from_edge_index(ei, 4))       # even a CSR Graph
    assert tuple(got.shape) == want.shape == (4, 0)


def test_spread_freqs_and_coherence_match_jax():
    rng = np.random.default_rng(9)
    freqs = rng.random(6)
    for center, radius in ((2.0, 1.5), (0.5, 0.0)):
        np.testing.assert_allclose(
            T.spread_freqs_at_interval(torch.from_numpy(freqs), center,
                                       radius).numpy(),
            np.asarray(JM.spread_freqs_at_interval(jnp.asarray(freqs),
                                                   center, radius)),
            rtol=1e-12, atol=1e-14)
    V = rng.standard_normal((5, 4))
    np.testing.assert_allclose(
        T.get_mutual_coherence(torch.from_numpy(V)).item(),
        float(JM.get_mutual_coherence(jnp.asarray(V))), rtol=1e-12)
