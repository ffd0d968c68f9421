"""The CSR graph path of the port (`fsw_embed_graph`, `_batched`,
`FSWEmbedding` and `FSWConv` on a `Graph`, `auto_layout`'s CSR branch)
against the JAX package on the same numpy inputs and the same parameters.

Tolerances:
  * float64 (the JAX package's CSR path runs in the graph's dtype):
    |port - jax| <= 1e-10 * max|jax| + 1e-10 * |jax|, for outputs and for
    gradients.  Both sort alike (stable, ties by index) and restart the
    cumsum at every recipient; what differs is summation order.
  * float32, FSWConv forward: 1e-4 of the output's scale.  The cumsum's
    summation order differs (JAX's associative scan against the port's
    doubling scan), which moves c by an ulp; the 'spread' frequencies turn
    that into about 1e-6 of the scale here, and three Linear layers follow.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu.embedding as JE
import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.embedding as TE

N, D_IN = 40, 4


def _close(got, want, tol=1e-10):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _edges(rng, n, p_max=0.4):
    """Random in-degrees 0 .. ~16; node 1 receives nothing."""
    p = np.linspace(0.0, p_max, n)[rng.permutation(n)]
    A = rng.random((n, n)) < p[None, :]
    np.fill_diagonal(A, False)
    A[:, 1] = False
    return np.stack(np.nonzero(A)).astype(np.int64)


def _graphs(ei, n, d_edge=0, seed=0, **kw):
    rng = np.random.default_rng(seed)
    ef = rng.standard_normal((ei.shape[1], d_edge)) if d_edge else None
    return (J.from_edge_index(ei, n, ef, dtype=jnp.float64, **kw),
            T.from_edge_index(ei, n, ef, dtype=np.float64, **kw))


def _embed_pair(cfg_kw, jg, tg, X, rng, slice_chunk=None, dyadic=False):
    jc, tc = JE.FSWConfig(**cfg_kw), TE.FSWConfig(**cfg_kw)
    S = tc.nSlices
    V = rng.standard_normal((S, tc.proj_dim))
    f = rng.random(tc.nFreqs) * 6
    if dyadic:                 # projections on a coarse grid: many ties
        V = np.round(V)
        X = np.round(X * 2) / 2
    flat = not tc.cartesian_mode or tc.collapse_freqs
    bias = rng.standard_normal(tc.out_dim if flat else (S, tc.nFreqs))
    jfe = jax.jit(functools.partial(JE.fsw_embed_graph, cfg=jc,
                                    slice_chunk=slice_chunk))
    want = jfe(jnp.asarray(X), jg, jnp.asarray(V), jnp.asarray(f),
               bias=jnp.asarray(bias))
    got = TE.fsw_embed_graph(torch.from_numpy(X), tg, torch.from_numpy(V),
                             torch.from_numpy(f), tc,
                             bias=torch.from_numpy(bias),
                             slice_chunk=slice_chunk)
    return got, want


CASES = {
    'unit': (dict(d_in=D_IN, d_out=9), {}),
    'gcn, self-loops, total mass': (
        dict(d_in=D_IN, d_out=9, encode_total_mass=True,
             total_mass_encoding_function='sqrt'),
        dict(self_loop_weight=1.0, edge_weighting='gcn')),
    'weighted, phantom mass, homog': (
        dict(d_in=D_IN, d_out=8, encode_total_mass=True,
             total_mass_encoding_method='homog', total_mass_pad_thresh=4.0),
        dict(self_loop_weight=0.5)),
    'edge features': (dict(d_in=D_IN, d_out=7, d_edge=2), {}),
    'cartesian': (dict(d_in=D_IN, n_slices=5, n_freqs=3), {}),
    'cartesian, collapsed, total mass': (
        dict(d_in=D_IN, n_slices=4, n_freqs=3, collapse_freqs=True,
             encode_total_mass=True), {}),
}


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('slice_chunk', [None, 3])
def test_fsw_embed_graph_matches_jax(case, slice_chunk):
    """Padding (E padded to 128), an empty recipient (node 1), unit / gcn /
    self-loop weights, edge features, total mass, cartesian mode, chunked
    slices: float64, 1e-10 of the scale."""
    cfg_kw, g_kw = CASES[case]
    rng = np.random.default_rng(len(case))
    ei = _edges(rng, N)
    jg, tg = _graphs(ei, N, cfg_kw.get('d_edge', 0), **g_kw)
    assert tg.padded_num_edges > tg.num_edges
    X = rng.standard_normal((N, D_IN))
    got, want = _embed_pair(cfg_kw, jg, tg, X, rng, slice_chunk)
    _close(got, want)


def test_fsw_embed_graph_tied_projections():
    """Projections on an integer grid tie often; the stable sort breaks the
    ties by edge index on both sides, and c depends on that order."""
    rng = np.random.default_rng(11)
    ei = _edges(rng, N, 0.6)
    w = rng.random(ei.shape[1]) + 0.5              # unequal weights
    jg, tg = _graphs(ei, N, edge_weight=w)
    X = rng.standard_normal((N, D_IN))
    got, want = _embed_pair(dict(d_in=D_IN, d_out=6), jg, tg, X, rng,
                            dyadic=True)
    _close(got, want)


def test_fsw_embed_graph_batched_matches_jax():
    """Six graphs stacked, with leading batch dims (2, 3): one
    block-diagonal CSR graph on the port's side."""
    rng = np.random.default_rng(2)
    n, G = 12, 6
    pairs = []
    for g in range(G):
        ei = _edges(rng, n, 0.5)
        pairs.append(_graphs(ei, n, 2, seed=g, pad_to=160))
    jst = J.stack_graphs([p[0] for p in pairs])
    tst = T.stack_graphs([p[1] for p in pairs])
    np.testing.assert_array_equal(tst.src, np.asarray(jst.src))
    cfg_kw = dict(d_in=3, d_out=7, d_edge=2, encode_total_mass=True)
    jc, tc = JE.FSWConfig(**cfg_kw), TE.FSWConfig(**cfg_kw)
    V = rng.standard_normal((7 - 1, 5))
    f = rng.random(6) * 4
    X = rng.standard_normal((2, 3, n, 3))
    want = JE.fsw_embed_graph_batched(jnp.asarray(X), jst, jnp.asarray(V),
                                      jnp.asarray(f), jc, slice_chunk=4)
    got = TE.fsw_embed_graph_batched(torch.from_numpy(X), tst,
                                     torch.from_numpy(V), torch.from_numpy(f),
                                     tc, slice_chunk=4)
    assert tuple(got.shape) == (2, 3, n, 7)
    _close(got, want)
    with pytest.raises(ValueError, match='stacked graph count'):
        TE.fsw_embed_graph_batched(torch.from_numpy(X[0]), tst,
                                   torch.from_numpy(V), torch.from_numpy(f),
                                   tc)


def _conv_setup(f64, seed=0, d_edge=0):
    rng = np.random.default_rng(seed)
    n = 48
    ei = _edges(rng, n)
    npdt = np.float64 if f64 else np.float32
    jdt = jnp.float64 if f64 else jnp.float32
    ef = rng.standard_normal((ei.shape[1], d_edge)) if d_edge else None
    jg = J.from_edge_index(ei, n, ef, dtype=jdt, self_loop_weight=1.0)
    tg = T.from_edge_index(ei, n, ef, dtype=npdt, self_loop_weight=1.0)
    X = rng.standard_normal((n, 6)).astype(npdt)
    kw = dict(in_channels=6, out_channels=5, edgefeat_dim=d_edge,
              mlp_layers=2)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jdt, **kw)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                     jnp.asarray(X), jg))
    tm = T.fswconv_from_jax(variables, device='cpu',
                            dtype=torch.float64 if f64 else torch.float32,
                            **kw)
    return jm, variables, tm, X, jg, tg, rng


@pytest.mark.parametrize('d_edge,slice_chunk', [(0, None), (3, 4)])
def test_fswconv_on_graph_forward_and_gradients_match_jax(d_edge,
                                                          slice_chunk):
    """FSWConv on a CSR Graph, float64: the output, the gradients of every
    parameter and of X, and the gradient of the edge weights (which runs
    the segmented cumsum's backward) against jax.grad."""
    jm, variables, tm, X, jg, tg, rng = _conv_setup(True, d_edge=d_edge)
    G = rng.standard_normal((X.shape[0], 5))

    def jloss(params, x, w):
        g = dataclasses.replace(jg, weight=w)
        out = jm.apply({**variables, 'params': params}, x, g,
                       slice_chunk=slice_chunk)
        return jnp.sum(out * G), out
    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        variables['params'], jnp.asarray(X), jg.weight)
    Xt = torch.from_numpy(X).requires_grad_(True)
    tg = tg.to('cpu')
    tg.weight = tg.weight.clone().requires_grad_(True)
    out = tm(Xt, tg, slice_chunk=slice_chunk)
    (out * torch.from_numpy(G)).sum().backward()
    _close(out, want)
    _close(Xt.grad, grads[1])
    _close(tg.weight.grad, grads[2])
    jp = grads[0]
    _close(tm.fsw_embed.proj_vecs.grad, jp['fsw_embed']['proj_vecs'])
    _close(tm.fsw_embed.freqs.grad, jp['fsw_embed']['freqs'])
    for i, layer in enumerate(tm.head.dense):
        _close(layer.weight.grad.t(), jp['head'][f'dense_{i}']['kernel'])
        _close(layer.bias.grad, jp['head'][f'dense_{i}']['bias'])


def test_fswembedding_module_on_graph_matches_jax():
    """FSWEmbedding dispatches a Graph to the CSR path, as the JAX
    module does (float64)."""
    import fsw_gnn_tpu.modules as JM
    rng = np.random.default_rng(6)
    ei = _edges(rng, N)
    jg, tg = _graphs(ei, N, self_loop_weight=1.0)
    cfg = dict(d_in=D_IN, d_out=10, encode_total_mass=True)
    jm = JM.FSWEmbedding(JE.FSWConfig(**cfg), dtype=jnp.float64)
    X = rng.standard_normal((N, D_IN))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k, x, g: jm.init(k, x, graph=g))(
            jax.random.PRNGKey(0), jnp.asarray(X), jg))
    tm = T.fswembedding_from_jax(variables, TE.FSWConfig(**cfg),
                                 device='cpu', dtype=torch.float64)
    want = jax.jit(lambda x, g: jm.apply(variables, x, graph=g))(
        jnp.asarray(X), jg)
    _close(tm(torch.from_numpy(X), graph=tg), want)


def test_fswconv_on_graph_f32_matches_jax():
    """float32 end to end (the port's single-key sort route): 1e-4 of the
    output's scale."""
    jm, variables, tm, X, jg, tg, _ = _conv_setup(False, seed=3)
    want = jax.jit(lambda x, g: jm.apply(variables, x, g))(jnp.asarray(X),
                                                          jg)
    with torch.no_grad():
        got = tm(torch.from_numpy(X), tg)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


def test_auto_layout_returns_the_graph_above_max_bucket():
    """A node with 4097 in-edges: both packages keep the CSR Graph (the
    default max_bucket is 4096), and FSWConv runs on it."""
    n = 4200
    ei = np.stack([np.arange(1, 4098), np.zeros(4097, np.int64)])
    jl = J.auto_layout(J.from_edge_index(ei, n))
    tg = T.from_edge_index(ei, n)
    assert isinstance(jl, J.Graph)
    assert T.auto_layout(tg) is tg
    wide = J.auto_layout(J.from_edge_index(ei, n), max_bucket=4097)
    assert type(T.auto_layout(tg, max_bucket=4097)).__name__ == \
        type(wide).__name__ == 'MultiTable'
    conv = T.FSWConv(3, 4, minimize_slice_coherence=False, device='cpu')
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 3)).astype(np.float32))
    out = conv(X, T.auto_layout(tg))
    assert out.shape == (n, 4) and torch.isfinite(out).all()
