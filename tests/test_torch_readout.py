"""Readout and graph classification on the CSR path, and the GraphServer's
CSR route, against the JAX package with the same parameters.

Tolerances:
  * float64: 1e-10 of each output's scale (summation order only).
  * the servers, float32: |port - jax| <= 1e-4 * max|jax| + 1e-4 * |jax|,
    as tests/test_torch_serving.py: the JAX server's CSR route evaluates
    cos(pi f (2c - w)) on the unreduced phase in float32, the port's
    segmented cumsum sums in another order, and three Linear layers
    follow.  Against the port's own FSWConv on the same CSR graph: 1e-6
    of the scale (the same code; only the carrier round trip between).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import fsw_gnn_tpu as J
import fsw_gnn_tpu.serving as JSV
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch.registry import get_pooling


def _close(got, want, tol=1e-10):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _batch_of_graphs(rng, n_graphs, nodes_per_graph, d, p):
    """The shape of tests/test_graph_classifier.py: disjoint random graphs
    in one node space, class 1 three times as dense as class 0."""
    edges, graph_index, feats, labels = [], [], [], []
    offset = 0
    for gi in range(n_graphs):
        n = nodes_per_graph
        cls = gi % 2
        A = rng.random((n, n)) < p * (3 if cls else 1)
        np.fill_diagonal(A, False)
        s, t = np.nonzero(A)
        edges.append(np.stack([s + offset, t + offset]))
        graph_index.extend([gi] * n)
        feats.append(rng.standard_normal((n, d)))
        labels.append(cls)
        offset += n
    return (np.concatenate(edges, axis=1), np.asarray(graph_index),
            np.concatenate(feats), np.asarray(labels), offset)


def test_readout_graph_and_stack_match_jax():
    gi = np.repeat(np.arange(5), [3, 0, 4, 1, 2])
    jp = J.readout_graph(gi, gi.shape[0], 6, dtype=jnp.float64)
    tp = T.readout_graph(gi, gi.shape[0], 6, dtype=np.float64)
    for f in ('src', 'dst', 'weight', 'row_ptr', 'in_degrees', 'src_order',
              'src_sorted'):
        np.testing.assert_array_equal(getattr(tp, f),
                                      np.asarray(getattr(jp, f)), f)
    assert (tp.num_nodes, tp.num_recipients, tp.num_edges) == (
        jp.num_nodes, jp.num_recipients, jp.num_edges)
    assert T.readout_graph(gi, gi.shape[0]).num_recipients == 5
    with pytest.raises(ValueError, match='non-decreasing'):
        T.readout_graph(gi[::-1], gi.shape[0])
    g1 = T.from_edge_index(np.array([[0, 1], [1, 2]]), 4, pad_to=8)
    g2 = T.from_edge_index(np.array([[3], [0]]), 4, pad_to=8)
    st = T.stack_graphs([g1, g2])
    assert st.src.shape == (2, 8) and st.num_edges == 2
    with pytest.raises(ValueError, match='equal padded shapes'):
        T.stack_graphs([g1, T.from_edge_index(np.array([[3], [0]]), 4)])


def test_fswreadout_matches_jax():
    """FSWReadout on a readout graph, float64, with BatchNorm statistics:
    the output and the gradients of X and of the parameters."""
    rng = np.random.default_rng(1)
    gi = np.sort(rng.integers(0, 7, 60))
    X = rng.standard_normal((60, 5))
    jp = J.readout_graph(gi, 60, 7, dtype=jnp.float64)
    tp = T.readout_graph(gi, 60, 7, dtype=np.float64)
    kw = dict(in_channels=5, out_channels=4, mlp_layers=2,
              batchnorm_hidden=True, concat_self=True)
    jm = J.FSWReadout(minimize_slice_coherence=False, dtype=jnp.float64,
                      **kw)
    variables = jax.tree_util.tree_map(lambda a: np.array(a), jax.jit(
        jm.init)(jax.random.PRNGKey(0), jnp.asarray(X), jp))
    # float64 running statistics (flax keeps float32 ones by default)
    bn = variables['batch_stats']['head']['bn_0']
    bn['mean'] = rng.standard_normal(bn['mean'].shape)
    bn['var'] = 0.5 + rng.random(bn['var'].shape)
    tm = T.fswreadout_from_jax(variables, device='cpu', dtype=torch.float64,
                               **kw).eval()
    assert get_pooling('fsw_readout') is T.FSWReadout
    assert tm.head.dense[0].in_features == tm.embed_cfg.d_out
    G = rng.standard_normal((7, 4))

    def jloss(params, x):
        out = jm.apply({**variables, 'params': params}, x, jp)
        return jnp.sum(out * G), out
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables['params'],
                                              jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = tm(Xt, tp)
    (out * torch.from_numpy(G)).sum().backward()
    _close(out, want)
    _close(Xt.grad, gx)
    _close(tm.fsw_embed.proj_vecs.grad, gp['fsw_embed']['proj_vecs'])
    _close(tm.head.dense[1].weight.grad.t(), gp['head']['dense_1']['kernel'])
    with pytest.raises(ValueError, match='edgefeat_dim'):
        T.FSWReadout(5, 4, edgefeat_dim=2, minimize_slice_coherence=False,
                     device='cpu')


def _classifier(f64):
    rng = np.random.default_rng(0)
    n_graphs, npg, d = 12, 12, 6
    ei, gi, X, y, n = _batch_of_graphs(rng, n_graphs, npg, d, p=0.08)
    npdt, jdt = ((np.float64, jnp.float64) if f64
                 else (np.float32, jnp.float32))
    X = X.astype(npdt)
    jg = J.from_edge_index(ei, n, dtype=jdt)
    jp = J.readout_graph(gi, n, n_graphs, dtype=jdt)
    tg = T.from_edge_index(ei, n, dtype=npdt)
    tp = T.readout_graph(gi, n, n_graphs, dtype=npdt)
    kw = dict(in_channels=d, hidden_dims=(8,), num_classes=2)
    jm = J.FSWGraphClassifier(minimize_slice_coherence=False, dtype=jdt,
                              **kw)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(X), jg, jp))
    tm = T.fswgraphclassifier_from_jax(
        variables, device='cpu',
        dtype=torch.float64 if f64 else torch.float32, **kw)
    return jm, variables, tm, X, y, (jg, jp), (tg, tp)


def test_graph_classifier_logits_match_jax():
    """Logits and first gradients through the bridge, float64."""
    jm, variables, tm, X, y, (jg, jp), (tg, tp) = _classifier(True)
    yj = jnp.asarray(y)

    def jloss(params):
        lg = jm.apply({**variables, 'params': params}, jnp.asarray(X), jg,
                      jp)
        return optax.softmax_cross_entropy_with_integer_labels(
            lg, yj).mean(), lg
    (_, want), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables['params'])
    logits = tm(torch.from_numpy(X), tg, tp)
    torch.nn.functional.cross_entropy(logits,
                                      torch.from_numpy(y)).backward()
    _close(logits, want)
    _close(tm.cls_head.weight.grad.t(), grads['cls_head']['kernel'])
    _close(tm.readout.fsw_embed.proj_vecs.grad,
           grads['readout']['fsw_embed']['proj_vecs'])
    _close(tm.gnn.convs[0].fsw_embed.freqs.grad,
           grads['gnn']['conv_0']['fsw_embed']['freqs'])


def test_graph_classifier_learns():
    """A few Adam(1e-2) steps lower the loss (float32), as in
    tests/test_graph_classifier.py; the port's own initialization draws
    a LeCun-normal head."""
    _, _, tm, X, y, _, (tg, tp) = _classifier(False)
    fresh = T.FSWGraphClassifier(6, (8,), 2, minimize_slice_coherence=False,
                                 device='cpu')
    w = fresh.cls_head.weight
    assert w.abs().max() <= 2.0 / np.sqrt(8) / 0.8796 + 1e-6
    assert not fresh.cls_head.bias.any()
    for model in (tm, fresh):
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
        losses = []
        for _ in range(6):
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(Xt, tg, tp), yt)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---- the GraphServer's CSR route -----------------------------------------

MAX_NODES, MAX_EDGES, D_IN, D_OUT = 64, 1024, 8, 8


def _request(seed, n, d_edge=0):
    r = np.random.default_rng(seed)
    A = r.random((n, n)) < 0.12
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    X = r.standard_normal((n, D_IN)).astype(np.float32)
    ef = (r.standard_normal((ei.shape[1], d_edge)).astype(np.float32)
          if d_edge else None)
    return ei, X, ef


@pytest.fixture(scope='module', params=[0, 2])
def models(request):
    d_edge = request.param
    ei0, X0, ef0 = _request(0, MAX_NODES, d_edge)
    jg0 = J.from_edge_index(ei0, MAX_NODES, ef0)
    classes, rows = JSV.multi_envelope(jg0, MAX_NODES)
    kw = dict(in_channels=D_IN, out_channels=D_OUT, edgefeat_dim=d_edge,
              mlp_layers=3)
    jm = J.FSWConv(minimize_slice_coherence=False, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X0),
                        J.to_multi_table(jg0))
    tm = T.fswconv_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                            device='cpu', **kw)
    return jm, variables, tm, d_edge, dict(classes=classes, class_rows=rows)


def _check_against_conv(ts, tm, req, got):
    """The served output equals the port's FSWConv on the request's padded
    CSR graph."""
    ei, X, ef = req
    g = T.from_edge_index(ei, MAX_NODES, edge_features=ef,
                          pad_to=MAX_EDGES)
    Xp = np.zeros((MAX_NODES, D_IN), np.float32)
    Xp[:X.shape[0]] = X
    with torch.no_grad():
        want = tm.eval()(torch.from_numpy(Xp), g)[:X.shape[0]].numpy()
    _close(got, want, 1e-6)


def test_server_without_classes_serves_csr(models):
    jm, variables, tm, d_edge, _ = models
    js = JSV.GraphServer(jm, variables, MAX_NODES, MAX_EDGES, d_edge=d_edge)
    ts = T.GraphServer(tm, MAX_NODES, MAX_EDGES, d_edge=d_edge,
                       device='cpu')
    reqs = [_request(s, n, d_edge) for s, n in [(1, 64), (2, 23)]]
    outs = ts.predict_many(reqs, window=2)
    for req, got in zip(reqs, outs):
        _close(got, js.predict(req[0], req[1], edge_features=req[2]), 1e-4)
        _check_against_conv(ts, tm, req, got)
    assert ts.fallbacks == ts.uniform_w_fallbacks == 0


def test_server_csr_fallbacks_are_counted(models):
    """With an envelope: a hub wider than the widest class goes through
    CSR and counts in `fallbacks`; under assume_uniform_w a duplicate edge
    (coalesced weight 2) goes through CSR and counts in
    `uniform_w_fallbacks`.  Warmup serves one request of each route and
    counts nothing."""
    jm, variables, tm, d_edge, env = models
    js = JSV.GraphServer(jm, variables, MAX_NODES, MAX_EDGES, d_edge=d_edge,
                       assume_uniform_w=True, **env)
    ts = T.GraphServer(tm, MAX_NODES, MAX_EDGES, d_edge=d_edge,
                       assume_uniform_w=True, device='cpu', **env)
    ts.warmup(D_IN)
    assert ts.fallbacks == ts.uniform_w_fallbacks == 0
    d = ts.classes[-1] + 1
    r = np.random.default_rng(7)
    hub = (np.stack([np.arange(1, d + 1), np.zeros(d, np.int64)]),
           r.standard_normal((d + 1, D_IN)).astype(np.float32),
           r.standard_normal((d, d_edge)).astype(np.float32)
           if d_edge else None)
    ei, X, ef = _request(4, 30, d_edge)
    ei = np.concatenate([ei, ei[:, :1]], axis=1)
    if ef is not None:
        ef = np.concatenate([ef, ef[:1]], axis=0)
    dup = (ei, X, ef)
    for req, counter in ((hub, 'fallbacks'), (dup, 'uniform_w_fallbacks')):
        before = getattr(ts, counter)
        got = ts.predict(*req)
        want = js.predict(req[0], req[1], edge_features=req[2])
        assert getattr(ts, counter) == before + 1
        assert getattr(js, counter) == 1
        _close(got, want, 1e-4)
        _check_against_conv(ts, tm, req, got)
