"""The port's GraphServer (on the CPU) against the JAX package's
GraphServer, both on the same multi_envelope, with the same FSWConv
variables carried across by the bridge.

Tolerance: |port - jax| <= 1e-4 * max|jax| + 1e-4 * |jax| (float32).  On
the CPU the JAX server's 'auto' takes the sort path, which evaluates
cos(pi f (2c - w)) on the unreduced phase (f reaches 2S - 1 = 29 here, so
its float32 rounding is about 1e-5 rad), while the port takes the rank
route with exact period reduction; three Linear layers follow.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu.serving as JS
import fsw_gnn_tpu_torch as T

MAX_NODES, MAX_EDGES, D_IN, D_OUT = 64, 1024, 8, 8


def _simple_graph(rng, n, p=0.12):
    A = rng.random((n, n)) < p
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    return np.stack([src, dst]).astype(np.int64)


def _request(seed, n, d_edge):
    r = np.random.default_rng(seed)
    ei = _simple_graph(r, n)
    X = r.standard_normal((n, D_IN)).astype(np.float32)
    ef = (r.standard_normal((ei.shape[1], d_edge)).astype(np.float32)
          if d_edge else None)
    return ei, X, ef


@pytest.fixture(scope='module', params=[0, 2])
def servers(request):
    d_edge = request.param
    ei0, X0, ef0 = _request(0, MAX_NODES, d_edge)
    jg0 = J.from_edge_index(ei0, MAX_NODES, ef0)
    classes, rows = JS.multi_envelope(jg0, MAX_NODES)
    assert (classes, rows) == T.multi_envelope(
        T.from_edge_index(ei0, MAX_NODES, ef0), MAX_NODES)
    kw = dict(in_channels=D_IN, out_channels=D_OUT, edgefeat_dim=d_edge,
              mlp_layers=3)
    jm = J.FSWConv(minimize_slice_coherence=False, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X0),
                        J.to_multi_table(jg0))
    tm = T.fswconv_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                            device='cpu', **kw)
    env = dict(d_edge=d_edge, classes=classes, class_rows=rows,
               assume_uniform_w=True)
    js = JS.GraphServer(jm, variables, MAX_NODES, MAX_EDGES, **env)
    ts = T.GraphServer(tm, MAX_NODES, MAX_EDGES, device='cpu', **env)
    return js, ts, d_edge


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_server_matches_jax_server(servers):
    js, ts, d_edge = servers
    reqs = [_request(s, n, d_edge) for s, n in [(1, 64), (2, 41), (3, 17)]]
    wants = []
    for ei, X, ef in reqs:
        want = js.predict(ei, X, edge_features=ef)
        got = ts.predict(ei, X, edge_features=ef)
        assert got.shape == (X.shape[0], D_OUT) and got.dtype == np.float32
        _close(got, want)
        wants.append(want)
    outs = ts.predict_many(reqs, window=2)
    for got, want in zip(outs, wants):
        _close(got, want)
    assert js.fallbacks == ts.fallbacks == 0
    assert js.uniform_w_fallbacks == ts.uniform_w_fallbacks == 0


def test_duplicate_edge_is_counted_then_raises(servers):
    """A duplicate edge coalesces to weight 2: the row is no longer
    row-constant, the host check catches it, the request is counted and,
    with no CSR route to take it, refused."""
    _, ts, d_edge = servers
    ei, X, ef = _request(4, 30, d_edge)
    ei = np.concatenate([ei, ei[:, :1]], axis=1)
    if ef is not None:
        ef = np.concatenate([ef, ef[:1]], axis=0)
    before = ts.uniform_w_fallbacks
    with pytest.raises(NotImplementedError, match='item 7'):
        ts.predict(ei, X, edge_features=ef)
    assert ts.uniform_w_fallbacks == before + 1


def test_envelope_overflow_raises(servers):
    """A hub whose degree exceeds the widest class overflows the
    envelope: counted in `fallbacks` and refused."""
    _, ts, d_edge = servers
    d = ts.classes[-1] + 1
    ei = np.stack([np.arange(1, d + 1), np.zeros(d, np.int64)])
    X = np.zeros((d + 1, D_IN), np.float32)
    ef = np.zeros((d, d_edge), np.float32) if d_edge else None
    before = ts.fallbacks
    with pytest.raises(NotImplementedError, match='CSR'):
        ts.predict(ei, X, edge_features=ef)
    assert ts.fallbacks == before + 1


def test_warmup_and_request_checks(servers):
    _, ts, d_edge = servers
    ts.warmup(D_IN)
    with pytest.raises(ValueError, match='nodes'):
        ts.predict(np.zeros((2, 0), np.int64),
                   np.zeros((MAX_NODES + 1, D_IN), np.float32))


def test_server_needs_an_envelope():
    conv = T.FSWConv(4, 4, minimize_slice_coherence=False, device='cpu')
    with pytest.raises(NotImplementedError, match='item 7'):
        T.GraphServer(conv, 16, 64, device='cpu')
