"""The port's GraphServer's dtypes and transfer layouts against the JAX
package's GraphServer on the CPU, one FSWGNN's variables carried across by
the bridge.  Each test mirrors one of tests/test_serving.py (the edge
features' packed paths, warmup, bf16, the bit-exact pack, float64's
'triple' layout, uint16 indices off on big envelopes, the layout knobs).

Tolerances.  float32 and float64 servers against the JAX server:
|port - jax| <= 1e-4 max|jax| + 1e-4 |jax|, as tests/test_torch_serving.py
(the JAX float64 server's model computes in float32 too: flax's
Dense(dtype=float32)).  bfloat16: the JAX server runs its forward jitted,
and XLA on the CPU keeps fused chains of bfloat16 elementwise ops in
float32, while JAX op by op (`apply` outside jit) rounds every op to
bfloat16; the two JAX runs part by about 3e-2 of the output's scale here.
The port rounds op by op, so its bfloat16 server is held to the f32
tolerance against JAX's model applied op by op to the same bfloat16
request (both on the rank route, JAX's in interpret mode), and to 5e-2
of the scale (the JAX test's own bfloat16 tolerance) against the JAX
server.  One op differs by design: the CSR route's segmented cumsum of
2-byte weights, which K3 sums in float32 and rounds once (it has float32
and float64 kernels; no two scan orders round bfloat16 partial sums
alike), so for that comparison the JAX scan is made to do the same
(`_f32_scan`; nothing in the JAX package changes).  Pack round trips and
the layout knobs: bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu.serving as JS
import fsw_gnn_tpu_torch as T

D_IN, DIMS, D_E = 5, (6, 3), 3
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16),
          'float64': (jnp.float64, torch.float64)}


def _graph(rng, n, p=0.2):
    A = rng.random((n, n)) < p
    np.fill_diagonal(A, False)
    src, dst = np.nonzero(A)
    return np.stack([src, dst]).astype(np.int64)


def _request(seed, n, d_edge=0):
    r = np.random.default_rng(seed)
    ei = _graph(r, n)
    X = r.standard_normal((n, D_IN)).astype(np.float32)
    ef = (r.standard_normal((ei.shape[1], d_edge)).astype(np.float32)
          if d_edge else None)
    return ei, X, ef


@pytest.fixture(scope='module', params=[0, D_E], ids=['plain', 'edge_feat'])
def models(request):
    """(JAX model with aggregate='rank', its variables, the port's model,
    the envelope) of an FSWGNN, with or without edge features."""
    d_edge = request.param
    ei0, X0, ef0 = _request(0, 24, d_edge)
    g0 = J.from_edge_index(ei0, 24, edge_features=ef0)
    kw = dict(in_channels=D_IN, hidden_dims=DIMS, edgefeat_dim=d_edge,
              minimize_slice_coherence=False, aggregate='rank')
    jm = J.FSWGNN(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X0), g0)
    tm = T.fswgnn_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                           device='cpu', **kw)
    return jm, variables, tm, JS.multi_envelope(g0, 48), d_edge


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.fixture
def _f32_scan(monkeypatch):
    """JAX's CSR scan of 2-byte weights summed in float32 and rounded
    once, as the port's K3 does (see the module docstring)."""
    import fsw_gnn_tpu.embedding as JE
    scan = JE.segment_cumsum

    def f32_scan(values, *args, **kw):
        if values.dtype.itemsize != 2:
            return scan(values, *args, **kw)
        return scan(values.astype(jnp.float32), *args, **kw).astype(
            values.dtype)
    monkeypatch.setattr(JE, 'segment_cumsum', f32_scan)


def _op_by_op(jm, variables, req, dtype, env=None):
    """JAX's model applied outside jit to the request padded to the
    server's envelope (48 nodes, 1024 edges) in `dtype`: its MultiTable
    with `env`, else its CSR graph."""
    ei, X, ef = req
    Xp = np.zeros((48, D_IN), np.float32)
    Xp[:X.shape[0]] = X
    g = J.from_edge_index(ei, 48, edge_features=ef, pad_to=1024,
                          dtype=dtype)
    if env is not None:
        g = J.to_multi_table(g, classes=env[0], class_rows=env[1])
    out = jm.apply(variables, jnp.asarray(Xp, dtype), g)
    return np.asarray(out, np.float32)[:X.shape[0]]


@pytest.mark.parametrize('route', ['multi', 'csr'])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_server_dtypes_match_jax_server(models, dtype, route, _f32_scan):
    """float32, bfloat16 and float64 servers, each route, against the JAX
    server of the same dtype: the same layout (single or triple, uint16
    indices or not), outputs within the module docstring's tolerance,
    one graph a route (num_compiles 1, as the JAX server's compiles)."""
    jm, variables, tm, (classes, rows), d_edge = models
    jdt, tdt = DTYPES[dtype]
    env = dict(classes=classes, class_rows=rows) if route == 'multi' else {}
    js = JS.GraphServer(jm, variables, 48, 1024, dtype=jdt, d_edge=d_edge,
                        **env)
    ts = T.GraphServer(tm, 48, 1024, dtype=tdt, d_edge=d_edge,
                       device='cpu', **env)
    assert (ts._single, ts._idx16) == (js._single_buffer, js._idx16)
    for seed, n in [(1, 24), (2, 17)]:
        req = _request(seed, n, d_edge)
        want = js.predict(*req[:2], edge_features=req[2])
        got = ts.predict(*req[:2], edge_features=req[2])
        assert got.shape == (n, DIMS[-1])
        if dtype == 'bfloat16':
            _close(got, want, 5e-2)
            _close(got, _op_by_op(jm, variables, req, jdt,
                                  (classes, rows) if env else None))
        else:
            _close(got, want)
    assert ts.num_compiles() == js.num_compiles() == 1
    assert ts.fallbacks == js.fallbacks == 0


LAYOUTS = [('auto', None), ('auto', True), ('auto', False),
           ('single', None), ('single', False), ('triple', None),
           ('triple', True)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_transfer_layout_knobs_bit_identical(models, dtype):
    """Every transfer_layout x pack_indices case: the same flags as the JAX
    server's, and the same output bits (pure re-encodings of one
    request), one graph each."""
    jm, variables, tm, (classes, rows), d_edge = models
    jdt, tdt = DTYPES[dtype]
    env = dict(classes=classes, class_rows=rows, d_edge=d_edge)
    req = _request(3, 30, d_edge)
    outs = []
    for layout, pack in LAYOUTS:
        js = JS.GraphServer(jm, variables, 48, 1024, dtype=jdt,
                            transfer_layout=layout, pack_indices=pack, **env)
        ts = T.GraphServer(tm, 48, 1024, dtype=tdt, transfer_layout=layout,
                           pack_indices=pack, device='cpu', **env)
        assert (ts._single, ts._idx16) == (js._single_buffer, js._idx16)
        outs.append(ts.predict(*req[:2], edge_features=req[2]))
        assert ts.num_compiles() == 1
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_invalid_layout_knobs_raise(models):
    """The JAX server's refusals: uint16 indices forced on a big
    envelope, the single carrier for an 8-byte dtype or for a 2-byte one
    of one node, an unknown layout or dtype."""
    tm = models[2]
    with pytest.raises(ValueError, match='65535'):
        T.GraphServer(tm, 128, 70000, pack_indices=True, device='cpu')
    with pytest.raises(ValueError, match='single carrier'):
        T.GraphServer(tm, 48, 1024, dtype=torch.float64,
                      transfer_layout='single', device='cpu')
    with pytest.raises(ValueError, match='single carrier'):
        T.GraphServer(tm, 1, 16, dtype=torch.bfloat16,
                      transfer_layout='single', device='cpu')
    assert not T.GraphServer(tm, 1, 16, dtype=torch.bfloat16,
                             device='cpu')._single
    with pytest.raises(ValueError, match='transfer_layout'):
        T.GraphServer(tm, 48, 1024, transfer_layout='double', device='cpu')
    with pytest.raises(ValueError, match='dtype'):
        T.GraphServer(tm, 48, 1024, dtype=torch.int32, device='cpu')


@pytest.mark.parametrize('dtype,pack', [('float32', None),
                                        ('float32', False),
                                        ('bfloat16', None),
                                        ('float16', None)])
def test_single_buffer_pack_is_bit_exact(models, dtype, pack):
    """The carrier's round trip, packed on the host and taken apart on the
    device's side, gives back every bit: NaN, infinities, -0.0 and
    denormal weights (of the dtype), indices up to the envelope, X.  The
    2-byte floats are compared as the dtype's bits of the float32 input
    rounded to nearest, the JAX package's numpy cast."""
    tm = models[2]
    tdt = getattr(torch, dtype)
    ts = T.GraphServer(tm, 16, 64, dtype=tdt, pack_indices=pack,
                       device='cpu')
    rng = np.random.default_rng(12)
    li, lf = ts._li_csr, ts._lf_csr
    ibuf = (np.arange(li) % 65).astype(np.int32)
    fvals = np.array([0.0, -0.0, 1.5, np.inf, -np.inf, np.nan,
                      np.float32(1e-42), 3.14, np.float32(1e-39)],
                     np.float32)
    fbuf = np.resize(fvals, lf).astype(np.float32)
    Xp = rng.standard_normal((16, 3)).astype(np.float32)
    Xp[0, :2] = [np.nan, np.float32(1e-40)]
    buf, = ts._pack_all([ibuf], [fbuf], Xp)
    assert buf.dtype == torch.int32
    ib, fb = ts._split(buf, li, lf)
    X = ts._unpack_x(buf, li, lf)
    np.testing.assert_array_equal(ib.numpy(), ibuf)
    bits = torch.int32 if tdt == torch.float32 else torch.int16
    for got, want in ((fb, fbuf), (X, Xp)):
        assert got.dtype == tdt and got.shape == want.shape
        assert torch.equal(got.view(bits),
                           torch.from_numpy(want).to(tdt).view(bits))


def test_graph_server_idx16_disabled_on_big_envelopes(models):
    """An envelope whose index values exceed uint16 keeps int32 indices,
    and its round trip stays exact, as the JAX server's."""
    jm, variables, tm = models[:3]
    js = JS.GraphServer(jm, variables, 128, 70000)
    ts = T.GraphServer(tm, 128, 70000, device='cpu')
    assert ts._single and not ts._idx16
    assert (ts._single, ts._idx16) == (js._single_buffer, js._idx16)
    rng = np.random.default_rng(14)
    li, lf = ts._li_csr, ts._lf_csr
    ibuf = np.linspace(0, 69999, li).astype(np.int32)
    fbuf = rng.standard_normal(lf).astype(np.float32)
    Xp = rng.standard_normal((128, D_IN)).astype(np.float32)
    buf, = ts._pack_all([ibuf], [fbuf], Xp)
    ib, fb = ts._split(buf, li, lf)
    np.testing.assert_array_equal(ib.numpy(), ibuf)
    np.testing.assert_array_equal(fb.numpy(), fbuf)
    np.testing.assert_array_equal(ts._unpack_x(buf, li, lf).numpy(), Xp)


def test_warmup_counts_both_routes(models):
    """warmup(d_in) returns 2 with an envelope (the multi route and the
    CSR route), 1 without, 0 when warm; requests on either route after it
    add none, as the JAX server's compiles."""
    jm, variables, tm, (classes, rows), d_edge = models
    env = dict(classes=classes, class_rows=rows, d_edge=d_edge)
    js = JS.GraphServer(jm, variables, 48, 1024, **env)
    ts = T.GraphServer(tm, 48, 1024, device='cpu', **env)
    assert ts.warmup(D_IN) == js.warmup(D_IN) == 2
    assert ts.num_compiles() == 2 and ts.fallbacks == 0
    assert ts.warmup(D_IN) == 0
    for seed in range(4):
        req = _request(10 + seed, 20, d_edge)
        ts.predict(*req[:2], edge_features=req[2])
    star = np.stack([np.arange(1, 40), np.zeros(39, np.int64)])
    ef = np.ones((39, d_edge), np.float32) if d_edge else None
    ts.predict(star, np.ones((40, D_IN), np.float32), edge_features=ef)
    assert ts.num_compiles() == 2 and ts.fallbacks == 1
    csr = T.GraphServer(tm, 48, 1024, d_edge=d_edge, device='cpu')
    assert csr.warmup(D_IN) == 1
    with pytest.raises(ValueError):
        ts.predict(*_request(1, 24, d_edge)[:2],
                   edge_features=None if d_edge else np.ones((1, 1)))
