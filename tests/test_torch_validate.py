"""The port's input validation (`utils/validate.py`) against the JAX
package's on the same numpy inputs: every validator raises (an
AssertionError) or passes alike, and `checkify_embed` passes or raises
alike around the embeddings.

Tolerance: where both pass, the checked call's output is the unchecked
port call's bit for bit (the checks only read), and within 1e-12 of JAX's
in float64 (both take the sort route and sort alike; what differs is
summation order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu.embedding as JE
import fsw_gnn_tpu.utils as JU
import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.embedding as TE
import fsw_gnn_tpu_torch.utils as TU

N, D_IN = 24, 3


def _outcome(fn, *args):
    """'pass', or the name of the exception `fn(*args)` raised."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return 'pass'


def _alike(jfn, tfn, *args, port_args=None):
    """The JAX and port validators agree on `args` (the port's own
    `port_args` where given: tensors of the same values)."""
    want = _outcome(jfn, *args)
    got = _outcome(tfn, *(port_args if port_args is not None else args))
    assert got == want, (got, want)
    return got


def _multisets():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((3, 5, 2))
    W = np.abs(rng.standard_normal((3, 5)))
    Xn = X.copy()
    Xn[0, 0, 0] = np.nan
    Xi = X.copy()
    Xi[1, 2, 1] = np.inf
    Wn = W.copy()
    Wn[2, 1] = np.nan
    return {'valid': (X, W), 'no W': (X, None), 'NaN X': (Xn, None),
            'inf X': (Xi, W), 'negative W': (X, -W), 'NaN W': (X, Wn),
            'W of the wrong shape': (X, W[:, :4]), 'rank 1 X': (X[0, 0], None)}


MULTISETS = _multisets()


@pytest.mark.parametrize('case', sorted(MULTISETS))
@pytest.mark.parametrize('as_tensor', [False, True])
def test_validate_multiset_inputs_matches_jax(case, as_tensor):
    X, W = MULTISETS[case]
    port = None
    if as_tensor:
        port = (torch.from_numpy(X),
                None if W is None else torch.from_numpy(W))
    got = _alike(JU.validate_multiset_inputs, TU.validate_multiset_inputs,
                 X, W, port_args=port)
    assert (got == 'pass') == (case in ('valid', 'no W'))


def _edges(seed=1, n=N):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < 0.2
    np.fill_diagonal(A, False)
    return np.stack(np.nonzero(A)).astype(np.int64)


def _edge_cases():
    ei = _edges()
    neg = ei.copy()
    neg[0, 3] = -1
    big = ei.copy()
    big[1, 5] = N
    return {'valid': (ei, N), 'empty': (ei[:, :0], N),
            'negative id': (neg, N), 'id out of range': (big, N),
            'too few nodes': (ei, 3), 'not (2, E)': (ei[:1], N),
            'rank 1': (ei[0], N)}


EDGES = _edge_cases()


@pytest.mark.parametrize('case', sorted(EDGES))
@pytest.mark.parametrize('as_tensor', [False, True])
def test_validate_edge_index_matches_jax(case, as_tensor):
    ei, n = EDGES[case]
    port = (torch.from_numpy(ei), n) if as_tensor else None
    got = _alike(JU.validate_edge_index, TU.validate_edge_index, ei, n,
                 port_args=port)
    assert (got == 'pass') == (case in ('valid', 'empty'))


def _graph_pair(ei, corrupt=None, **kw):
    """Each package's `from_edge_index` of the same edges in float64, then
    the same corruption of both: corrupt(numpy field dict) -> changes."""
    jg = J.from_edge_index(ei, N, dtype=jnp.float64, **kw)
    tg = T.from_edge_index(ei, N, dtype=np.float64, **kw)
    if corrupt is not None:
        changes = corrupt({f: np.array(getattr(tg, f)) for f in
                           ('src', 'dst', 'weight', 'row_ptr')})
        jg = jg.replace(**{k: jnp.asarray(v) for k, v in changes.items()})
        tg = dataclasses.replace(tg, **changes)
    return jg, tg


def _swap_dst(a):
    d = a['dst'].copy()
    d[0], d[-1] = d[-1], d[0]
    return {'dst': d}


def _bad_row_ptr(a):
    r = a['row_ptr'].copy()
    r[3] += 1
    return {'row_ptr': r}


def _padding_weight(a):
    w = a['weight'].copy()
    w[-1] = 0.5
    return {'weight': w}


def _negative_weight(a):
    w = a['weight'].copy()
    w[0] = -w[0]
    return {'weight': w}


def _nan_weight(a):
    w = a['weight'].copy()
    w[2] = np.nan
    return {'weight': w}


GRAPHS = {'valid': None, 'unsorted dst': _swap_dst,
          'bad row_ptr': _bad_row_ptr, 'nonzero padding weight':
          _padding_weight, 'negative weight': _negative_weight,
          'NaN weight': _nan_weight}


@pytest.mark.parametrize('case', sorted(GRAPHS))
@pytest.mark.parametrize('kw', [{}, dict(self_loop_weight=1.0,
                                         edge_weighting='gcn')],
                         ids=['unit', 'gcn'])
def test_validate_graph_matches_jax(case, kw):
    jg, tg = _graph_pair(_edges(), GRAPHS[case], **kw)
    assert tg.num_edges < tg.padded_num_edges     # there is padding
    got = _alike(JU.validate_graph, TU.validate_graph, jg, port_args=(tg,))
    assert (got == 'pass') == (case == 'valid')
    # a graph moved to a device is read back to the host alike
    assert _outcome(TU.validate_graph, tg.to('cpu')) == got


# ---- checkify_embed --------------------------------------------------------

def _params(rng, cfg):
    V = rng.standard_normal((cfg.nSlices, cfg.proj_dim))
    f = rng.random(cfg.nFreqs) * 4.0
    bias = rng.standard_normal(cfg.out_dim)
    return V, f, bias


def _embed_case(kind, rng, bad):
    """(jax fn, jax args, port fn, port args, kwargs) of one embedding on
    the same float64 inputs.  `bad`: 'inf' puts an inf into one feature
    (the projections then hold infs, no NaN: JAX's float_checks pass),
    'infs' into two features of one node (inf - inf in the projection:
    a NaN)."""
    kw = dict(d_in=D_IN, d_out=9)
    if kind == 'multiset':
        kw['total_mass_pad_thresh'] = 2.0          # a phantom mass
    jcfg, tcfg = JE.FSWConfig(**kw), TE.FSWConfig(**kw)
    V, f, bias = _params(rng, tcfg)
    if kind == 'multiset':
        X = rng.standard_normal((2, 3, 7, D_IN))
        W = np.abs(rng.standard_normal((2, 3, 7)))
        W[0, 0, :3] = 0.0
    else:
        X = rng.standard_normal((N, D_IN))
    if bad:
        X.reshape(-1, D_IN)[4, 1] = np.inf      # a view: X changes
    if bad == 'infs':
        X.reshape(-1, D_IN)[4, 2] = np.inf
    jp = [jnp.asarray(V), jnp.asarray(f)]
    tp = [torch.from_numpy(V), torch.from_numpy(f)]
    if kind == 'multiset':
        return (JE.fsw_embed_multiset, [jnp.asarray(X), jnp.asarray(W)] + jp,
                TE.fsw_embed_multiset,
                [torch.from_numpy(X), torch.from_numpy(W)] + tp,
                dict(bias=bias), jcfg, tcfg)
    ei = _edges(2)
    jg = J.from_edge_index(ei, N, dtype=jnp.float64)
    tg = T.from_edge_index(ei, N, dtype=np.float64)
    if kind == 'multi_table':
        jl, tl = J.to_multi_table(jg), T.to_multi_table(tg).to('cpu')
        jfn, tfn = JE.fsw_embed_multi_table, TE.fsw_embed_multi_table
    else:
        jl, tl = jg, tg
        jfn, tfn = JE.fsw_embed_graph, TE.fsw_embed_graph
    return (jfn, [jnp.asarray(X), jl] + jp, tfn,
            [torch.from_numpy(X), tl] + tp, dict(bias=bias), jcfg, tcfg)


def _kwargs(kind, cfg, bias, lib):
    kw = dict(cfg=cfg, bias=lib(bias))
    if kind != 'graph':
        kw['aggregate'] = 'sort'       # JAX's 'auto' on the CPU
    return kw


@pytest.mark.parametrize('kind', ['multi_table', 'graph', 'multiset'])
@pytest.mark.parametrize('bad', [None, 'inf', 'infs'],
                         ids=['valid', 'inf', 'infs'])
def test_checkify_embed_matches_jax(kind, bad):
    rng = np.random.default_rng(3)
    jfn, jargs, tfn, targs, extra, jcfg, tcfg = _embed_case(kind, rng, bad)
    jkw = _kwargs(kind, jcfg, extra['bias'], jnp.asarray)
    tkw = _kwargs(kind, tcfg, extra['bias'], torch.from_numpy)
    try:
        jout = np.asarray(JU.checkify_embed(jfn)(*jargs, **jkw))
        want = 'pass'
    except Exception:  # noqa: BLE001
        want = 'raise'
    try:
        tout = TU.checkify_embed(tfn)(*targs, **tkw)
        got = 'pass'
    except TU.FloatCheckError as e:
        got = 'raise'
        assert 'NaN generated by' in str(e)
    assert got == want == ('raise' if bad == 'infs' else 'pass')
    if got == 'pass':
        assert torch.equal(tout, tfn(*targs, **tkw))
        out = tout.numpy()
        finite = np.isfinite(jout)
        np.testing.assert_array_equal(np.isfinite(out), finite)
        np.testing.assert_array_equal(out[~finite], jout[~finite])
        assert finite.any() and (bad or finite.all())
        np.testing.assert_allclose(
            out[finite], jout[finite], rtol=1e-12,
            atol=1e-12 * np.abs(jout[finite]).max())


@pytest.mark.parametrize('agg', ['rank', 'auto'])
def test_checkify_passes_the_rank_route(agg):
    """The port's own route on the CPU (the kernels' plain versions, one op
    each through the mode) passes on valid inputs, with the unchecked
    call's bits, and raises on a node with two infinite features."""
    rng = np.random.default_rng(4)
    _, _, tfn, targs, extra, _, tcfg = _embed_case('multi_table', rng, False)
    targs = [targs[0].float(), targs[1]] + [t.float() for t in targs[2:]]
    kw = dict(cfg=tcfg, aggregate=agg,
              bias=torch.from_numpy(extra['bias']).float())
    out = TU.checkify_embed(tfn)(*targs, **kw)
    assert torch.equal(out, tfn(*targs, **kw))
    X = targs[0].clone()
    X[5, 0] = X[5, 1] = float('inf')
    with pytest.raises(TU.FloatCheckError, match='generated by'):
        TU.checkify_embed(tfn)(X, *targs[1:], **kw)


@pytest.mark.parametrize('op', ['int_div', 'int_floor_div', 'float_div',
                                'remainder', 'nan'])
def test_checkify_float_checks_match_jax(op):
    """JAX's float_checks on single ops: a division by zero (integer or
    floating, as JAX's div_checks flag both), a floating remainder by zero
    (a NaN) and a NaN raise in both; the same ops on safe inputs pass in
    both."""
    jfns = {'int_div': lambda a, b: a // b,
            'int_floor_div': lambda a, b: jnp.floor_divide(a, b),
            'float_div': lambda a, b: a / b,
            'remainder': lambda a, b: a % b,
            'nan': lambda a, b: jnp.log(a - b)}
    tfns = {'int_div': lambda a, b: torch.div(a, b, rounding_mode='trunc'),
            'int_floor_div': lambda a, b: torch.floor_divide(a, b),
            'float_div': lambda a, b: a / b,
            'remainder': lambda a, b: torch.remainder(a, b),
            'nan': lambda a, b: torch.log(a - b)}
    ints = op in ('int_div', 'int_floor_div')
    for b, want in (([1, 2, 3], 'pass'), ([1, 0, 3], 'raise')):
        a = np.array([4, 5, 6]) if ints else np.array([4.0, 5.0, 6.0])
        b = np.asarray(b, a.dtype)
        if op == 'nan':
            b = np.array([1.0, 2.0, 3.0]) if want == 'pass' else \
                np.array([1.0, 9.0, 3.0])
        jf, tf = JU.checkify_embed(jfns[op]), TU.checkify_embed(tfns[op])
        got_j = _outcome(jf, jnp.asarray(a), jnp.asarray(b))
        got_t = _outcome(tf, torch.from_numpy(a), torch.from_numpy(b))
        assert (got_j == 'pass') == (want == 'pass'), (op, b, got_j)
        assert (got_t == 'pass') == (want == 'pass'), (op, b, got_t)


def test_checkify_names_the_op():
    with pytest.raises(TU.FloatCheckError, match='aten.sub'):
        TU.checkify_embed(lambda a: a - a)(torch.tensor([float('inf')]))
    with pytest.raises(TU.FloatCheckError, match='division by zero'):
        TU.checkify_embed(lambda a: a / 0)(torch.ones(2))


def test_checkify_refuses_a_graph_capture(monkeypatch):
    """It waits for every op, which a CUDA graph capture cannot do."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    with pytest.raises(RuntimeError, match='capture'):
        TU.checkify_embed(lambda a: a + 1)(torch.ones(2))
