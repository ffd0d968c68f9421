"""The scatter-free adjoints of the CSR path (`ops/segment.py`): each
gather, sort and sorted segment-sum's gradient against the JAX package's
custom VJP, `torch.autograd.gradcheck`, the CSR embedding's gradients
against JAX's, and the CSR output's autograd graph, which must hold no
scatter-backed node.

Tolerances, all float64:
  * the Functions alone: 1e-12 (a gather moves values unchanged; a segment
    sum adds the same terms, in order on both sides);
  * fsw_embed_graph and fsw_embed_graph_batched, outputs and gradients:
    1e-10 of each one's scale, as tests/test_torch_csr.py (the restarted
    cumsum and the products sum in another order on each side).
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
import fsw_gnn_tpu.ops.segment as JS
import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.embedding as TE
import fsw_gnn_tpu_torch.ops.segment as TS

SCATTER_NODES = ('IndexSelectBackward0', 'GatherBackward0', 'IndexBackward0',
                 'IndexAddBackward0')


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _sorted_ids(rng, n, nseg):
    """Sorted ids over nseg segments, some empty, the last one long (as a
    padded CSR graph's dst)."""
    ids = np.sort(rng.integers(0, nseg - 1, n))
    ids[-n // 5:] = nseg - 1
    ids[(ids == 2)] = 3                               # segment 2 empty
    return np.sort(ids)


def _padded_idx(rng, n, n_rows):
    """Indices with duplicates and a padded tail pointing at row 0."""
    idx = rng.integers(0, n_rows, n)
    idx[-n // 4:] = 0
    return idx


@pytest.mark.parametrize('given', [True, False])
def test_rows_gather_matches_jax(given):
    rng = np.random.default_rng(0)
    N, E = 17, 90
    x, idx = rng.standard_normal((N, 3)), _padded_idx(rng, E, N)
    order = np.argsort(idx, kind='stable')
    ct = rng.standard_normal((E, 3))
    want = jax.grad(lambda x_: jnp.sum(JS.rows_gather(
        N, x_, jnp.asarray(idx), jnp.asarray(order),
        jnp.asarray(idx[order])) * ct))(jnp.asarray(x))
    args = ((_t(order), _t(idx[order])) if given else ())
    xt = _t(x, True)
    y = TS.rows_gather(N, xt, _t(idx), *args)
    _close(y, x[idx])
    (y * _t(ct)).sum().backward()
    _close(xt.grad, want)
    # along the last axis of x^T, the CSR path's layout
    xt2 = _t(x.T.copy(), True)
    y2 = TS.rows_gather(N, xt2, _t(idx), *args, dim=1)
    (y2 * _t(ct.T.copy())).sum().backward()
    _close(xt2.grad, np.asarray(want).T)
    assert type(y2.grad_fn).__name__ == '_RowsGatherBackward'
    with pytest.raises(ValueError, match='num_rows'):
        TS.rows_gather(N + 1, xt, _t(idx))


def test_permutation_gather_matches_jax():
    rng = np.random.default_rng(1)
    n = 40
    x, perm = rng.standard_normal((n, 2)), rng.permutation(n)
    inv = np.argsort(perm)
    ct = rng.standard_normal((n, 2))
    want = jax.grad(lambda x_: jnp.sum(JS.permutation_gather(
        x_, jnp.asarray(perm), jnp.asarray(inv)) * ct))(jnp.asarray(x))
    for args in ((_t(perm), _t(inv)), (_t(perm),)):
        xt = _t(x, True)
        y = TS.permutation_gather(xt, *args)
        _close(y, x[perm])
        (y * _t(ct)).sum().backward()
        _close(xt.grad, want)
    np.testing.assert_array_equal(TS.invert_permutation(_t(perm)).numpy(),
                                  inv)


def test_segment_sort_fused_matches_jax():
    """Keys with ties (-0.0 beside 0.0) in segments, some empty; 1-D as
    the JAX function, then rows of keys over one carried row (the CSR
    path's (S_b, E) layout), against jax.vmap."""
    rng = np.random.default_rng(2)
    n, nseg = 120, 9
    ids = _sorted_ids(rng, n, nseg)
    keys = np.round(rng.standard_normal(n) * 2) / 2
    keys[::9] = -0.0
    carried = rng.standard_normal(n)
    gk, gc = rng.standard_normal(n), rng.standard_normal(n)

    def jl(k, c):
        a, b = JS.segment_sort_fused(k, c, jnp.asarray(ids))
        return jnp.sum(a * gk) + jnp.sum(b * b * gc)
    wk, wc = jax.grad(jl, argnums=(0, 1))(jnp.asarray(keys),
                                          jnp.asarray(carried))
    kt, ctt = _t(keys, True), _t(carried, True)
    a, b = TS.segment_sort_fused(kt, ctt, _t(ids))
    ((a * _t(gk)).sum() + (b * b * _t(gc)).sum()).backward()
    _close(kt.grad, wk)
    _close(ctt.grad, wc)

    rows = np.stack([keys, -keys, rng.standard_normal(n)])
    G = rng.standard_normal((3, n))

    def jrows(k, c):
        a, b = jax.vmap(JS.segment_sort_fused, in_axes=(0, None, None))(
            k, c, jnp.asarray(ids))
        return jnp.sum(a * G) + jnp.sum(b * b * G)
    wk, wc = jax.grad(jrows, argnums=(0, 1))(jnp.asarray(rows),
                                             jnp.asarray(carried))
    kt, ctt = _t(rows, True), _t(carried, True)
    a, b = TS.segment_sort_fused(kt, ctt, _t(ids))
    assert a.shape == b.shape == (3, n)
    ((a * _t(G)).sum() + (b * b * _t(G)).sum()).backward()
    _close(kt.grad, wk)
    _close(ctt.grad, wc)


def test_sort_pairs_and_keys_fused_match_jax():
    rng = np.random.default_rng(3)
    keys = np.round(rng.standard_normal((4, 33)) * 3) / 3   # ties
    carried = rng.standard_normal((4, 33))
    G1, G2 = rng.standard_normal((4, 33)), rng.standard_normal((4, 33))

    def jl(k, c):
        a, b = JS.sort_pairs_fused(k, c)
        return jnp.sum(a * G1) + jnp.sum(jnp.sin(b) * G2)
    (va, vb) = JS.sort_pairs_fused(jnp.asarray(keys), jnp.asarray(carried))
    wk, wc = jax.grad(jl, argnums=(0, 1))(jnp.asarray(keys),
                                          jnp.asarray(carried))
    kt, ctt = _t(keys, True), _t(carried, True)
    a, b = TS.sort_pairs_fused(kt, ctt)
    _close(a, va)
    _close(b, vb)
    ((a * _t(G1)).sum() + (torch.sin(b) * _t(G2)).sum()).backward()
    _close(kt.grad, wk)
    _close(ctt.grad, wc)

    want = jax.grad(lambda k: jnp.sum(JS.sort_keys_fused(k) ** 2 * G1))(
        jnp.asarray(keys))
    kt = _t(keys, True)
    s = TS.sort_keys_fused(kt)
    _close(s, np.sort(keys, axis=-1))
    (s ** 2 * _t(G1)).sum().backward()
    _close(kt.grad, want)


@pytest.mark.parametrize('dim', [0, 1])
def test_segment_sum_and_expand_match_jax(dim):
    """Sorted segment sums with empty segments, along axis 0 as the JAX
    function and along the last axis (the CSR path's per-recipient sums
    over (S_b, E)); segment_expand against jnp.take."""
    rng = np.random.default_rng(4 + dim)
    n, nseg = 70, 8
    ids = _sorted_ids(rng, n, nseg)
    v = rng.standard_normal((n, 3))
    ct = rng.standard_normal((nseg, 3))
    jsum = JS.segment_sum(jnp.asarray(v), jnp.asarray(ids), nseg)
    want = jax.grad(lambda v_: jnp.sum(JS.segment_sum(
        v_, jnp.asarray(ids), nseg) * ct))(jnp.asarray(v))
    tr = (lambda a: a) if dim == 0 else (lambda a: a.T.copy())
    vt = _t(tr(v), True)
    s = TS.segment_sum(vt, _t(ids), nseg, dim)
    _close(s, tr(np.asarray(jsum)))
    (s * _t(tr(ct))).sum().backward()
    _close(vt.grad, tr(np.asarray(want)))

    x, cx = rng.standard_normal((nseg, 3)), rng.standard_normal((n, 3))
    want = jax.grad(lambda x_: jnp.sum(jnp.take(x_, jnp.asarray(ids), 0)
                                       * cx))(jnp.asarray(x))
    xt = _t(tr(x), True)
    y = TS.segment_expand(xt, _t(ids), dim)
    _close(y, tr(x[ids]))
    (y * _t(tr(cx))).sum().backward()
    _close(xt.grad, tr(np.asarray(want)))

    # lengths given (as the CSR path passes them) change no bit
    lens = TS.segment_lengths(_t(ids), nseg)
    assert lens.tolist() == np.bincount(ids, minlength=nseg).tolist()
    assert torch.equal(TS.segment_sum(vt, _t(ids), nseg, dim, lens), s)
    assert torch.equal(TS.segment_expand(xt, _t(ids), dim, lens), y)


def test_functions_pass_gradcheck():
    rng = np.random.default_rng(5)
    n, nseg, N = 12, 4, 5
    ids = _t(_sorted_ids(rng, n, nseg))
    idx = _t(_padded_idx(rng, n, N))
    perm = _t(rng.permutation(n))
    keys = _t(rng.permutation(n) * 1.0, True)        # gaps far above eps
    rows = _t(np.stack([rng.permutation(n), rng.permutation(n)]) * 1.0,
              True)
    x = _t(rng.standard_normal((N, 2)), True)
    v = _t(rng.standard_normal((n, 2)), True)
    c = _t(rng.standard_normal(n), True)
    s = _t(rng.standard_normal((nseg, 2)), True)
    gradcheck = functools.partial(torch.autograd.gradcheck, eps=1e-6,
                                  atol=1e-8)
    assert gradcheck(lambda x_: TS.rows_gather(N, x_, idx), (x,))
    assert gradcheck(lambda x_: TS.rows_gather(N, x_.t(), idx, dim=1),
                     (x,))
    assert gradcheck(lambda v_: TS.permutation_gather(v_, perm), (v,))
    assert gradcheck(lambda k, c_: TS.segment_sort_fused(k, c_, ids),
                     (keys, c))
    assert gradcheck(lambda k, c_: TS.segment_sort_fused(k, c_, ids),
                     (rows, c))
    assert gradcheck(lambda k, c_: TS.sort_pairs_fused(k, c_ * k),
                     (rows, c))
    assert gradcheck(TS.sort_keys_fused, (rows,))
    assert gradcheck(lambda v_: TS.segment_sum(v_, ids, nseg), (v,))
    assert gradcheck(lambda v_: TS.segment_sum(v_.t(), ids, nseg, 1), (v,))
    assert gradcheck(lambda s_: TS.segment_expand(s_, ids), (s,))
    # the sum and the expansion are each other's adjoints, to any order
    assert torch.autograd.gradgradcheck(
        lambda v_: TS.segment_sum(v_, ids, nseg) ** 2, (v,))


N, D_IN = 36, 4


def _edges(rng, n, p_max=0.4):
    """Random in-degrees 0 .. ~14; node 1 receives nothing."""
    p = np.linspace(0.0, p_max, n)[rng.permutation(n)]
    A = rng.random((n, n)) < p[None, :]
    np.fill_diagonal(A, False)
    A[:, 1] = False
    return np.stack(np.nonzero(A)).astype(np.int64)


@pytest.mark.parametrize('self_loop', [0.0, 1.0])
def test_csr_run_lengths_from_row_ptr(self_loop):
    """The CSR path takes the recipients' run lengths from row_ptr and the
    senders' from src_sorted, once a graph: they are the lengths that a
    search of the sorted ids finds, padding included."""
    ei = _edges(np.random.default_rng(7), N)
    g = T.from_edge_index(ei, N, self_loop_weight=self_loop,
                          pad_to=ei.shape[1] + N + 7)
    dst, src = torch.as_tensor(g.dst), torch.as_tensor(g.src)
    assert g.dst.shape[0] > g.num_edges              # padded
    assert torch.equal(torch.diff(torch.as_tensor(g.row_ptr).long()),
                       TS.segment_lengths(dst, g.num_recipients))
    assert torch.equal(TS.segment_lengths(torch.as_tensor(g.src_sorted), N),
                       torch.bincount(src.long(), minlength=N))


CASES = {
    'unit': (dict(d_in=D_IN, d_out=9), {}, None),
    'gcn, self-loops, total mass, chunks': (
        dict(d_in=D_IN, d_out=8, encode_total_mass=True),
        dict(edge_weighting='gcn', self_loop_weight=1.0), 3),
    'edge features': (dict(d_in=D_IN, d_out=7, d_edge=2), {}, None),
    'cartesian': (dict(d_in=D_IN, n_slices=5, n_freqs=3),
                  dict(self_loop_weight=0.5), None),
    'cartesian, collapsed, total mass': (
        dict(d_in=D_IN, n_slices=4, n_freqs=2, collapse_freqs=True,
             encode_total_mass=True, d_edge=1),
        dict(edge_weighting='gcn'), 2),
}


def _cfg_params(cfg_kw, rng):
    jc, tc = JE.FSWConfig(**cfg_kw), TE.FSWConfig(**cfg_kw)
    V = rng.standard_normal((tc.nSlices, tc.proj_dim))
    f = rng.random(tc.nFreqs) * 6
    return jc, tc, V, f


def _port_grads(fn, X, V, f, w, ef):
    """Output and the gradients of sum(out * G) in X, V, f, the edge
    weights and the edge features (None where absent)."""
    ts = [_t(a, True) if a is not None else None for a in (X, V, f, w, ef)]
    out = fn(*ts)
    return out, ts


@pytest.mark.parametrize('case', list(CASES))
def test_fsw_embed_graph_gradients_match_jax(case):
    cfg_kw, g_kw, chunk = CASES[case]
    rng = np.random.default_rng(len(case))
    ei = _edges(rng, N)
    d_edge = cfg_kw.get('d_edge', 0)
    ef = rng.standard_normal((ei.shape[1], d_edge)) if d_edge else None
    jg = J.from_edge_index(ei, N, ef, dtype=jnp.float64, **g_kw)
    tg = T.from_edge_index(ei, N, ef, dtype=np.float64, **g_kw)
    jc, tc, V, f = _cfg_params(cfg_kw, rng)
    X = rng.standard_normal((N, D_IN))
    w, efp = np.asarray(tg.weight), tg.edge_feat
    shape = jax.eval_shape(
        lambda: JE.fsw_embed_graph(jnp.asarray(X), jg, jnp.asarray(V),
                                   jnp.asarray(f), jc)).shape
    G = rng.standard_normal(shape)

    def jloss(X_, V_, f_, w_, ef_):
        g = dataclasses.replace(jg, weight=w_, edge_feat=ef_)
        out = JE.fsw_embed_graph(X_, g, V_, f_, jc, slice_chunk=chunk)
        return jnp.sum(out * G), out
    argnums = (0, 1, 2, 3, 4) if d_edge else (0, 1, 2, 3)
    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=argnums, has_aux=True))(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(f), jnp.asarray(w),
        None if efp is None else jnp.asarray(efp))

    def port(X_, V_, f_, w_, ef_):
        g = dataclasses.replace(tg.to('cpu'), weight=w_, edge_feat=ef_)
        return TE.fsw_embed_graph(X_, g, V_, f_, tc, slice_chunk=chunk)
    out, ts = _port_grads(port, X, V, f, w, efp)
    (out * _t(G)).sum().backward()
    _close(out, want, 1e-10)
    for t, gw in zip(ts, grads):
        _close(t.grad, gw, 1e-10)


@pytest.mark.parametrize('cartesian', [False, True])
def test_fsw_embed_graph_batched_gradients_match_jax(cartesian):
    """Five graphs stacked, leading batch dims (5,): the block-diagonal
    graph's src_order/src_sorted are each graph's, offset; gradients in X,
    V, f, the stacked edge weights and edge features."""
    rng = np.random.default_rng(7 + cartesian)
    n, Gn = 10, 5
    jgs, tgs = [], []
    for g in range(Gn):
        ei = _edges(rng, n, 0.5)
        ef = rng.standard_normal((ei.shape[1], 2))
        jgs.append(J.from_edge_index(ei, n, ef, dtype=jnp.float64,
                                     self_loop_weight=1.0, pad_to=160))
        tgs.append(T.from_edge_index(ei, n, ef, dtype=np.float64,
                                     self_loop_weight=1.0, pad_to=160))
    jst, tst = J.stack_graphs(jgs), T.stack_graphs(tgs)
    cfg_kw = (dict(d_in=3, n_slices=4, n_freqs=2, d_edge=2) if cartesian
              else dict(d_in=3, d_out=7, d_edge=2, encode_total_mass=True))
    jc, tc, V, f = _cfg_params(cfg_kw, rng)
    X = rng.standard_normal((Gn, n, 3))
    w, ef = np.asarray(tst.weight), np.asarray(tst.edge_feat)
    shape = jax.eval_shape(lambda: JE.fsw_embed_graph_batched(
        jnp.asarray(X), jst, jnp.asarray(V), jnp.asarray(f), jc)).shape
    G = rng.standard_normal(shape)

    def jloss(X_, V_, f_, w_, ef_):
        g = dataclasses.replace(jst, weight=w_, edge_feat=ef_)
        out = JE.fsw_embed_graph_batched(X_, g, V_, f_, jc, slice_chunk=3)
        return jnp.sum(out * G), out
    (_, want), grads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(f), jnp.asarray(w),
        jnp.asarray(ef))

    def port(X_, V_, f_, w_, ef_):
        g = dataclasses.replace(tst.to('cpu'), weight=w_, edge_feat=ef_)
        return TE.fsw_embed_graph_batched(X_, g, V_, f_, tc, slice_chunk=3)
    out, ts = _port_grads(port, X, V, f, w, ef)
    (out * _t(G)).sum().backward()
    _close(out, want, 1e-10)
    for t, gw in zip(ts, grads):
        _close(t.grad, gw, 1e-10)


def _node_names(out):
    names, seen, stack = set(), set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


@pytest.mark.parametrize('cartesian', [False, True])
def test_csr_autograd_graph_has_no_scatter_backed_node(cartesian):
    """Every input of the CSR path takes a gradient (X, the slice vectors,
    the frequencies, the edge weights and edge features); the output's
    autograd graph holds none of the nodes whose backward is a scatter,
    for the embedding alone, chunked, batched and inside an FSWConv."""
    rng = np.random.default_rng(9)
    ei = _edges(rng, N)
    ef = rng.standard_normal((ei.shape[1], 2))
    tg = T.from_edge_index(ei, N, ef, dtype=np.float64,
                           edge_weighting='gcn', self_loop_weight=1.0)
    cfg_kw = (dict(d_in=D_IN, n_slices=5, n_freqs=3, d_edge=2,
                   collapse_freqs=True, encode_total_mass=True)
              if cartesian else
              dict(d_in=D_IN, d_out=8, d_edge=2, encode_total_mass=True))
    _, tc, V, f = _cfg_params(cfg_kw, rng)
    X = rng.standard_normal((N, D_IN))
    outs = []
    for chunk in (None, 2):
        Xt, Vt, ft, wt, eft = (_t(a, True) for a in
                               (X, V, f, tg.weight, tg.edge_feat))
        g = dataclasses.replace(tg.to('cpu'), weight=wt, edge_feat=eft)
        outs.append(TE.fsw_embed_graph(Xt, g, Vt, ft, tc, slice_chunk=chunk))
    tst = T.stack_graphs([tg, tg])
    wt = _t(tst.weight, True)
    outs.append(TE.fsw_embed_graph_batched(
        _t(np.stack([X, X]), True), dataclasses.replace(tst, weight=wt),
        _t(V, True), _t(f, True), tc))
    conv = T.FSWConv(D_IN, 3, edgefeat_dim=2, dtype=torch.float64,
                     device='cpu')
    g = dataclasses.replace(tg.to('cpu'), weight=_t(tg.weight, True))
    outs.append(conv(_t(X, True), g))
    for out in outs:
        names = _node_names(out)
        assert '_RowsGatherBackward' in names and '_SortGatherBackward' in \
            names and '_SegmentSumBackward' in names
        assert not names & set(SCATTER_NODES), names & set(SCATTER_NODES)


def test_sorted_weights_take_a_gradient_only_with_the_weights():
    """The fused sort's outputs take a gradient only where their inputs
    do: with data weights the CSR path's cumsum of the sorted weights has
    no backward (K3 runs once a forward and backward on the card), with
    weights that take a gradient it has one."""
    rng = np.random.default_rng(10)
    ei = _edges(rng, N)
    conv = T.FSWConv(D_IN, 3, dtype=torch.float64, device='cpu')
    X = _t(rng.standard_normal((N, D_IN)), True)
    tg = T.from_edge_index(ei, N, dtype=np.float64).to('cpu')

    def k3_backward(out):      # the node of the K3 op's registered backward
        return any('segcumsum_rows' in n for n in _node_names(out))
    assert not k3_backward(conv(X, tg))
    g = dataclasses.replace(tg, weight=_t(tg.weight, True))
    assert k3_backward(conv(X, g))
    keys = _t(rng.standard_normal((2, 6)), True)
    ps, ws = TS.segment_sort_fused(keys, _t(np.arange(6.0)),
                                   _t(np.zeros(6, np.int64)))
    assert ps.requires_grad and not ws.requires_grad
