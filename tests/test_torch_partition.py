"""The port's edge partitioning against the JAX package's, in one process:
`partition_graph` bit for bit for every layout, with and without the
all-to-all ids, on a graph with a hub and on one with edge features;
`local_graph` against the JAX package's per-device layout; the feature
and label layouts; and the overlapped embedding with the identity
exchange against the JAX package's (float64, the sort route: rtol 1e-10,
the same arithmetic up to summation order)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
from fsw_gnn_tpu.parallel import dist as jdist
from fsw_gnn_tpu.parallel import partition as jpart
from fsw_gnn_tpu.parallel.overlap import \
    fsw_embed_local_overlap as j_overlap

import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch.embedding import FSWConfig as TConfig
from fsw_gnn_tpu_torch.parallel import (local_graph, partition_graph,
                                        shard_node_features,
                                        shard_recipient_labels,
                                        unshard_recipient_values)
from fsw_gnn_tpu_torch.parallel.overlap import fsw_embed_local_overlap

LAYOUTS = ('auto', 'multi', 'table', 'csr')


def _graph_with_hub(seed=0, n=72):
    """A random graph whose node 0 takes an in-edge from every other node
    (in-degree 71: the widest degree class holds one row)."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < 0.08
    A[:, 0] = True
    np.fill_diagonal(A, False)
    return np.stack(np.nonzero(A)).astype(np.int64), None


def _graph_with_edge_features(seed=1, n=56, d_edge=3):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < 0.12
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    return ei, rng.standard_normal((ei.shape[1], d_edge))


GRAPHS = {'hub': _graph_with_hub, 'edge_features': _graph_with_edge_features}


def _both(name, P, layout, a2a, dtype=np.float32):
    ei, ef = GRAPHS[name]()
    n = int(ei.max()) + 1
    jg = J.from_edge_index(ei, n, edge_features=ef, dtype=dtype)
    tg = T.from_edge_index(ei, n, edge_features=ef, dtype=dtype)
    return (jpart.partition_graph(jg, P, layout=layout, with_all_to_all=a2a),
            partition_graph(tg, P, layout=layout, with_all_to_all=a2a))


def _equal(a, b, where):
    if a is None or b is None:
        assert a is None and b is None, where
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f'{where}[{k}]')
        return
    if isinstance(a, (bool, int, np.integer)) and not hasattr(a, 'shape'):
        assert a == b, (where, a, b)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (
        where, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), where


@pytest.mark.parametrize('a2a', [True, False], ids=['a2a', 'no_a2a'])
@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_partition_is_the_jax_packages_bit_for_bit(name, layout, a2a):
    js, ts = _both(name, 3, layout, a2a)
    for f in dataclasses.fields(ts):
        _equal(getattr(js, f.name), getattr(ts, f.name), f.name)
    assert ts.shard_num_edges == js.shard_num_edges
    if layout in ('auto', 'multi'):
        assert ts.mtbl_idx is not None
    if name == 'edge_features':
        assert ts.tbl_idx is None
        assert (ts.mtbl_ef is not None) == (layout in ('auto', 'multi'))


def _jax_local(js, p, exchange):
    local = jax.tree_util.tree_map(lambda a: a[p:p + 1], js)
    return jdist._local_graph(js, local, exchange)


@pytest.mark.parametrize('exchange', ['all_gather', 'all_to_all'])
@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_local_graph_is_the_jax_packages(name, layout, exchange):
    """Every rank's layout holds the JAX package's per-device arrays; the
    CSR Graph's last row pointer also covers the padding edges."""
    js, ts = _both(name, 3, layout, True)
    for p in range(3):
        want = _jax_local(js, p, exchange)
        got = local_graph(ts, p, exchange)
        assert type(got).__name__ == type(want).__name__
        assert (got.num_nodes, got.num_recipients) == (want.num_nodes,
                                                       want.num_recipients)
        if isinstance(got, T.MultiTable):
            _equal(tuple(np.asarray(r) for r in want.row_ids), got.row_ids,
                   'row_ids')
            for a, b in zip(want.tables, got.tables):
                for f in ('idx', 'weight', 'in_degrees', 'edge_feat'):
                    _equal(getattr(a, f), getattr(b, f), f)
                assert a.uniform_w == b.uniform_w
        elif isinstance(got, T.NeighborTable):
            for f in ('idx', 'weight', 'in_degrees'):
                _equal(getattr(want, f), getattr(got, f), f)
            assert want.uniform_w == got.uniform_w
        else:
            for f in ('src', 'dst', 'weight', 'in_degrees', 'edge_feat',
                      'src_order', 'src_sorted'):
                _equal(getattr(want, f), getattr(got, f), f)
            rp = np.asarray(want.row_ptr).copy()
            rp[-1] = ts.shard_num_edges
            _equal(rp, got.row_ptr, 'row_ptr')


@pytest.mark.parametrize('P', [1, 2, 4])
def test_feature_and_label_layouts(P):
    ei, _ = _graph_with_hub()
    n = int(ei.max()) + 1
    js, ts = _both('hub', P, 'auto', False)
    rng = np.random.default_rng(P)
    X = rng.standard_normal((n, 5))
    y = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.5
    Xs = shard_node_features(X, ts)
    _equal(np.asarray(jpart.shard_node_features(X, js)), Xs, 'features')
    np.testing.assert_array_equal(unshard_recipient_values(Xs, ts), X)
    for a, b in zip(jpart.shard_recipient_labels(y, mask, js),
                    shard_recipient_labels(y, mask, ts)):
        _equal(np.asarray(a), b, 'labels')


@pytest.mark.parametrize('cartesian', [False, True],
                         ids=['slices', 'cartesian'])
@pytest.mark.parametrize('d_edge', [0, 2])
def test_overlap_embed_identity_exchange_matches_jax(cartesian, d_edge):
    """`fsw_embed_local_overlap` with the identity exchange (one device) on
    a MultiTable against the JAX package's, forward and the gradients of
    X, the slice vectors and the frequencies (JAX tests/test_overlap.py's
    cases)."""
    rng = np.random.default_rng(17)
    n, d_in = 48, 5
    A = rng.random((n, n)) < 0.15
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    ef = rng.standard_normal((ei.shape[1], d_edge)) if d_edge else None
    kw = (dict(d_in=d_in, d_edge=d_edge, n_slices=6, n_freqs=3,
               enable_bias=False) if cartesian else
          dict(d_in=d_in, d_edge=d_edge, d_out=10, enable_bias=False))
    jcfg, tcfg = J.FSWConfig(**kw), TConfig(**kw)
    proj = rng.standard_normal((jcfg.nSlices, d_in + d_edge))
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    freqs = np.abs(rng.standard_normal(jcfg.nFreqs)) + 0.1
    X = rng.standard_normal((n, d_in))
    jmt = J.to_multi_table(J.from_edge_index(ei, n, edge_features=ef,
                                             dtype=jnp.float64))
    tmt = T.to_multi_table(T.from_edge_index(ei, n, edge_features=ef,
                                             dtype=np.float64)).to('cpu')

    def jloss(x, v, f):
        out = j_overlap(x, jmt, v, f, jcfg, proj_gather_fn=lambda a: a,
                        n_chunks=4, aggregate='sort')
        return jnp.sum(out * jnp.cos(out)), out
    # jitted: op by op, the JAX side takes seconds
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(X), jnp.asarray(proj), jnp.asarray(freqs))
    ts = [torch.tensor(a, requires_grad=True) for a in (X, proj, freqs)]
    got = fsw_embed_local_overlap(ts[0], tmt, ts[1], ts[2], tcfg,
                                  proj_gather_fn=lambda a: a, n_chunks=4,
                                  aggregate='sort')
    torch.sum(got * torch.cos(got)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-12)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-10, atol=1e-12)
    # the overlap equals the single-device table embedding
    emb = T.FSWEmbedding(tcfg, device='cpu', dtype=torch.float64)
    with torch.no_grad():
        emb.proj_vecs.copy_(torch.from_numpy(proj))
        emb.freqs.copy_(torch.from_numpy(freqs))
        np.testing.assert_allclose(
            emb(torch.from_numpy(X), graph=tmt, aggregate='sort').numpy(),
            got.detach().numpy(), rtol=1e-10, atol=1e-12)


def test_fswembedding_overlap_needs_a_table():
    emb = T.FSWEmbedding(TConfig(d_in=3, d_out=6), device='cpu')
    g = T.from_edge_index(np.array([[0, 1], [1, 0]]), 2)
    with pytest.raises(ValueError, match='NeighborTable or MultiTable'):
        emb(torch.zeros(2, 3), graph=g, proj_gather_fn=lambda a: a)
