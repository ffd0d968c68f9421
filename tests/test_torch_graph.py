"""The port's host-side graph builders against the JAX package's: the
same inputs give equal arrays (exact: both are numpy integer and float
bookkeeping in the same order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fsw_gnn_tpu.graph as jg
import fsw_gnn_tpu_torch.graph as tg


def _edges(rng, n, p=0.15, dup=True):
    A = rng.random((n, n)) < p
    src, dst = np.nonzero(A)                 # includes some self-loops
    ei = np.stack([src, dst]).astype(np.int64)
    if dup:                                  # duplicate a few edges
        ei = np.concatenate([ei, ei[:, :5]], axis=1)
    return ei


def _eq(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=name)


def _same_graph(j, t):
    for name in ('src', 'dst', 'weight', 'row_ptr', 'in_degrees',
                 'src_order', 'src_sorted'):
        _eq(getattr(j, name), getattr(t, name), name)
    assert (j.edge_feat is None) == (t.edge_feat is None)
    if t.edge_feat is not None:
        _eq(j.edge_feat, t.edge_feat, 'edge_feat')
    assert (j.num_nodes, j.num_recipients, j.num_edges) == (
        t.num_nodes, t.num_recipients, t.num_edges)


def _same_table(j, t):
    for name in ('idx', 'weight', 'in_degrees'):
        _eq(getattr(j, name), getattr(t, name), name)
    assert (j.edge_feat is None) == (t.edge_feat is None)
    if t.edge_feat is not None:
        _eq(j.edge_feat, t.edge_feat, 'edge_feat')
    assert j.uniform_w == t.uniform_w
    assert (j.num_nodes, j.num_recipients, j.num_edges) == (
        t.num_nodes, t.num_recipients, t.num_edges)


CASES = [
    dict(),
    dict(self_loop_weight=1.0),
    dict(edge_weighting='gcn'),
    dict(edge_feat=3),
    dict(self_loop_weight=2.0, edge_feat=2, pad_to=1024),
]


def _build(rng, n, case):
    ei = _edges(rng, n)
    kw = {k: v for k, v in case.items() if k != 'edge_feat'}
    ef = (rng.standard_normal((ei.shape[1], case['edge_feat']))
          if 'edge_feat' in case else None)
    j = jg.from_edge_index(ei, n, ef, dtype=jnp.float64, **kw)
    t = tg.from_edge_index(ei, n, ef, dtype=np.float64, **kw)
    return j, t


@pytest.mark.parametrize('case', range(len(CASES)))
def test_from_edge_index_matches_jax(case):
    j, t = _build(np.random.default_rng(case), 40, CASES[case])
    _same_graph(j, t)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_to_neighbor_table_matches_jax(case):
    j, t = _build(np.random.default_rng(10 + case), 40, CASES[case])
    _same_table(jg.to_neighbor_table(j), tg.to_neighbor_table(t))


@pytest.mark.parametrize('case', range(len(CASES)))
def test_to_multi_table_matches_jax(case):
    j, t = _build(np.random.default_rng(20 + case), 60, CASES[case])
    jm, tm = jg.to_multi_table(j), tg.to_multi_table(t)
    assert len(jm.tables) == len(tm.tables) > 1
    for a, b in zip(jm.tables, tm.tables):
        _same_table(a, b)
    for a, b in zip(jm.row_ids, tm.row_ids):
        _eq(a, b, 'row_ids')
    _eq(jm.in_degrees, tm.in_degrees, 'in_degrees')


def test_zero_degree_rows_and_forced_classes():
    """Isolated nodes (rows of degree 0) and a forced class structure with
    padded row capacities, as the serving envelope pins them."""
    rng = np.random.default_rng(7)
    n = 50
    ei = _edges(rng, 30, dup=False)          # nodes 30..49 have no edges
    j = jg.from_edge_index(ei, n, pad_to=512, as_numpy=True)
    t = tg.from_edge_index(ei, n, pad_to=512)
    _same_graph(j, t)
    classes, rows = [8, 16, 24, 32], [n, 24, 16, 8]
    jm = jg.to_multi_table(j, classes=classes, class_rows=rows,
                           as_numpy=True)
    tm = tg.to_multi_table(t, classes=classes, class_rows=rows)
    assert [tb.idx.shape for tb in tm.tables] == [(r, c) for r, c in
                                                  zip(rows, classes)]
    for a, b in zip(jm.tables, tm.tables):
        _same_table(a, b)
    for a, b in zip(jm.row_ids, tm.row_ids):
        _eq(a, b, 'row_ids')
    with pytest.raises(ValueError):
        tg.to_multi_table(t, classes=classes, class_rows=[8, 24, 16, 8])


@pytest.mark.parametrize('max_deg', [1, 8, 9, 20, 33, 100, 300])
def test_degree_classes_match_jax(max_deg):
    assert tg.degree_classes(max_deg) == jg.degree_classes(max_deg)


def test_detect_uniform_w_matches_jax():
    for wt in (np.array([[2.0, 2.0, 0.0]]), np.array([[2.0, 1.0, 0.0]]),
               np.array([[-1.0, -1.0]]), np.zeros((0, 4)),
               np.array([[1.0, 0.0], [3.0, 3.0]])):
        assert tg._detect_uniform_w(wt) == jg._detect_uniform_w(wt)


def test_to_device_gives_tensors():
    """`.to(device)` turns every array into a tensor: indices as int64,
    floats in their own dtype; the host copy is left as it was."""
    _, t = _build(np.random.default_rng(3), 30, dict(edge_feat=2))
    mt = tg.to_multi_table(t)
    md = mt.to('cpu')
    tb = md.tables[0]
    assert tb.idx.dtype == torch.int64 and tb.weight.dtype == torch.float64
    assert tb.edge_feat.shape == mt.tables[0].edge_feat.shape
    assert md.row_ids[0].dtype == torch.int64
    assert isinstance(mt.tables[0].idx, np.ndarray)
    gd = t.to('cpu')
    assert gd.src.dtype == torch.int64 and gd.num_edges == t.num_edges
