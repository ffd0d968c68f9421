"""Layer-wise inference of the port (train/infer.py) against its own full
forward and against the JAX package's, and the Trainer's `eval_node_chunk`.

Tolerances:
  * chunk graphs: exact (the same host arrays).
  * layer-wise against the full forward, one package: rtol 5e-5, atol
    2e-5, the JAX package's own (tests/test_infer.py): the chunks' scans
    restart at chunk boundaries, so float32 sums associate differently.
  * port against JAX, bridged weights: rtol 1e-4 with an absolute floor
    of 1e-4 of the largest logit, as the other float32 FSWGNN parity tests
    (test_torch_gnn.py).
  * the chunked Trainer against the full-graph one: rtol 2e-5, atol 1e-6,
    the JAX package's own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu.train.infer import _chunk_graphs as jax_chunk_graphs
from fsw_gnn_tpu.train.infer import layerwise_predict as jax_layerwise
from fsw_gnn_tpu_torch.data import synthetic_planted_partition
from fsw_gnn_tpu_torch.train import TrainConfig, Trainer
from fsw_gnn_tpu_torch.train.infer import _chunk_graphs, layerwise_predict

GRAPH_KWARGS = [{}, {'self_loop_weight': 0.3, 'edge_weighting': 'gcn'}]
GRAPH_IDS = ['unit', 'loops-gcn']


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data():
    return synthetic_planted_partition(num_nodes=300, num_classes=3,
                                       feat_dim=16, p_in=0.08, p_out=0.01,
                                       seed=0)


@pytest.mark.parametrize('node_chunk', [32, 64, 300])
@pytest.mark.parametrize('graph_kwargs', GRAPH_KWARGS, ids=GRAPH_IDS)
def test_chunk_graphs_match_jax(data, graph_kwargs, node_chunk):
    jg = J.from_edge_index(data.edge_index, data.num_nodes,
                           dtype=jnp.float32, **graph_kwargs)
    tg = T.from_edge_index(data.edge_index, data.num_nodes,
                           dtype=np.float32, **graph_kwargs)
    jchunks, jbounds, jcap = jax_chunk_graphs(jg, node_chunk)
    chunks, bounds, e_cap = _chunk_graphs(tg, node_chunk)
    assert (bounds, e_cap) == (jbounds, jcap)
    assert len(chunks) == len(jchunks) == -(-data.num_nodes // node_chunk)
    for c, jc in zip(chunks, jchunks):
        for f in ('src', 'dst', 'weight', 'row_ptr', 'in_degrees',
                  'src_order', 'src_sorted'):
            np.testing.assert_array_equal(getattr(c, f),
                                          np.asarray(getattr(jc, f)), f)
            assert getattr(c, f).dtype == np.asarray(getattr(jc, f)).dtype
        assert c.edge_feat is None and jc.edge_feat is None
        assert (c.num_nodes, c.num_recipients, c.num_edges) == (
            jc.num_nodes, jc.num_recipients, jc.num_edges)
        assert c.padded_num_edges == e_cap
    if node_chunk == 32:
        # the envelope caps a step's edges far below the whole edge list
        assert e_cap * 4 <= tg.padded_num_edges


def test_chunk_graphs_reject_a_rectangular_graph(data):
    g = T.from_edge_index(data.edge_index, data.num_nodes,
                          num_recipients=data.num_nodes + 1)
    with pytest.raises(ValueError, match='square'):
        _chunk_graphs(g, 64)


@pytest.mark.parametrize('graph_kwargs', GRAPH_KWARGS, ids=GRAPH_IDS)
def test_layerwise_predict_matches_full_forward(data, graph_kwargs):
    tg = T.from_edge_index(data.edge_index, data.num_nodes,
                           dtype=np.float32, **graph_kwargs)
    model = T.FSWGNN(16, (8, data.num_classes), minimize_slice_coherence=False,
                     device='cpu', generator=torch.Generator().manual_seed(1))
    X = torch.from_numpy(data.features)
    model.train()
    got = layerwise_predict(model, X, tg, node_chunk=64, device='cpu')
    assert model.training            # the caller's mode comes back
    with torch.no_grad():
        want = model.eval()(X, tg.to('cpu')).numpy()
    assert got.shape == (data.num_nodes, data.num_classes)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=2e-5)


@pytest.mark.parametrize('graph_kwargs', GRAPH_KWARGS, ids=GRAPH_IDS)
def test_layerwise_predict_matches_jax(data, graph_kwargs):
    jg = J.from_edge_index(data.edge_index, data.num_nodes,
                           dtype=jnp.float32, **graph_kwargs)
    tg = T.from_edge_index(data.edge_index, data.num_nodes,
                           dtype=np.float32, **graph_kwargs)
    X = data.features
    jm = J.FSWGNN(in_channels=16, hidden_dims=(8, data.num_classes),
                  minimize_slice_coherence=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X), jg)
    tm = T.fswgnn_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                           device='cpu', in_channels=16,
                           hidden_dims=(8, data.num_classes))
    want = jax_layerwise(jm, variables, jnp.asarray(X), jg, node_chunk=64)
    got = layerwise_predict(tm, X, tg, node_chunk=64, device='cpu')
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_trainer_eval_node_chunk_matches_full(data):
    cfg = dict(hidden_dims=(8,), epochs=2, eval_every=10, seed=5)
    full = Trainer(data, TrainConfig(**cfg), device='cpu')
    capped = Trainer(data, TrainConfig(**cfg, eval_node_chunk=50),
                     device='cpu')
    for _ in range(2):
        full.train_epoch()
        capped.train_epoch()
    np.testing.assert_allclose(capped.predict(), full.predict(),
                               rtol=2e-5, atol=1e-6)
    assert full.evaluate() == capped.evaluate()
