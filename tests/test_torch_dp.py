"""Data-parallel minibatch training across 2 gloo ranks on the CPU
(`parallel.launch`) against the JAX package on 2 virtual devices: one
`make_dp_train_step` step (the wave's loss, every summed gradient and the
averaged BatchNorm running statistics; float64 on the CSR path, rtol
1e-10, the statistics 1e-6 as flax keeps them in float32), and the batches
of `MinibatchTrainer(num_devices=2)`'s epoch: rank r's k-th batch is the
JAX trainer's batch w + r of wave k, bit for bit (both samplers on their
numpy path)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import fsw_gnn_tpu as J
from fsw_gnn_tpu.data import NeighborSampler as JSampler
from fsw_gnn_tpu.data import sampler as jsampler
from fsw_gnn_tpu.data import synthetic_planted_partition as jsynth
from fsw_gnn_tpu.parallel import make_data_mesh, make_dp_train_step
from fsw_gnn_tpu.parallel import dp as jdp
from fsw_gnn_tpu.train import MinibatchTrainer as JMinibatchTrainer
from fsw_gnn_tpu.train import TrainConfig as JTrainConfig

import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch.parallel.launch import launch

DATA = dict(num_nodes=200, num_classes=3, feat_dim=8, p_in=0.1, p_out=0.02,
            seed=0)
KW = dict(in_channels=8, hidden_dims=(8, 3), minimize_slice_coherence=False,
          batchnorm=True)
GRAPH_FIELDS = ('src', 'dst', 'weight', 'row_ptr', 'in_degrees',
                'src_order', 'src_sorted')


@pytest.fixture
def numpy_samplers(monkeypatch):
    monkeypatch.setattr(jsampler, '_LIB', None)
    monkeypatch.setattr(jsampler, '_LIB_TRIED', True)


def _jax_batches(D=2, bs=8, fanouts=(4,)):
    """D batches drawn as tests/test_dp.py draws them, in float64."""
    data = jsynth(**DATA)
    sampler = JSampler(data.edge_index, data.num_nodes, fanouts=fanouts,
                       seed=0)
    max_nodes, max_edges = bs * 5, 128
    rng = np.random.default_rng(0)
    train_ids = np.nonzero(data.train_mask)[0]
    out = []
    for _ in range(D):
        seeds = rng.choice(train_ids, bs, replace=False)
        b = sampler.sample(seeds, labels=data.labels, max_nodes=max_nodes)
        g = J.from_edge_index(b.edge_index_local, max_nodes,
                              pad_to=max_edges, dtype=jnp.float64)
        g = dataclasses.replace(g, num_edges=max_edges)
        lab = np.zeros(max_nodes, np.int32)
        m = np.zeros(max_nodes, np.float64)
        lab[:b.num_seeds] = b.seed_labels
        m[:b.num_seeds] = 1.0
        out.append((g, data.features[b.node_ids].astype(np.float64), lab, m))
    return out


def test_stack_batches_and_local_batch(numpy_samplers):
    """`stack_batches` stacks as the JAX package's does, and
    `local_batch(stack, r)` gives back batch r."""
    from fsw_gnn_tpu_torch.parallel.dp import local_batch, stack_batches
    batches = _jax_batches(D=3)
    want = jdp.stack_batches([b[0] for b in batches],
                             [jnp.asarray(b[1]) for b in batches],
                             [jnp.asarray(b[2]) for b in batches],
                             [jnp.asarray(b[3]) for b in batches])
    port = [T.Graph(**{f: np.asarray(getattr(b[0], f))
                       for f in GRAPH_FIELDS},
                    num_nodes=b[0].num_nodes,
                    num_recipients=b[0].num_recipients,
                    num_edges=b[0].num_edges) for b in batches]
    got = stack_batches(port, [b[1] for b in batches],
                        [b[2] for b in batches], [b[3] for b in batches])
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(got[0], f),
                                      np.asarray(getattr(want[0], f)))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for r, (g, x, lab, m) in enumerate(batches):
        lg, lx, ly, lm = local_batch(got, r)
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(lg, f),
                                          np.asarray(getattr(g, f)))
        assert lg.num_edges == g.num_edges
        np.testing.assert_array_equal(lx.numpy(), x)
        np.testing.assert_array_equal(ly.numpy(), lab)
        np.testing.assert_array_equal(lm.numpy(), m)


EPOCH = dict(config=dict(hidden_dims=(8,), epochs=1, seed=3), batch_size=16,
             fanouts=(3, 2))


@pytest.fixture(scope='module')
def dp_runs():
    """One launch of 2 processes for the module: the DP step on the JAX
    batches (drawn on the numpy sampler path) with the JAX model's initial
    variables, then the DP epoch; every rank's results of each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsampler, '_LIB', None)
        mp.setattr(jsampler, '_LIB_TRIED', True)
        batches = _jax_batches()
    jm = J.FSWGNN(dtype=jnp.float64, **KW)
    # jitted: the CSR path's scans run op by op for seconds otherwise
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(batches[0][1]), batches[0][0])
    port_batches = []
    for g, x, lab, m in batches:
        b = {f: np.asarray(getattr(g, f)) for f in GRAPH_FIELDS}
        b.update(edge_feat=None, num_nodes=g.num_nodes,
                 num_recipients=g.num_recipients, num_edges=g.num_edges,
                 X=x, labels=lab, mask=m)
        port_batches.append(b)
    case = dict(dtype='float64', model=KW,
                variables=jax.tree_util.tree_map(np.asarray, variables))
    work = [('dp_step', dict(case=case, batches=port_batches)),
            ('dp_epoch', dict(EPOCH, data_kwargs=DATA))]
    reports = launch(2, 'fsw_gnn_tpu_torch.parallel.workers:tasks',
                     dict(tasks=work), device='cpu', timeout=240)
    return dict(batches=batches, jm=jm, variables=variables,
                step=[r[0] for r in reports], epoch=[r[1] for r in reports])


def test_dp_step_matches_jax(numpy_samplers, dp_runs):
    batches, jm = dp_runs['batches'], dp_runs['jm']
    gs, X, labels, mask = jdp.stack_batches(
        [b[0] for b in batches], [jnp.asarray(b[1]) for b in batches],
        [jnp.asarray(b[2]) for b in batches],
        [jnp.asarray(b[3]) for b in batches])
    variables = dp_runs['variables']
    params = variables['params']
    bstats = {'batch_stats': variables['batch_stats']}
    fixed = {k: v for k, v in variables.items()
             if k not in ('params', 'batch_stats')}
    opt = optax.sgd(1.0)
    step = make_dp_train_step(jm, opt, gs, make_data_mesh(2),
                              fixed_collections=fixed)
    p_new, _, b_new, loss = step(jax.tree_util.tree_map(jnp.array, params),
                                 opt.init(params), bstats, gs, X, labels,
                                 mask, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), params,
                                   p_new)
    want = T.fswgnn_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               {'params': grads, **fixed, **b_new}),
        device='cpu', dtype=torch.float64, **KW)
    want_grads = dict(want.named_parameters())
    want_stats = dict(want.named_buffers())
    for r in dp_runs['step']:
        np.testing.assert_allclose(r['loss'], float(loss), rtol=1e-10)
        assert set(r['grads']) == set(want_grads)
        for k, g in r['grads'].items():
            np.testing.assert_allclose(g, want_grads[k].detach().numpy(),
                                       rtol=1e-10, atol=1e-12)
        assert r['stats']
        for k, s in r['stats'].items():
            w = want_stats[k].numpy()
            np.testing.assert_allclose(s, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


def _jax_dp_trainer(data, config, batch_size, fanouts):
    """The state the JAX MinibatchTrainer's data-parallel epoch reads, set
    up in the order its __init__ sets it up (the sampler, the epoch
    generator, the template batch its step is built from), without its
    model: its `_build_batch` and `_train_epoch_dp` then run on this
    object as they run on the trainer, the DP step a no-op."""
    jt = types.SimpleNamespace(
        data=data, batch_size=batch_size, fanouts=tuple(fanouts),
        dp_devices=config.num_devices, step_count=0,
        _key=jax.random.PRNGKey(config.seed + 1), params=None,
        opt_state=None, batch_stats={},
        _dp_step=lambda p, o, b, *rest: (p, o, b, jnp.float32(0.0)))
    jt.sampler = JSampler(data.edge_index, data.num_nodes,
                          fanouts=jt.fanouts, seed=config.seed)
    nodes_cap, edges_cap, frontier = 1, 0, 1
    for f in jt.fanouts:
        frontier *= f
        nodes_cap += frontier
        edges_cap += frontier
    jt.max_nodes = batch_size * nodes_cap
    jt.max_edges = max(128, -(-batch_size * edges_cap // 128) * 128)
    jt.train_seeds = np.nonzero(data.train_mask)[0]
    jt._rng = np.random.default_rng(config.seed)
    jt._build_batch = lambda seeds: JMinibatchTrainer._build_batch(jt, seeds)
    jt._build_batch(jt.train_seeds[:min(batch_size, len(jt.train_seeds))])
    return jt


def test_dp_epoch_batches_are_the_jax_trainers(numpy_samplers, dp_runs):
    """Every rank samples the whole wave and keeps batch w + r: its
    batches are the JAX trainer's stacked ones, bit for bit, and the ranks
    end the epoch with one model."""
    jt = _jax_dp_trainer(jsynth(**DATA),
                         JTrainConfig(num_devices=2, **EPOCH['config']),
                         batch_size=EPOCH['batch_size'],
                         fanouts=EPOCH['fanouts'])
    waves = []
    real_stack = jdp.stack_batches

    def record(graphs, Xs, labels, masks):
        waves.append([(g, np.asarray(x), np.asarray(y), np.asarray(m))
                      for g, x, y, m in zip(graphs, Xs, labels, masks)])
        return real_stack(graphs, Xs, labels, masks)
    jdp.stack_batches = record
    try:
        JMinibatchTrainer._train_epoch_dp(jt)
    finally:
        jdp.stack_batches = real_stack
    reports = dp_runs['epoch']
    assert len(waves) >= 2
    for rank, r in enumerate(reports):
        assert len(r['batches']) == len(waves)
        for wave, got in zip(waves, r['batches']):
            g, x, y, m = wave[rank]
            for f in ('src', 'dst', 'weight', 'row_ptr'):
                np.testing.assert_array_equal(got[f], np.asarray(
                    getattr(g, f)), err_msg=f)
            np.testing.assert_array_equal(got['X'], x)
            np.testing.assert_array_equal(got['labels'], y)
            np.testing.assert_array_equal(got['mask'], m)
        assert np.isfinite(r['loss'])
    for k, v in reports[0]['state'].items():
        np.testing.assert_array_equal(reports[1]['state'][k], v)
