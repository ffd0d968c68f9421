"""The port's `MinibatchTrainer` against the JAX package's: the batches it
builds, its first steps' losses from the same weights, its fixed shapes,
that it learns, and `cli train --minibatch`.

Tolerances: batches exact (the same sampler draws, the same host
arrays); losses rtol 1e-4, as the full-graph trainer's parity test
(test_torch_trainer.py): JAX takes the CSR sort route on the CPU, the port
the same route with its plain versions, both in float32.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu.train import MinibatchTrainer as JMinibatchTrainer
from fsw_gnn_tpu.train import TrainConfig as JTrainConfig
from fsw_gnn_tpu_torch import cli
from fsw_gnn_tpu_torch.data import synthetic_planted_partition
from fsw_gnn_tpu_torch.train import MinibatchTrainer, TrainConfig

GRAPH_FIELDS = ('src', 'dst', 'weight', 'row_ptr', 'in_degrees',
                'src_order', 'src_sorted')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data():
    return synthetic_planted_partition(num_nodes=400, num_classes=3,
                                       feat_dim=16, p_in=0.06, p_out=0.008,
                                       seed=1)


def _bridged(jt, data, cfg, **kw):
    """A port MinibatchTrainer on the CPU holding the JAX trainer's
    variables."""
    variables = jax.tree_util.tree_map(
        np.asarray, {'params': jt.params, **jt.batch_stats, **jt.fixed})
    model = T.fswgnn_from_jax(
        variables, device='cpu', in_channels=data.features.shape[1],
        hidden_dims=tuple(cfg['hidden_dims']) + (data.num_classes,),
        mlp_layers=cfg.get('mlp_layers', 1),
        batchnorm=cfg.get('batchnorm', False))
    return MinibatchTrainer(data, TrainConfig(**cfg), device='cpu',
                            model=model, **kw)


def test_build_batch_matches_jax(data):
    kw = dict(batch_size=32, fanouts=(4, 4))
    jt = JMinibatchTrainer(data, JTrainConfig(hidden_dims=(8,), seed=2), **kw)
    tt = MinibatchTrainer(data, TrainConfig(hidden_dims=(8,), seed=2),
                          device='cpu', **kw)
    assert (tt.max_nodes, tt.max_edges) == (jt.max_nodes, jt.max_edges) \
        == (32 * 21, 640)
    np.testing.assert_array_equal(tt.train_seeds, jt.train_seeds)
    fewer = 0
    for k in range(3):
        seeds = tt.train_seeds[32 * k:32 * (k + 1)]
        jg, jX, jlabels, jmask = jt._build_batch(seeds)
        g, Xb, labels, mask = tt._build_batch(seeds)
        np.testing.assert_array_equal(Xb.numpy(), np.asarray(jX))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f)), f)
        assert (g.num_nodes, g.num_recipients, g.num_edges) == (
            jg.num_nodes, jg.num_recipients, jg.num_edges) == (
            tt.max_nodes, tt.max_nodes, tt.max_edges)
        fewer += int((g.weight > 0).sum()) < tt.max_edges
    assert fewer == 3    # every batch has fewer real edges than max_edges


def test_num_edges_pin_changes_nothing_on_the_csr_path(data):
    """The JAX package pins a batch graph's num_edges to max_edges (its
    jit cache key); the port mirrors the field, and the CSR forward reads
    none of it: the same bits with the real count."""
    tt = MinibatchTrainer(data, TrainConfig(hidden_dims=(8,), seed=2),
                          batch_size=32, fanouts=(4, 4), device='cpu')
    g, Xb, _, _ = tt._build_batch(tt.train_seeds[:32])
    real = int((g.weight > 0).sum())
    assert g.num_edges == tt.max_edges > real
    tt.model.eval()
    with torch.no_grad():
        pinned = tt.model(Xb, g)
        unpinned = tt.model(Xb, dataclasses.replace(g, num_edges=real))
    assert torch.equal(pinned, unpinned)


@pytest.mark.parametrize('case', ['adam', 'bn-mlp2', 'warmup_cosine'])
def test_first_step_losses_match_jax(data, case):
    """Three steps from the JAX trainer's weights.  The schedule counts
    optimizer updates, as optax's does, not epochs."""
    cfg = dict(hidden_dims=(8,), learning_rate=2e-2, seed=3)
    if case == 'bn-mlp2':
        cfg.update(batchnorm=True, mlp_layers=2)
    if case == 'warmup_cosine':
        cfg.update(lr_schedule='warmup_cosine', warmup_epochs=2, epochs=6)
    kw = dict(batch_size=48, fanouts=(5, 5))
    jt = JMinibatchTrainer(data, JTrainConfig(**cfg), **kw)
    tt = _bridged(jt, data, cfg, **kw)
    want, got = [], []
    for k in range(3):
        seeds = tt.train_seeds[48 * k:48 * (k + 1)]
        g, Xb, labels, mask = jt._build_batch(seeds)
        (jt.params, jt.batch_stats, jt.opt_state,
         loss) = jt._mb_step(jt.params, jt.batch_stats, jt.opt_state, Xb, g,
                             labels, mask, jax.random.PRNGKey(k))
        want.append(float(loss))
        got.append(tt._mb_step(*tt._build_batch(seeds)).item())
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_every_batch_has_the_same_shapes(data):
    tt = MinibatchTrainer(data, TrainConfig(hidden_dims=(8,), seed=0),
                          batch_size=32, fanouts=(4,), device='cpu')
    shapes = []
    real = tt._build_batch

    def spy(seeds):
        out = real(seeds)
        g = out[0]
        shapes.append(tuple(tuple(getattr(g, f).shape)
                            for f in GRAPH_FIELDS)
                      + tuple(tuple(t.shape) for t in out[1:])
                      + ((g.num_nodes, g.num_recipients, g.num_edges),))
        return out
    tt._build_batch = spy
    loss = tt.train_epoch()
    assert np.isfinite(loss)
    assert len(shapes) == -(-len(tt.train_seeds) // 32) >= 3
    assert len(set(shapes)) == 1, set(shapes)


def test_minibatch_training_learns(data):
    tr = MinibatchTrainer(
        data, TrainConfig(hidden_dims=(16,), epochs=8, eval_every=4,
                          learning_rate=1e-2),
        batch_size=64, fanouts=(8, 8), device='cpu')
    out = tr.fit()
    assert np.isfinite(out['final']['train_acc'])
    assert out['final']['train_acc'] > 0.7, out


def test_cli_train_minibatch_on_the_cpu(tmp_path, monkeypatch, capsys):
    small = synthetic_planted_partition(num_nodes=120, num_classes=3,
                                        feat_dim=5, p_in=0.1, p_out=0.01,
                                        seed=2)
    np.savez(tmp_path / 'tiny.npz', edge_index=small.edge_index,
             features=small.features, labels=small.labels,
             train_mask=small.train_mask, val_mask=small.val_mask,
             test_mask=small.test_mask)
    monkeypatch.setenv('FSW_DATA_DIR', str(tmp_path))
    assert cli.main(['train', '--dataset', 'tiny', '--minibatch',
                     '--batch-size', '16', '--fanouts', '3,2', '--hidden',
                     '8', '--epochs', '2', '--eval-every', '2',
                     '--eval-node-chunk', '32', '--device', 'cpu']) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['dataset'] == 'tiny' and out['device'] == 'cpu'
    assert out['epochs_run'] == 2 and 0.0 <= out['train_acc'] <= 1.0
