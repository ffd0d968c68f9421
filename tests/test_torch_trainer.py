"""The port's single-device `Trainer` against the JAX package's, and its
own behaviour: learning, checkpoints, auto-resume, metrics, the trace and
the options that are not ported.

Parity runs start both trainers from the same parameters (the JAX
trainer's, carried over by `fswgnn_from_jax`) with dropout 0.  JAX takes
its CPU default, the sort route; the port its rank route (the plain
versions on the CPU).  Both compute the same function in float32, so the
per-epoch losses agree to rtol 1e-4: the embeddings differ by float32
rounding (about 1e-6 of their scale) and five Adam steps carry that
through without a gain above ten.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu.parallel.dist import \
    masked_softmax_cross_entropy as jax_masked_ce
from fsw_gnn_tpu.train import TrainConfig as JTrainConfig
from fsw_gnn_tpu.train import Trainer as JTrainer
from fsw_gnn_tpu_torch import cli
from fsw_gnn_tpu_torch.data import synthetic_planted_partition
from fsw_gnn_tpu_torch.train import (TrainConfig, Trainer, lr_schedule,
                                     masked_softmax_cross_entropy)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Small shapes: torch's thread pool only adds contention when pytest
    runs several workers on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def data():
    return synthetic_planted_partition(num_nodes=300, num_classes=3,
                                       feat_dim=16, p_in=0.08, p_out=0.01,
                                       seed=0)


def _bridged_trainer(jt, data, cfg):
    """A port Trainer on the CPU holding the JAX trainer's variables."""
    variables = jax.tree_util.tree_map(
        np.asarray, {'params': jt.params, **jt.batch_stats, **jt.fixed})
    model = T.fswgnn_from_jax(
        variables, device='cpu', in_channels=data.features.shape[1],
        hidden_dims=tuple(cfg['hidden_dims']) + (data.num_classes,),
        mlp_layers=cfg.get('mlp_layers', 1),
        batchnorm=cfg.get('batchnorm', False))
    return Trainer(data, TrainConfig(**cfg), device='cpu', model=model)


@pytest.mark.parametrize('case', ['adam', 'adamw', 'adam-bn-warmup_cosine'])
def test_epoch_losses_match_jax(data, case):
    cfg = dict(hidden_dims=(8,), epochs=5, eval_every=5, learning_rate=2e-2,
               seed=3)
    if case == 'adamw':
        cfg['weight_decay'] = 5e-2
    if case == 'adam-bn-warmup_cosine':
        cfg.update(batchnorm=True, mlp_layers=2, lr_schedule='warmup_cosine',
                   warmup_epochs=2)
    jt = JTrainer(data, JTrainConfig(**cfg))
    tt = _bridged_trainer(jt, data, cfg)
    want = [jt.train_epoch() for _ in range(5)]
    got = [tt.train_epoch() for _ in range(5)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if cfg.get('batchnorm'):
        # the bias of a Linear that BatchNorm follows has a gradient of
        # rounding size, which Adam's first steps turn into moves of +-lr
        # with signs of their own on each side: train mode cancels it, eval
        # mode does not.  So predict() is held against JAX's from JAX's
        # trained state: it must use eval mode, the running statistics
        tt.model.load_state_dict(_bridged_trainer(jt, data, cfg)
                                 .model.state_dict())
    logits_j, logits_t = jt.predict(), tt.predict()
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-3,
                               atol=1e-3 * np.abs(logits_j).max())


@pytest.mark.parametrize('schedule', [None, 'cosine', 'warmup_cosine'])
def test_lr_schedule_matches_optax(schedule):
    cfg = TrainConfig(learning_rate=3e-2, lr_schedule=schedule, epochs=40,
                      warmup_epochs=7)
    if schedule is None:
        want = lambda count: 3e-2
    elif schedule == 'cosine':
        want = optax.cosine_decay_schedule(3e-2, 40)
    else:
        want = optax.warmup_cosine_decay_schedule(0.0, 3e-2, 7, 40)
    got = lr_schedule(cfg)
    for count in range(45):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=count)
    with pytest.raises(ValueError, match='unknown lr_schedule'):
        lr_schedule(TrainConfig(lr_schedule='step'))


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((20, 5))
    labels = rng.integers(0, 5, 20)
    mask = (rng.random(20) < 0.5).astype(np.float64)
    s, c = masked_softmax_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(mask))
    js, jc = jax_masked_ce(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(mask))
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-6)
    assert c.item() == float(jc)


def test_training_learns(data):
    """The thresholds of the JAX package's tests/test_trainer.py."""
    tr = Trainer(data, TrainConfig(hidden_dims=(16,), epochs=60,
                                   eval_every=10, learning_rate=2e-2),
                 device='cpu')
    out = tr.fit()
    assert out['final']['train_acc'] > 0.9, out
    assert out['final']['test_acc'] > 0.75, out


def test_checkpoint_roundtrip(data, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    tr = Trainer(data, TrainConfig(hidden_dims=(8,), epochs=5, eval_every=5,
                                   checkpoint_dir=ckpt, checkpoint_every=5,
                                   batchnorm=True),
                 device='cpu')
    tr.fit()
    tr.save_checkpoint()
    logits_before = tr.predict()
    assert os.listdir(ckpt) == ['step_00000005.pt']

    tr2 = Trainer(data, TrainConfig(hidden_dims=(8,), epochs=5, eval_every=5,
                                    checkpoint_dir=ckpt, seed=123,
                                    batchnorm=True),
                  device='cpu')
    assert not np.allclose(tr2.predict(), logits_before)
    step = tr2.restore_checkpoint()
    assert step == tr.step_count == tr2.step_count
    np.testing.assert_array_equal(tr2.predict(), logits_before)
    # the optimizer state came along: the next step is the same
    assert tr2.train_epoch() == tr.train_epoch()


def test_checkpoints_keep_the_newest_three(data, tmp_path):
    ckpt = str(tmp_path / 'ckpt_keep')
    tr = Trainer(data, TrainConfig(hidden_dims=(4,), epochs=6, eval_every=6,
                                   checkpoint_dir=ckpt, checkpoint_every=1),
                 device='cpu')
    tr.fit()
    assert tr.all_steps() == [4, 5, 6]
    assert sorted(os.listdir(ckpt)) == [f'step_{s:08d}.pt' for s in (4, 5, 6)]
    with pytest.raises(FileNotFoundError):
        Trainer(data, TrainConfig(hidden_dims=(4,),
                                  checkpoint_dir=str(tmp_path / 'none')),
                device='cpu').restore_checkpoint()


def test_auto_resume_continues_preempted_run(data, tmp_path):
    """fit() restores the latest checkpoint and trains only the remaining
    epochs; the resumed run ends where an uninterrupted one does."""
    ckpt = str(tmp_path / 'ckpt_resume')
    cfg = dict(hidden_dims=(8,), epochs=6, eval_every=3,
               checkpoint_dir=ckpt, checkpoint_every=3)

    tr1 = Trainer(data, TrainConfig(**{**cfg, 'epochs': 3}), device='cpu')
    tr1.fit()
    assert tr1.step_count == 3

    tr2 = Trainer(data, TrainConfig(**cfg), device='cpu')
    out = tr2.fit()
    assert out['epochs_run'] == 3          # only epochs 4..6 ran
    assert tr2.step_count == 6
    assert tr2.history[0]['epoch'] == 4

    whole = Trainer(data, TrainConfig(**{**cfg, 'checkpoint_dir': None}),
                    device='cpu')
    whole.fit()
    np.testing.assert_array_equal(tr2.predict(), whole.predict())

    tr3 = Trainer(data, TrainConfig(**cfg), device='cpu')
    assert tr3.fit()['epochs_run'] == 0    # already complete
    tr4 = Trainer(data, TrainConfig(**cfg, auto_resume=False), device='cpu')
    assert tr4.fit()['epochs_run'] == 6


def test_metrics_jsonl_export(data, tmp_path):
    path = str(tmp_path / 'metrics.jsonl')
    tr = Trainer(data, TrainConfig(hidden_dims=(8,), epochs=4, eval_every=2,
                                   metrics_path=path),
                 device='cpu')
    tr.fit()
    with open(path) as f:
        lines = [json.loads(l) for l in f]
    epochs = [l['epoch'] for l in lines if 'epoch' in l]
    assert epochs == [1, 2, 3, 4]
    assert all('loss' in l for l in lines if 'epoch' in l)
    assert 'val_acc' in lines[1]           # eval_every=2
    assert 'final' in lines[-1]


def test_reused_checkpoint_dir_overwrites_stale_same_step(data, tmp_path):
    """A previous run's entry with the same step number is replaced, not
    skipped: the already-on-disk shortcut is tracked in the process, never
    inferred from latest_step()."""
    ckpt = str(tmp_path / 'ckpt_reuse')
    cfg = dict(hidden_dims=(8,), epochs=2, eval_every=10,
               checkpoint_dir=ckpt)

    def two_steps(seed):
        tr = Trainer(data, TrainConfig(**cfg, seed=seed), device='cpu')
        tr.train_epoch()
        tr.train_epoch()
        tr.save_checkpoint()
        return tr

    old, new = two_steps(0), two_steps(99)
    chk = Trainer(data, TrainConfig(**cfg, seed=99), device='cpu')
    assert chk.restore_checkpoint() == 2
    got = chk.model.state_dict()
    for k, v in new.model.state_dict().items():
        assert torch.equal(got[k], v), k
    k = next(iter(got))
    assert not torch.equal(got[k], old.model.state_dict()[k])


def test_trace_dir_writes_a_profiler_trace(data, tmp_path):
    trace = tmp_path / 'trace'
    Trainer(data, TrainConfig(hidden_dims=(4,), epochs=2, eval_every=2,
                              trace_dir=str(trace)),
            device='cpu').fit()
    events = json.loads((trace / 'trace.json').read_text())['traceEvents']
    assert any('fsw' in str(e.get('name', '')).lower()
               or 'aten::' in str(e.get('name', '')) for e in events)


def test_unported_options_raise(data):
    for cfg in (TrainConfig(num_devices=2), TrainConfig(eval_node_chunk=64)):
        with pytest.raises(NotImplementedError, match='item 1[14]'):
            Trainer(data, cfg, device='cpu')
    with pytest.raises(NotImplementedError, match='item 11'):
        cli.main(['train', '--minibatch', '--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='item 14'):
        cli.main(['train', '--num-devices', '4', '--device', 'cpu'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        if torch.cuda.is_available():
            raise RuntimeError('no CUDA device: (a card is present)')
        Trainer(data, TrainConfig())
    with pytest.raises(ValueError, match='model dims'):
        Trainer(data, TrainConfig(hidden_dims=(8,)), device='cpu',
                model=T.FSWGNN(16, (4, 3), minimize_slice_coherence=False,
                               device='cpu'))


def test_cli_train_on_the_cpu(tmp_path, monkeypatch, capsys):
    small = synthetic_planted_partition(num_nodes=60, num_classes=3,
                                        feat_dim=5, p_in=0.2, p_out=0.02,
                                        seed=2)
    np.savez(tmp_path / 'tiny.npz', edge_index=small.edge_index,
             features=small.features, labels=small.labels,
             train_mask=small.train_mask, val_mask=small.val_mask,
             test_mask=small.test_mask)
    monkeypatch.setenv('FSW_DATA_DIR', str(tmp_path))
    metrics = tmp_path / 'm.jsonl'
    assert cli.main(['train', '--dataset', 'tiny', '--hidden', '8', '4',
                     '--epochs', '3', '--eval-every', '3', '--device', 'cpu',
                     '--metrics-path', str(metrics)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out['dataset'] == 'tiny' and out['device'] == 'cpu'
    assert out['epochs_run'] == 3 and 0.0 <= out['train_acc'] <= 1.0
    assert len(metrics.read_text().splitlines()) == 4
