"""The distributed Trainer across 2 gloo processes on the CPU (the
counterpart of the JAX package's tests/test_multiprocess.py): it trains,
rank 0 alone writes the checkpoints, both ranks resume from the same
step and hold one model; its losses are the single-device Trainer's (the
same model and data, dropout 0: the exchange changes only the summation
order, float32, rtol 1e-4 over a few Adam steps).  And the command line
through the launcher: one JSON line, from rank 0."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fsw_gnn_tpu_torch.data import synthetic_planted_partition
from fsw_gnn_tpu_torch.parallel.launch import launch
from fsw_gnn_tpu_torch.train import TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(num_nodes=120, num_classes=3, feat_dim=6, p_in=0.1, p_out=0.01,
            seed=0)
EXCHANGES = ('all_to_all', 'overlap')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """One launch of 2 processes for the module: for each exchange a fit
    of 4 epochs and its resumption to 6 in a checkpoint directory of its
    own, then the refusal of num_devices=3; and the single-device
    Trainer's 6 epochs on the same data from the same seed."""
    root = tmp_path_factory.mktemp('dist_trainer')
    work = [('trainer_fit', dict(
        data_kwargs=DATA, runs=[dict(epochs=4), dict(epochs=6)],
        config=dict(hidden_dims=(8,), eval_every=2, checkpoint_every=2,
                    exchange=ex, checkpoint_dir=str(root / ex))))
        for ex in EXCHANGES] + [('mesh_refusal', dict(num_devices=3))]
    reports = launch(2, 'fsw_gnn_tpu_torch.parallel.workers:tasks',
                     dict(tasks=work), device='cpu', timeout=240)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = Trainer(synthetic_planted_partition(**DATA),
                         TrainConfig(hidden_dims=(8,), epochs=6,
                                     eval_every=2), device='cpu')
        single.fit()
    finally:
        torch.set_num_threads(threads)
    return dict(root=root, reports=reports,
                single=[h['loss'] for h in single.history])


@pytest.mark.parametrize('exchange', EXCHANGES)
def test_two_process_trainer_checkpoints_and_resumes(exchange, runs):
    i = EXCHANGES.index(exchange)
    first = [r[i][0] for r in runs['reports']]
    second = [r[i][1] for r in runs['reports']]
    # rank 0 wrote steps 2 and 4, then 6; rank 1 nothing
    assert [r['written'] for r in first] == [[2, 4], []]
    assert [r['written'] for r in second] == [[6], []]
    assert sorted(os.listdir(runs['root'] / exchange)) == [
        f'step_{s:08d}.pt' for s in (2, 4, 6)]
    assert [r['resumed_from'] for r in first] == [0, 0]
    assert [r['resumed_from'] for r in second] == [4, 4]
    for run in (first, second):
        assert run[0]['history'] == run[1]['history']
        assert run[0]['final'] == run[1]['final']
        for k, v in run[0]['state'].items():
            np.testing.assert_array_equal(run[1]['state'][k], v)
    # the single-device trainer on the same data from the same seed
    got = [h['loss'] for h in first[0]['history'] + second[0]['history']]
    np.testing.assert_allclose(got, runs['single'], rtol=1e-4)


def test_cli_train_through_the_launcher():
    cmd = [sys.executable, '-m', 'fsw_gnn_tpu_torch.parallel.launch',
           '--nproc', '2', '--timeout', '200', '--', 'train', '--dataset',
           'tiny', '--hidden', '8', '--epochs', '2', '--num-devices', '2',
           '--exchange', 'all_to_all', '--device', 'cpu']
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{')]
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert out['processes'] == 2 and out['device'] == 'cpu'
    assert out['epochs_run'] == 2


def test_a_world_of_another_size_raises(runs):
    """Inside a process group of 2, num_devices=3 names both numbers and
    how to launch (the refusal without any group is in
    tests/test_torch_trainer.py)."""
    for r in runs['reports']:
        assert 'num_devices=3' in r[-1] and 'world size 2' in r[-1]
        assert 'torchrun --nproc-per-node 3' in r[-1]
