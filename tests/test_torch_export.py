"""The port's export (`export_forward`, `load_forward`, `save_artifact`,
`load_artifact`, `export_from_checkpoint`, `cli export`) on the CPU.

The exported forward against the module it came from: the same ops on
the same inputs, so the same bits.  Against the JAX package's
`export_forward` / `load_forward` artifact of the same variables (carried
across by the bridge) on the same inputs: |port - jax| <= 1e-4 max|jax| +
1e-4 |jax| (float32), as tests/test_torch_serving.py: on the CPU the JAX
model's 'auto' takes the sort route, the port the rank route, whose
phases are reduced exactly.  A checkpoint's artifact against the
Trainer's own forward: the same bits.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu.serving as JS
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch import cli
from fsw_gnn_tpu_torch.data.datasets import synthetic_planted_partition

N, D_IN, DIMS = 24, 5, (6, 3)


def _graph(rng, n, p=0.2):
    A = rng.random((n, n)) < p
    np.fill_diagonal(A, False)
    return np.stack(np.nonzero(A)).astype(np.int64)


@pytest.fixture(scope='module')
def models():
    rng = np.random.default_rng(0)
    ei = _graph(rng, N)
    X = rng.standard_normal((N, D_IN)).astype(np.float32)
    jm = J.FSWGNN(in_channels=D_IN, hidden_dims=DIMS,
                  minimize_slice_coherence=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X),
                        J.from_edge_index(ei, N))
    tm = T.fswgnn_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                           device='cpu', in_channels=D_IN, hidden_dims=DIMS)
    return jm, variables, tm.eval(), ei, X


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('layout', ['multi', 'csr'])
def test_export_round_trip(models, layout, tmp_path):
    """export_forward -> bytes -> save_artifact / load_artifact (and
    load_forward) -> the module's bits, and the JAX artifact's values on
    the same graph and features.  The artifact keeps its graph: another
    X of the same shape gives the module's output on it."""
    jm, variables, tm, ei, X = models
    jg = J.from_edge_index(ei, N)
    tg = T.from_edge_index(ei, N)
    if layout == 'multi':
        jg, tg = J.to_multi_table(jg), T.to_multi_table(tg)
    Xt = torch.from_numpy(X)
    blob = T.export_forward(tm, torch.empty((N, D_IN), device='meta'), tg,
                            device='cpu')
    assert isinstance(blob, bytes) and blob
    path = str(tmp_path / 'fswgnn.pt2')
    T.save_artifact(path, blob)
    for fwd in (T.load_artifact(path), T.load_forward(blob)):
        with torch.no_grad():
            for Xi in (Xt, Xt.flip(0)):
                assert torch.equal(fwd(Xi), tm(Xi, tg.to('cpu')))
    jblob = JS.export_forward(jm, variables,
                              jax.ShapeDtypeStruct(X.shape, X.dtype), jg)
    want = np.asarray(JS.load_forward(jblob)(jnp.asarray(X)))
    with torch.no_grad():
        _close(T.load_forward(blob)(Xt).numpy(), want)


def test_export_traces_no_values(models):
    """The export reads no value of the graph or of X (fake tensors): a
    graph whose weights are NaN still exports, and the artifact computes
    with the weights it was given."""
    _, _, tm, ei, X = models
    tg = T.to_multi_table(T.from_edge_index(ei, N))
    for t in tg.tables:
        t.weight = np.full_like(t.weight, np.nan)
    fwd = T.load_forward(T.export_forward(
        tm, torch.empty((N, D_IN), device='meta'), tg, device='cpu'))
    assert bool(torch.isnan(fwd(torch.from_numpy(X))).any())


def _data():
    return synthetic_planted_partition(num_nodes=120, num_classes=3,
                                       feat_dim=8, p_in=0.1, p_out=0.01)


def test_export_from_checkpoint(tmp_path):
    """A Trainer run with checkpoint_dir, then export_from_checkpoint into
    a fresh model of the same architecture: the artifact gives the
    trained model's logits bit for bit, the latest step by default and an
    earlier one by `step`; a missing step raises."""
    ckpt = str(tmp_path / 'ckpt')
    cfg = T.TrainConfig(hidden_dims=(8,), epochs=3, eval_every=1,
                        checkpoint_dir=ckpt, checkpoint_every=2)
    tr = T.Trainer(_data(), cfg, device='cpu')
    tr.fit()
    want = tr.predict()

    def fresh():
        return T.Trainer(_data(), T.TrainConfig(hidden_dims=(8,), seed=5),
                         device='cpu').model
    blob = T.export_from_checkpoint(ckpt, fresh(), tr.X, tr.compute_graph,
                                    device='cpu')
    got = T.load_forward(blob)(tr.X).detach().numpy()
    np.testing.assert_array_equal(got, want)
    steps = tr.all_steps()
    assert len(steps) >= 2
    early = T.load_forward(T.export_from_checkpoint(
        ckpt, fresh(), tr.X, tr.compute_graph, step=steps[0],
        device='cpu'))(tr.X).detach().numpy()
    assert not np.array_equal(early, want)
    with pytest.raises(FileNotFoundError):
        T.export_from_checkpoint(ckpt, fresh(), tr.X, tr.compute_graph,
                                 step=10 ** 6, device='cpu')


def test_cli_export(tmp_path, capsys):
    """`cli train --checkpoint-dir` then `cli export`: the JSON line of
    the JAX command (artifact, bytes, checkpoint_step) and an artifact
    that gives the trained model's logits."""
    ckpt, out = str(tmp_path / 'ckpt'), str(tmp_path / 'model.pt2')
    common = ['--dataset', 'tiny', '--hidden', '8', '--device', 'cpu']
    assert cli.main(['train', *common, '--epochs', '2', '--eval-every', '1',
                     '--checkpoint-dir', ckpt]) == 0
    capsys.readouterr()
    assert cli.main(['export', *common, '--checkpoint-dir', ckpt,
                     '--out', out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {'artifact', 'bytes', 'checkpoint_step'}
    assert line['artifact'] == out and line['checkpoint_step'] == 2
    with open(out, 'rb') as f:
        assert len(f.read()) == line['bytes']
    from fsw_gnn_tpu_torch.data.datasets import load
    tr = T.Trainer(load('tiny'), T.TrainConfig(hidden_dims=(8,),
                                               checkpoint_dir=ckpt),
                   device='cpu')
    tr.restore_checkpoint()
    got = T.load_artifact(out)(tr.X).detach().numpy()
    np.testing.assert_array_equal(got, tr.predict())
