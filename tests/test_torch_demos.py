"""The port's demos (`fsw_gnn_tpu_torch/examples/`) on the CPU, end to end,
against the JAX demos of `examples/`.

  * Inputs: each demo's draws equal the JAX demo's (its statements up to
    its model, run from the file's syntax tree), bit for bit.
  * demo_conv's output, with the JAX `FSWConv`'s initialised parameters
    carried in (`bridge.fswconv_from_jax`), against the JAX layer applied
    to the JAX CSR graph of the same edges: float32 on both sides, the
    sort route, within 1e-4 of the output's scale (the served-output
    tolerance: other summation orders, three Linear layers after).
  * Each demo's `main(['--device', 'cpu'])` at a small size (the embedding
    demo's batch, the serving demo's epochs, dsmetric's size and steps):
    finite results, demo_serving's artifact against its module and its
    server's one capture a route (checked by the demo), dsmetric's
    isomorphic pair below the unrelated one, demo_distributed's three
    exchanges agreeing within 1e-4 on a gloo group of P = 2 (checked by
    the demo, as the JAX demo asserts).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / 'examples'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small shapes: torch's thread pool only adds contention when pytest
    runs several workers on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_statements(name, stop, fn=None):
    """The JAX demo's statements (module level, or `fn`'s body after the
    module's) up to the first whose source contains `stop`; returns the
    namespace."""
    path = EXAMPLES / f'{name}.py'
    tree = ast.parse(path.read_text())
    ns = {'__name__': f'_jax_{name}', '__file__': str(path)}
    body = []
    for n in tree.body:
        if isinstance(n, ast.If):
            continue
        if fn is None and stop in ast.unparse(n):
            break
        body.append(n)
    if fn is not None:
        main = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == fn)
        for n in main.body:
            if stop in ast.unparse(n):
                break
            body.append(n)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), 'exec'),
         ns)
    return ns


def test_demo_inputs_are_the_jax_demos():
    from fsw_gnn_tpu_torch.examples import (demo_conv, demo_distributed,
                                            demo_dsmetric)
    ns = _jax_statements('demo_conv', 'graph = auto_layout')
    ei, X, E = demo_conv.inputs()
    np.testing.assert_array_equal(ei, ns['edge_index'])
    np.testing.assert_array_equal(X, np.asarray(ns['node_features']))
    np.testing.assert_array_equal(E, ns['edge_features'])
    ns = _jax_statements('demo_distributed', 'model = FSWGNN(', fn='main')
    ei, X, y = demo_distributed.problem()
    np.testing.assert_array_equal(ei, np.stack([ns['src'][ns['keep']],
                                                ns['dst'][ns['keep']]]))
    np.testing.assert_array_equal(X, ns['X'])
    np.testing.assert_array_equal(y, ns['y'])
    ns = _jax_statements('demo_dsmetric', 'd_iso = ')
    for got, want in zip(demo_dsmetric.graphs(12),
                         (('A1', 'V1'), ('A2', 'V2'), ('A3', 'V3'))):
        for a, k in zip(got, want):
            np.testing.assert_array_equal(a, ns[k], err_msg=k)


def test_demo_conv_matches_the_jax_layer_on_its_parameters():
    from fsw_gnn_tpu import FSWConv as JaxConv
    from fsw_gnn_tpu import from_edge_index as jax_graph
    from fsw_gnn_tpu_torch.bridge import fswconv_from_jax
    from fsw_gnn_tpu_torch.examples import demo_conv as D
    ei, X, E = D.inputs()
    jg = jax_graph(ei, D.NUM_NODES, edge_features=E, dtype=jnp.float32)
    kw = dict(in_channels=D.VERTEX_DIM, out_channels=D.OUT_DIM,
              edgefeat_dim=D.EDGE_DIM, mlp_layers=3,
              learnable_embedding=True)
    jconv = JaxConv(**kw, minimize_slice_coherence=False)
    # jitted, the graph closed over: the JAX CSR path runs op by op
    # for many seconds otherwise
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, x: jconv.init(k, x, jg))(jax.random.PRNGKey(0),
                                           jnp.asarray(X)))
    want = np.asarray(jax.jit(lambda v, x: jconv.apply(v, x, jg))(
        variables, jnp.asarray(X)))
    conv = fswconv_from_jax(variables, device='cpu', **kw,
                            minimize_slice_coherence=False)
    got = D.main(['--device', 'cpu'], conv=conv).numpy()
    assert got.shape == (D.NUM_NODES, D.OUT_DIM)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_demo_conv_runs_with_its_default_arguments():
    """The minimizer runs (default minimize_slice_coherence=True)."""
    from fsw_gnn_tpu_torch.examples import demo_conv
    out = demo_conv.main(['--device', 'cpu'])
    assert out.shape == (demo_conv.NUM_NODES, demo_conv.OUT_DIM)
    assert bool(torch.isfinite(out).all())


def test_demo_fsw_embedding_runs_on_the_cpu(capsys):
    from fsw_gnn_tpu_torch.examples import demo_fsw_embedding
    out = demo_fsw_embedding.main(['--device', 'cpu'], batch_dims=(2, 3),
                                  n=16, d=5, embed_dim=24)
    assert out.shape == (2, 3, 24)
    assert 'Size of E(X):  (2, 3, 24)' in capsys.readouterr().out


def test_demo_serving_runs_on_the_cpu(capsys):
    from fsw_gnn_tpu_torch.examples import demo_serving
    out = demo_serving.main(['--device', 'cpu'], epochs=4)
    assert np.isfinite(out['final']['test_acc'])
    text = capsys.readouterr().out
    assert 'compiles so far: 2' in text and 'artifact:' in text


def test_demo_dsmetric_runs_on_the_cpu():
    from fsw_gnn_tpu_torch.examples import demo_dsmetric
    d_iso, d_rand = demo_dsmetric.main(['--device', 'cpu', '--n', '8',
                                        '--steps', '60'])
    assert 0.0 <= d_iso < d_rand


def test_demo_distributed_exchanges_agree_on_two_gloo_ranks(capsys):
    from fsw_gnn_tpu_torch.examples import demo_distributed
    out = demo_distributed.main(['--device', 'cpu', '--nproc', '2'])
    losses = out['losses']
    assert set(losses) == {'all_gather', 'all_to_all', 'overlap'}
    # the rank's counts come back; on the CPU no kernel launches
    assert set(out['launches']) >= {'fsw_rank_fwdp', 'segcumsum'}
    assert not any(out['launches'].values())
    assert all(np.isfinite(v) for v in losses.values())
    assert 'all three exchanges agree.' in capsys.readouterr().out
