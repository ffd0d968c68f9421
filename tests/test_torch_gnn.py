"""The training path's modules against the JAX package: the bench training
step of a small FSWConv, `FSWGNN` through `fswgnn_from_jax`, `auto_layout`
and the synthetic datasets.

Tolerances:
  * float64 on the sort route: rtol 1e-10 (the same arithmetic up to
    summation order).  Where BatchNorm's running statistics enter, 1e-6:
    flax keeps them in float32 and, in eval mode, forms rsqrt(var + eps)
    from them in float32.
  * float32 on the rank route (the JAX Pallas kernels in interpret mode
    against the port's plain versions): rtol 1e-4 with an absolute floor
    of 1e-4 (outputs) or 1e-3 (updates) of the largest entry.  The
    embedding agrees to about 1e-6 of its scale (test_torch_rank.py,
    test_torch_rank_bwd.py); the MLP head and three optimizer steps carry
    that through with a gain of a few.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu.data import datasets as JD
from chip_smoke import simple_graph
from fsw_gnn_tpu.models.gnn import FSWGNN as JFSWGNN
from fsw_gnn_tpu_torch.data import datasets as TD


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def test_bench_step_sgd_matches_jax():
    """bench.py's training step at a small size: FSWConv(16, 16,
    mlp_layers=3) on a ~200-node simple graph in the multi layout, three
    SGD(1e-3) steps on sum(out**2), float32, the rank route.  The port's
    parameter updates equal JAX's."""
    n, d = 200, 16
    ei, rng = simple_graph(0, n, 12)
    X = rng.standard_normal((n, d)).astype(np.float32)
    jg = J.to_multi_table(J.from_edge_index(ei, n, dtype=jnp.float32))
    tg = T.to_multi_table(T.from_edge_index(ei, n))
    assert len(tg.tables) >= 3
    kw = dict(in_channels=d, out_channels=d, mlp_layers=3)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float32, **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(X), jg)
    params = variables['params']
    fixed = {k: v for k, v in variables.items() if k != 'params'}
    tm = T.fswconv_from_jax(_np_tree(variables), device='cpu', **kw)
    init = {k: p.detach().clone() for k, p in tm.named_parameters()}

    opt = optax.sgd(1e-3)
    opt_state = opt.init(params)

    def loss_fn(p):
        out = jm.apply({'params': p, **fixed}, jnp.asarray(X), jg,
                       aggregate='rank')
        return jnp.sum(out * out)

    topt = torch.optim.SGD(tm.parameters(), lr=1e-3)
    Xt = torch.from_numpy(X)
    for _ in range(3):
        jl, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        topt.zero_grad()
        out = tm(Xt, tg)
        tl = (out * out).sum()
        tl.backward()
        topt.step()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    after = T.fswconv_from_jax(_np_tree({'params': params, **fixed}),
                               device='cpu', **kw)
    for (k, got), want in zip(tm.named_parameters(), after.parameters()):
        delta_want = (want - init[k]).detach().numpy()
        delta_got = (got - init[k]).detach().numpy()
        assert np.abs(delta_want).max() > 0, k
        np.testing.assert_allclose(delta_got, delta_want, rtol=1e-3,
                                   atol=1e-3 * np.abs(delta_want).max(),
                                   err_msg=k)


def _gnn_setup(batchnorm, f64, seed=0):
    rng = np.random.default_rng(seed)
    n = 48
    p = np.linspace(0.02, 0.4, n)[rng.permutation(n)]
    A = rng.random((n, n)) < p[None, :]
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    npdt = np.float64 if f64 else np.float32
    X = rng.standard_normal((n, 6)).astype(npdt)
    jg = J.to_multi_table(J.from_edge_index(
        ei, n, dtype=jnp.float64 if f64 else jnp.float32))
    tg = T.to_multi_table(T.from_edge_index(ei, n, dtype=npdt))
    kw = dict(in_channels=6, hidden_dims=(8, 5, 3), mlp_layers=2,
              batchnorm=batchnorm, aggregate='sort' if f64 else 'rank')
    jm = JFSWGNN(minimize_slice_coherence=False,
                 dtype=jnp.float64 if f64 else jnp.float32, **kw)
    variables = _np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(X),
                                 jg))
    if batchnorm:
        for conv in variables['batch_stats'].values():
            for bn in conv['head'].values():
                bn['mean'] = rng.standard_normal(bn['mean'].shape) \
                    .astype(np.float32)
                bn['var'] = (0.5 + rng.random(bn['var'].shape)) \
                    .astype(np.float32)
    tm = T.fswgnn_from_jax(variables, device='cpu',
                           dtype=torch.float64 if f64 else torch.float32,
                           **kw)
    return jm, variables, tm, X, jg, tg


@pytest.mark.parametrize('batchnorm', [False, True])
@pytest.mark.parametrize('f64', [True, False], ids=['f64-sort', 'f32-rank'])
def test_fswgnn_forward_matches_jax(batchnorm, f64):
    jm, variables, tm, X, jg, tg = _gnn_setup(batchnorm, f64)
    want = np.asarray(jm.apply(variables, jnp.asarray(X), jg))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(X), tg).numpy()
    assert got.shape == (X.shape[0], 3)
    if f64:
        tol = 1e-6 if batchnorm else 1e-10
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('batchnorm', [False, True])
def test_fswgnn_train_mode_matches_jax(batchnorm):
    """Train mode, float64, sort route: the output, the BatchNorm running
    statistics after the call, and the gradients of sum(sin(out)) in every
    parameter."""
    jm, variables, tm, X, jg, tg = _gnn_setup(batchnorm, True, seed=1)
    params = variables['params']
    rest = {k: v for k, v in variables.items() if k != 'params'}

    def jloss(p):
        out, upd = jm.apply({'params': p, **rest}, jnp.asarray(X), jg,
                            train=True, mutable=['batch_stats'])
        return jnp.sum(jnp.sin(out)), (out, upd)

    (_, (want, upd)), grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = tm.train()(torch.from_numpy(X), tg)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-10 * np.abs(want).max())
    after = T.fswgnn_from_jax(_np_tree({'params': grads, **rest, **upd}),
                              device='cpu', dtype=torch.float64,
                              in_channels=6, hidden_dims=(8, 5, 3),
                              mlp_layers=2, batchnorm=batchnorm)
    # the bias of a Linear that BatchNorm follows has a gradient of
    # rounding size: the floor is the largest gradient of any parameter
    floor = 1e-10 * max(g.abs().max().item() for g in after.parameters())
    for (k, p), g in zip(tm.named_parameters(), after.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(),
                                   rtol=1e-8, atol=floor, err_msg=k)
    for (k, b), w in zip(tm.named_buffers(), after.buffers()):
        if 'running' in k:
            np.testing.assert_allclose(b.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_fswgnn_layers_and_unported_options():
    tm = T.FSWGNN(10, (8, 4), minimize_slice_coherence=False, batchnorm=True,
                  dropout=0.5, device='cpu')
    assert [c.in_channels for c in tm.convs] == [10, 8]
    assert [c.out_channels for c in tm.convs] == [8, 4]
    assert list(tm.convs[0].head.bn) == ['0'] and not tm.convs[1].head.bn
    assert tm.convs[0].head.rates == [0.5] and tm.convs[1].head.rates == [0.0]
    assert tm.convs[1].head.acts == [None]
    # the distributed trainer's arguments: cross-rank BatchNorm is built
    # in every layer but the last; identity exchanges give the plain
    # forward
    bn = T.FSWGNN(4, (4, 2), minimize_slice_coherence=False, batchnorm=True,
                  bn_axis_name='g', device='cpu')
    assert bn.convs[0].head.bn['0'].axis_name == 'g'
    assert not bn.convs[1].head.bn
    g = T.to_multi_table(T.from_edge_index(np.array([[0, 1], [1, 0]]), 2))
    X = torch.randn(2, 10, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = tm.eval()(X, g)
        assert torch.equal(tm(X, g, gather_fn=lambda x: x), want)
        torch.testing.assert_close(
            tm(X, g, proj_gather_fn=lambda x: x, exchange_chunks=3), want,
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match='not both'):
        tm(X, g, gather_fn=lambda x: x, proj_gather_fn=lambda x: x)


def test_dropout_draws_from_the_callers_generator():
    tm = T.FSWGNN(6, (8, 3), minimize_slice_coherence=False, dropout=0.5,
                  device='cpu')
    g = T.to_multi_table(T.from_edge_index(
        np.array([[0, 1, 2, 3], [1, 2, 3, 0]]), 4))
    X = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    runs = [tm.train()(X, g, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with torch.no_grad():
        assert torch.equal(tm.eval()(X, g), tm(X, g))


@pytest.mark.parametrize('case', ['spread', 'uniform', 'empty'])
def test_auto_layout_picks_jax_layout(case):
    rng = np.random.default_rng(3)
    n = 40
    if case == 'spread':        # in-degrees 0 .. ~30: several classes
        p = np.linspace(0.0, 0.8, n)[rng.permutation(n)]
        A = rng.random((n, n)) < p[None, :]
    elif case == 'uniform':     # degree 2 everywhere: one class
        A = np.zeros((n, n), bool)
        A[np.arange(n), (np.arange(n) + 1) % n] = True
        A[np.arange(n), (np.arange(n) + 2) % n] = True
    else:
        A = np.zeros((n, n), bool)
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    jl = J.auto_layout(J.from_edge_index(ei, n, dtype=jnp.float32))
    tl = T.auto_layout(T.from_edge_index(ei, n))
    assert type(tl).__name__ == type(jl).__name__
    if isinstance(tl, T.MultiTable):
        assert [t.idx.shape for t in tl.tables] == \
            [tuple(t.idx.shape) for t in jl.tables]
    else:
        assert tl.idx.shape == tuple(jl.idx.shape)
    if ei.shape[1]:             # a degree above max_bucket: the CSR route
        g = T.from_edge_index(ei, n)
        assert T.auto_layout(g, max_bucket=1) is g
        assert isinstance(J.auto_layout(J.from_edge_index(ei, n),
                                        max_bucket=1), J.Graph)


def _same_data(a, b):
    assert a.name == b.name
    for f in ('edge_index', 'features', 'labels', 'train_mask', 'val_mask',
              'test_mask'):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_synthetic_planted_partition_equals_jax():
    _same_data(TD.synthetic_planted_partition(),
               JD.synthetic_planted_partition())
    kw = dict(num_nodes=90, num_classes=5, feat_dim=7, p_in=0.2,
              p_out=0.01, seed=4)
    _same_data(TD.synthetic_planted_partition(**kw),
               JD.synthetic_planted_partition(**kw))


def test_load_synthetic_fallback_and_npz_equal_jax(tmp_path, monkeypatch):
    """With no cora.npz the loaders fall back to the same size-matched
    synthetic graph; with one, both read it."""
    monkeypatch.setenv('FSW_DATA_DIR', str(tmp_path))
    assert TD.data_dir() == JD.data_dir() == str(tmp_path)
    cora = TD.load('cora')
    assert (cora.num_nodes, cora.features.shape[1], cora.num_classes) == \
        (2708, 1433, 7)
    _same_data(cora, JD.load('cora'))
    with pytest.raises(FileNotFoundError):
        TD.load('cora', allow_synthetic=False)
    small = TD.synthetic_planted_partition(num_nodes=30, seed=1)
    np.savez(tmp_path / 'tiny.npz', edge_index=small.edge_index,
             features=small.features, labels=small.labels,
             train_mask=small.train_mask, val_mask=small.val_mask,
             test_mask=small.test_mask)
    _same_data(TD.load('tiny'), JD.load('tiny'))
