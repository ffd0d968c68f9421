"""Two departures of the port's first slice from the JAX package, each
held against the JAX package here.

1. BatchNorm in train mode: flax `nn.BatchNorm` normalises with the biased
   batch variance and moves its running statistics with decay 0.99, the
   running variance taking the biased variance too.  torch's BatchNorm1d
   defaults (momentum 0.1, unbiased running variance) drift from it after
   the first training step.
2. weights_grad=False: the JAX package passes it to the rank kernel as
   with_dw, which then gives the table weights no gradient through the
   aggregation (their only gradient is the total-mass encoding's).

Tolerances: float64 rtol 1e-10 (same arithmetic up to summation order;
flax computes the batch variance as E[x^2] - E[x]^2, the port in two
passes), except the running statistics, rtol 1e-6: flax keeps them in
float32 whatever the parameter type; the float32 rank route
|port - jax| <= 1e-5 * max|jax| + 1e-4 * |jax| (the rank kernels' float32
trig, see test_torch_rank.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu import embedding as JE
from fsw_gnn_tpu_torch import embedding as TE


def test_flax_batchnorm_train_mode():
    """The seeded 10 x 3 batch: three train-mode calls of flax BatchNorm
    and the port's, outputs and running statistics after each."""
    rng = np.random.default_rng(0)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float64,
                       param_dtype=jnp.float64)
    xs = [rng.standard_normal((10, 3)) * (1 + i) + i for i in range(3)]
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    tb = T.FlaxBatchNorm(3, dtype=torch.float64).train()
    with torch.no_grad():
        tb.weight.copy_(torch.linspace(0.5, 1.5, 3, dtype=torch.float64))
        tb.bias.copy_(torch.linspace(-1.0, 1.0, 3, dtype=torch.float64))
    variables = {'params': {'scale': tb.weight.detach().numpy(),
                            'bias': tb.bias.detach().numpy()},
                 'batch_stats': variables['batch_stats']}
    for x in xs:
        want, upd = bn.apply(variables, jnp.asarray(x),
                             mutable=['batch_stats'])
        variables = {'params': variables['params'], **upd}
        got = tb(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
        stats = variables['batch_stats']
        np.testing.assert_allclose(tb.running_mean.numpy(),
                                   np.asarray(stats['mean']), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tb.running_var.numpy(),
                                   np.asarray(stats['var']), rtol=1e-6)
    tb.eval()
    bn_eval = fnn.BatchNorm(use_running_average=True, dtype=jnp.float64,
                            param_dtype=jnp.float64)
    np.testing.assert_allclose(
        tb(torch.from_numpy(xs[0])).detach().numpy(),
        np.asarray(bn_eval.apply(variables, jnp.asarray(xs[0]))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('mlp_layers', [0, 3])
def test_fswconv_batchnorm_train_mode_matches_jax(mlp_layers):
    """FSWConv with batchnorm_final=True (and batchnorm_hidden with an
    MLP): three train-mode calls under mutable=['batch_stats'] against the
    bridged port module in .train(), float64, sort route."""
    rng = np.random.default_rng(1)
    n = 40
    A = rng.random((n, n)) < 0.15
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    jl = J.to_multi_table(J.from_edge_index(ei, n, dtype=jnp.float64))
    tl = T.to_multi_table(T.from_edge_index(ei, n, dtype=np.float64))
    kw = dict(in_channels=5, out_channels=6, mlp_layers=mlp_layers,
              batchnorm_final=True, batchnorm_hidden=True,
              concat_self=mlp_layers > 0)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float64, **kw)
    X0 = rng.standard_normal((n, 5))
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a), jm.init(jax.random.PRNGKey(1),
                                       jnp.asarray(X0), jl))
    tm = T.fswconv_from_jax(variables, device='cpu', dtype=torch.float64,
                            **kw).train()
    for step in range(3):
        X = rng.standard_normal((n, 5)) * (1 + step)
        want, upd = jm.apply(variables, jnp.asarray(X), jl, train=True,
                             aggregate='sort', mutable=['batch_stats'])
        variables = dict(variables, **upd)
        with torch.no_grad():
            got = tm(torch.from_numpy(X), tl, aggregate='sort').numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        for key, bn in tm.head.bn.items():
            name = 'bn_final' if key == 'final' else f'bn_{key}'
            stats = variables['batch_stats']['head'][name]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(stats['mean']),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(stats['var']), rtol=1e-6)


def _table_setup(rng):
    n = 24
    A = rng.random((n, n)) < 0.3
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A)).astype(np.int64)
    w = np.abs(rng.standard_normal(ei.shape[1])) * 0.3
    jt = J.to_neighbor_table(J.from_edge_index(ei, n, edge_weight=w,
                                               dtype=jnp.float32))
    tt = T.to_neighbor_table(T.from_edge_index(ei, n, edge_weight=w,
                                               dtype=np.float32))
    X = rng.standard_normal((n, 3)).astype(np.float32)
    return jt, tt, X


@pytest.mark.parametrize('weights_grad', [False, True])
def test_rank_route_weight_gradient_matches_jax(weights_grad):
    """A table whose weights require grad, through the fused rank route:
    the gradient in the weights equals JAX's, with weights_grad=False (no
    gradient through the aggregation, only the total-mass encoding's) and
    True (the kernels' dwn / dpad loop)."""
    rng = np.random.default_rng(2)
    jt, tt, X = _table_setup(rng)
    kw = dict(d_in=3, d_out=17, encode_total_mass=True, freqs_init='spread')
    jcfg, tcfg = JE.FSWConfig(**kw), TE.FSWConfig(**kw)
    V = rng.standard_normal((tcfg.nSlices, 3)).astype(np.float32)
    freqs = (rng.random(tcfg.nFreqs) * 5).astype(np.float32)
    G = rng.standard_normal((tt.num_recipients, 17)).astype(np.float32)

    def jloss(w):
        out = JE.fsw_embed_table(jnp.asarray(X), jt.replace(weight=w),
                                 jnp.asarray(V), jnp.asarray(freqs), jcfg,
                                 aggregate='rank', weights_grad=weights_grad)
        return jnp.sum(out * G)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(tt.weight)))
    w = torch.tensor(tt.weight, requires_grad=True)
    table = tt.to('cpu')
    table.weight = w
    out = TE.fsw_embed_table(torch.from_numpy(X), table,
                             torch.from_numpy(V), torch.from_numpy(freqs),
                             tcfg, aggregate='rank',
                             weights_grad=weights_grad)
    (out * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    if not weights_grad:
        # the aggregation's share is what the repair removes
        full = np.asarray(jax.grad(lambda w: jnp.sum(JE.fsw_embed_table(
            jnp.asarray(X), jt.replace(weight=w), jnp.asarray(V),
            jnp.asarray(freqs), jcfg, aggregate='rank',
            weights_grad=True) * G))(jnp.asarray(tt.weight)))
        assert np.abs(full - want).max() > 1e-2 * np.abs(full).max()


def test_auto_keeps_wide_classes_off_the_rank_kernels(monkeypatch):
    """A 2000-node graph whose node 0 has 1024 in-edges: `auto_layout`
    builds a degree class 1024 wide, more than the rank kernels' shared
    memory holds a row of.  Under 'auto' no rank call may see a width
    above 128 (such classes take the sort route, as in the JAX package),
    and the float32 FSWConv forward matches JAX's 'auto' (its sort route
    on the CPU) within test_torch_conv.py's float32 tolerance."""
    from chip_smoke import hub_graph
    ei, rng = hub_graph(0)
    n = int(ei.max()) + 1
    X = rng.standard_normal((n, 64)).astype(np.float32)
    jl = J.auto_layout(J.from_edge_index(ei, n, dtype=jnp.float32))
    tl = T.auto_layout(T.from_edge_index(ei, n, dtype=np.float32))
    assert max(t.bucket_size for t in tl.tables) == 1024
    kw = dict(in_channels=64, out_channels=64, mlp_layers=3)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float32, **kw)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(X), jl))
    tm = T.fswconv_from_jax(variables, device='cpu', **kw).eval()

    widths = []
    for name in ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate'):
        def spy(*args, _real=getattr(TE, name), **kwargs):
            widths.append(args[0].shape[1])
            return _real(*args, **kwargs)
        monkeypatch.setattr(TE, name, spy)
    with torch.no_grad():
        got = tm(torch.from_numpy(X), tl).numpy()
    assert widths and max(widths) <= 128, sorted(set(widths))
    assert len(widths) == sum(t.bucket_size <= 128 for t in tl.tables)
    want = np.asarray(jm.apply(variables, jnp.asarray(X), jl))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=2e-5 * np.abs(want).max())
