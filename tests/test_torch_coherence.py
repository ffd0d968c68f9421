"""The coherence minimizer (`ops/coherence.py`) against the JAX package's,
and what waits on it: models built with their default arguments
(minimize_slice_coherence=True) and the mlp_layers=0, concat_self head's
coherence-minimized `dim_reduct`.

Tolerances:
  * float64: elementwise 1e-10.  Both run the same state machine on the
    same products; what differs is the rounding of the products and powers
    (about 1e-14 after a few hundred iterations), and every step decision
    falls alike.
  * float32, stage by stage from the same frame: elementwise 1e-4, the
    coherence within 1e-5, the same step and the same keep-or-revert (the
    stages agree to about 2e-7).  End to end, the coherence within 1e-4 of
    the initial one: see test_minimizer_f32_matches_jax for why the frames
    themselves can part.
  * the mlp_layers=0 head, float32, sort route on both sides: 1e-5 of the
    output's scale.  The cumsum sums in another order on each side, which
    moves the embedding by ulps; the head is one product.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu.ops.coherence as JC
import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.ops.coherence as TC
from fsw_gnn_tpu_torch.params import (generate_freqs, generate_params,
                                      generate_proj_vecs)


def _frame(n, d, seed=0):
    return np.random.default_rng(seed * 1000 + n * 7 + d).standard_normal(
        (n, d))


_jit_min = jax.jit(JC.minimize_mutual_coherence)


@pytest.mark.parametrize('n,d', [(8, 3), (20, 5), (64, 16), (127, 64)])
def test_minimizer_f64_matches_jax(n, d):
    X = _frame(n, d)
    want = np.asarray(_jit_min(jnp.asarray(X)))
    got = TC.minimize_mutual_coherence(torch.from_numpy(X))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    # the same schedule stage by stage: the same frame, a bounded count
    Xs, step, iters = TC._normalize_rows(torch.from_numpy(X)), TC._STEP_INIT, 0
    for p in TC.P_SCHEDULE:
        Xs, step, it, _ = TC._minimize_p(Xs, p, step)
        iters += it
    assert torch.equal(Xs, got)
    assert 0 < iters <= 1000 * len(TC.P_SCHEDULE)
    assert (float(TC.mutual_coherence(got))
            < float(TC.mutual_coherence(torch.from_numpy(X))))


_jit_stage = jax.jit(JC._minimize_p)


@pytest.mark.parametrize('n,d', [(20, 5), (64, 16)])
def test_minimizer_f32_matches_jax(n, d):
    """float32, stage by stage: each JAX stage starts from the port's
    frame and step before that stage, and must end at the same step, keep
    or revert alike, and give the same frame (1e-4) and coherence (1e-5).
    End to end the two chains are compared by their coherence only: a
    stage at large p follows the one largest Gram entry, so a difference of
    one ulp between the chains can send them to different frames of about
    the same coherence (at (20, 5) the stage at p = 100 turns 7e-7 into
    2e-3, with the same iterations and steps)."""
    X = _frame(n, d, seed=1).astype(np.float32)
    Xt = TC._normalize_rows(torch.from_numpy(X))
    step = TC._STEP_INIT
    for p in TC.P_SCHEDULE:
        start = Xt.numpy()
        wX, wstep = _jit_stage(jnp.asarray(start), jnp.float32(p),
                               jnp.float32(step))
        Xt, step, _, kept = TC._minimize_p(Xt, p, step)
        assert Xt.dtype == torch.float32
        assert step == float(wstep)
        # a reverted stage gives back its start, bit for bit
        assert kept == (not np.array_equal(np.asarray(wX), start))
        np.testing.assert_allclose(Xt.numpy(), np.asarray(wX), rtol=0,
                                   atol=1e-4)
        assert abs(float(TC.mutual_coherence(Xt))
                   - float(JC.mutual_coherence(wX))) <= 1e-5
    got = TC.minimize_mutual_coherence(torch.from_numpy(X))
    assert torch.equal(got, Xt)
    want = np.asarray(_jit_min(jnp.asarray(X)))
    mu0 = float(TC.mutual_coherence(torch.from_numpy(X)))
    mu_t = float(TC.mutual_coherence(got))
    mu_j = float(JC.mutual_coherence(jnp.asarray(want)))
    assert max(mu_t, mu_j) < mu0
    assert abs(mu_t - mu_j) <= 1e-4 * mu0


def test_gram_and_coherence_match_jax():
    X = _frame(11, 4, seed=2) * 3.0
    np.testing.assert_allclose(
        TC.gram_offdiag(torch.from_numpy(X)).numpy(),
        np.asarray(JC.gram_offdiag(jnp.asarray(X))), rtol=1e-14, atol=1e-14)
    got = TC.mutual_coherence(torch.from_numpy(X)).item()
    assert got == pytest.approx(
        float(JC.mutual_coherence(jnp.asarray(X))), rel=1e-14)
    assert T.mutual_coherence is TC.mutual_coherence
    assert T.minimize_mutual_coherence is TC.minimize_mutual_coherence


def test_minimizer_edge_cases():
    empty = torch.zeros((0, 3), dtype=torch.float64)
    assert TC.minimize_mutual_coherence(empty) is empty
    one = torch.from_numpy(_frame(1, 5) * 4.0)
    got = TC.minimize_mutual_coherence(one)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JC.minimize_mutual_coherence(
            jnp.asarray(one.numpy()))), rtol=1e-15)
    assert torch.linalg.norm(got, dim=1).item() == pytest.approx(1.0,
                                                                 abs=1e-15)
    many = TC.minimize_mutual_coherence(torch.from_numpy(_frame(30, 6) * 5))
    torch.testing.assert_close(torch.linalg.norm(many, dim=1),
                               torch.ones(30, dtype=torch.float64),
                               rtol=0, atol=1e-12)


def test_generate_proj_vecs_minimizes_the_same_draw():
    """With the minimizer on, the slice vectors are the port's minimizer
    applied to the frame the same seed draws with it off; generate_params
    draws the slice vectors first, then the frequencies."""
    on = T.FSWConfig(d_in=5, d_out=13, encode_total_mass=True,
                     minimize_slice_coherence=True, freqs_init='random')
    off = dataclasses.replace(on, minimize_slice_coherence=False)
    V_on = generate_proj_vecs(torch.Generator().manual_seed(3), on,
                              torch.float64, 'cpu')
    V_off = generate_proj_vecs(torch.Generator().manual_seed(3), off,
                               torch.float64, 'cpu')
    assert V_on.shape == (12, 5)
    assert torch.equal(V_on, TC.minimize_mutual_coherence(V_off))
    assert TC.mutual_coherence(V_on) < TC.mutual_coherence(V_off)
    # float32: the float64 result, cast
    V32 = generate_proj_vecs(torch.Generator().manual_seed(3), on,
                             device='cpu')
    assert V32.dtype == torch.float32 and torch.equal(V32, V_on.float())

    gen = torch.Generator().manual_seed(4)
    params = generate_params(gen, on, torch.float64, 'cpu')
    gen = torch.Generator().manual_seed(4)
    assert torch.equal(params['proj_vecs'],
                       generate_proj_vecs(gen, on, torch.float64, 'cpu'))
    assert torch.equal(params['freqs'],
                       generate_freqs(gen, on, torch.float64, 'cpu'))
    assert params['bias'].shape == (13,) and not params['bias'].any()
    assert params['total_mass_scale'].item() == 1.0
    assert T.generate_params is generate_params


def test_default_device_is_the_card():
    """The parameter draws and gnn_layer_conv default to the card, as every
    entry point does: there they place their tensors, and with no card
    they raise before any work (the minimizer never runs on the host
    unasked)."""
    cfg = T.FSWConfig(d_in=5, d_out=13, minimize_slice_coherence=True)
    model = T.FSWGNN(4, (6, 3), device='cpu')
    calls = {
        'proj_vecs': lambda g: generate_proj_vecs(g, cfg),
        'freqs': lambda g: generate_freqs(g, cfg),
        'params': lambda g: generate_params(g, cfg)['proj_vecs'],
        'gnn_layer_conv': lambda g: next(
            T.gnn_layer_conv(model, 0, generator=g).parameters()),
    }
    for name, call in calls.items():
        gen = torch.Generator().manual_seed(0)
        if torch.cuda.is_available():
            assert call(gen).device.type == 'cuda', name
        else:
            with pytest.raises(RuntimeError, match='no CUDA device'):
                call(gen)


def _small_graph(n=12, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < 0.3
    np.fill_diagonal(A, False)
    return np.stack(np.nonzero(A)).astype(np.int64)


def test_models_build_and_run_with_default_arguments():
    """FSWConv, FSWReadout, FSWGNN and FSWGraphClassifier with every
    argument at its default (minimize_slice_coherence=True), and the
    mlp_layers=0, concat_self head, on the CPU at small widths."""
    n = 12
    ei = _small_graph(n)
    g = T.from_edge_index(ei, n)
    X = torch.from_numpy(
        np.random.default_rng(1).standard_normal((n, 4)).astype(np.float32))
    for conv in (T.FSWConv(4, 3, device='cpu'),
                 T.FSWConv(4, 3, mlp_layers=0, device='cpu')):
        for layout in (g, T.to_multi_table(g)):
            with torch.no_grad():
                out = conv(X, layout)
            assert out.shape == (n, 3) and torch.isfinite(out).all()
    raw = T.FSWConv(4, 3, minimize_slice_coherence=False, device='cpu')
    assert (T.mutual_coherence(conv.fsw_embed.proj_vecs.detach())
            < T.mutual_coherence(raw.fsw_embed.proj_vecs.detach()))
    assert conv.head.dim_reduct.shape == (3, 2 * 4 + 4)

    readout = T.FSWReadout(4, 2, device='cpu')
    pool = T.readout_graph(np.repeat([0, 1], [5, 7]), n, 2)
    assert torch.isfinite(readout(X, pool)).all()

    gnn = T.FSWGNN(4, (6, 3), device='cpu')
    out = gnn(X, T.to_multi_table(g))
    out.sum().backward()
    assert out.shape == (n, 3)
    assert all(torch.isfinite(p.grad).all() for p in gnn.parameters())

    cls = T.FSWGraphClassifier(4, (6,), 2, device='cpu')
    logits = cls(X, g, pool)
    assert logits.shape == (2, 2) and torch.isfinite(logits).all()


@pytest.mark.parametrize('learnable', [True, False])
def test_mlp_layers_0_concat_self_matches_jax(learnable):
    """The dimensionality-reduction head: JAX's variables (dim_reduct in
    'params' when learnable, in 'fsw_fixed' otherwise) carried by the
    bridge; the forward in float32 against JAX's, and the port's own
    dim_reduct a parameter or a buffer alike."""
    n = 24
    ei = _small_graph(n, seed=2)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    kw = dict(in_channels=5, out_channels=3, mlp_layers=0,
              concat_self=True, learnable_embedding=learnable,
              batchnorm_final=True)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float32, **kw)
    jt = J.to_neighbor_table(J.from_edge_index(ei, n, dtype=jnp.float32))
    variables = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(X), jt))
    coll = 'params' if learnable else 'fsw_fixed'
    assert variables[coll]['head']['dim_reduct'].shape == (3, 2 * 5 + 5)
    bn = variables['batch_stats']['head']['bn_final']
    bn['mean'] = rng.standard_normal(3).astype(np.float32)
    bn['var'] = (0.5 + rng.random(3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(X), jt,
                               aggregate='sort'))
    tm = T.fswconv_from_jax(variables, device='cpu', **kw).eval()
    np.testing.assert_array_equal(
        tm.head.dim_reduct.detach().numpy(),
        variables[coll]['head']['dim_reduct'])
    tt = T.to_neighbor_table(T.from_edge_index(ei, n))
    with torch.no_grad():
        got = tm(torch.from_numpy(X), tt, aggregate='sort').numpy()
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    own = T.FSWConv(device='cpu', **kw)
    names = dict(own.named_parameters())
    assert ('head.dim_reduct' in names) == learnable
    assert 'head.dim_reduct' in own.state_dict()
    torch.testing.assert_close(
        torch.linalg.norm(own.head.dim_reduct.detach(), dim=1),
        torch.ones(3), rtol=0, atol=1e-6)
