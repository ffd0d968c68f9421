"""The port's CUDA kernels against their plain PyTorch versions on the
card.  They skip where there is no card.  This file imports no JAX, so on
the GPU machine it runs on its own:

    python -m pytest tests/test_torch_cuda.py -o addopts= --noconftest -m cuda
"""
import copy

import numpy as np
import pytest
import torch

from chip_smoke import dyadic
from fsw_gnn_tpu_torch.ops.fsw_rank import (
    fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_bwd,
    fsw_rank_aggregate_proj_bwd_plain, fsw_rank_aggregate_proj_plain)

NAMES = ('dZ', 'dwn', 'dpad', 'df', 'dV')


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import,
    so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is '
                    'False')
    from fsw_gnn_tpu_torch.device import resolve_device
    return resolve_device('cuda')      # also pins float32 products (no TF32)


def _args(rng, R, B, D, S, uniform_w):
    """float32 inputs with tied projections (repeated sender rows),
    zero-weight padding, an f = 0 slice and a 'spread'-range frequency."""
    Z = rng.standard_normal((R, B, D))
    Z[:, 1::4, :] = Z[:, 0::4, :]
    V = rng.standard_normal((D, S)) / np.sqrt(D)
    real = rng.random((R, B)) < 0.7
    real[:, 0] = True
    w = (real.astype(np.float64) if uniform_w
         else np.abs(rng.standard_normal((R, B))) * real)
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    freqs = np.abs(rng.standard_normal(S)) + 0.1
    freqs[1] = 0.0
    freqs[-1] = 2.0 * S - 1.0
    return [torch.from_numpy(a.astype(np.float32)) for a in
            (Z, w / wsp[:, None], np.maximum(1.0 - w_sum, 0.0) / wsp,
             freqs, V)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,D,S', [(8, 64, 127), (24, 64, 127),
                                   (64, 64, 127), (256, 256, 200),
                                   (48, 5, 7)])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank_kernel_matches_plain(cuda_device, B, D, S, uniform_w):
    """|kernel - plain| <= 2e-5 * max|plain| + 1e-5 * |plain|: the weighted
    ranks agree to the bit wherever the projections do; the projections
    differ by summation order and the trig by sincospi against the plain
    version's sin/cos."""
    args = [a.to(cuda_device) for a in
            _args(np.random.default_rng(B), 37, B, D, S, uniform_w)]
    before = fsw_rank_aggregate_proj.launches
    with torch.no_grad():
        got = fsw_rank_aggregate_proj(*args, uniform_w=uniform_w)
    torch.cuda.synchronize()
    assert fsw_rank_aggregate_proj.launches == before + 1
    want = fsw_rank_aggregate_proj_plain(*args, uniform_w=uniform_w)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=2e-5 * want.abs().max().item())


def _bwd_close(got, want, with_dw):
    """Each output within 1e-4 * its largest plain entry + 1e-4 * |plain|:
    with dyadic inputs the ranks agree, so what differs is the trig
    (sincospi against sin/cos of the wrapped phase, a few 1e-7) and the
    summation order of dZ (over S), dV (over R * B) and df (over R)."""
    for g, w, name in zip(got, want, NAMES):
        if w is None:
            assert g is None and not with_dw and name in ('dwn', 'dpad')
            continue
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item(),
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('B,D,S', [(8, 64, 127), (48, 64, 127),
                                   (256, 256, 200), (16, 1433, 2865),
                                   (48, 5, 7)])
@pytest.mark.parametrize('with_dw', [False, True])
def test_rank_bwd_kernel_matches_plain(cuda_device, B, D, S, with_dw):
    rng = np.random.default_rng(1000 + B + D)
    for uniform_w in (False, True):
        Z, wn, pad, freqs, V = _args(rng, 37, B, D, S, uniform_w)
        Z, V = dyadic(Z, V)
        G = torch.from_numpy(rng.standard_normal((37, S)).astype(np.float32))
        args = [a.to(cuda_device).contiguous()
                for a in (Z, wn, pad, freqs, V, G)]
        before = fsw_rank_aggregate_proj_bwd.launches
        got = fsw_rank_aggregate_proj_bwd(*args, uniform_w=uniform_w,
                                          with_dw=with_dw)
        torch.cuda.synchronize()
        assert fsw_rank_aggregate_proj_bwd.launches == before + 1
        want = fsw_rank_aggregate_proj_bwd_plain(*args, uniform_w=uniform_w,
                                                 with_dw=with_dw)
        _bwd_close(got, want, with_dw)
        dead = args[1] == 0
        assert torch.all(got[0][dead] == 0)     # padded entries: exactly 0
        again = fsw_rank_aggregate_proj_bwd(*args, uniform_w=uniform_w,
                                            with_dw=with_dw)
        for a, b in zip(got, again):            # no atomics: same bits
            assert a is None or torch.equal(a, b)


@pytest.mark.cuda
def test_rank_kernel_refuses_grad_and_bad_inputs(cuda_device):
    """Bad inputs raise; inputs that require grad do not: the autograd
    Function runs K1f forward and K1b backward on the card, and its
    gradients equal the plain backward's."""
    rng = np.random.default_rng(5)
    Z, wn, pad, freqs, V = _args(rng, 11, 16, 8, 40, False)
    Z, V = dyadic(Z, V)
    G = torch.from_numpy(rng.standard_normal((11, 40)).astype(np.float32))
    args = [a.to(cuda_device) for a in (Z, wn, pad, freqs, V)]
    Gd = G.to(cuda_device)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (fsw_rank_aggregate_proj.launches,
              fsw_rank_aggregate_proj_bwd.launches)
    (fsw_rank_aggregate_proj(*leaves) * Gd).sum().backward()
    torch.cuda.synchronize()
    assert (fsw_rank_aggregate_proj.launches,
            fsw_rank_aggregate_proj_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = fsw_rank_aggregate_proj_bwd_plain(*args, Gd, with_dw=True)
    _bwd_close([t.grad for t in leaves], want, True)

    bad = [torch.zeros(s, device=cuda_device) for s in
           [(2, 8, 3), (2, 8), (2,), (4,), (3, 4)]]
    with torch.no_grad():
        assert fsw_rank_aggregate_proj(*bad).shape == (2, 4)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError, match='float32'):
        fsw_rank_aggregate_proj(*bad)
    bad[0] = torch.zeros((2, 3, 8), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match='contiguous'):
        fsw_rank_aggregate_proj(*bad)


@pytest.mark.cuda
def test_fswconv_training_step_matches_cpu(cuda_device):
    """One SGD(1e-3) step on sum(out**2) of a small FSWConv (16 -> 16,
    3-layer head, 31 slices) on the card and on the CPU from the same
    parameters, with dyadic features and slice vectors so both rank the
    entries identically.  Gradients agree to 1e-4 of each parameter's
    largest gradient (summation orders and trig only)."""
    import fsw_gnn_tpu_torch as T
    rng = np.random.default_rng(0)
    n = 200
    src, dst = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    keep = src != dst
    pairs = np.unique(src[keep] * n + dst[keep])
    ei = np.stack([pairs // n, pairs % n])
    mt = T.to_multi_table(T.from_edge_index(ei, n))
    cpu = T.FSWConv(16, 16, mlp_layers=3, minimize_slice_coherence=False,
                    device='cpu')
    X = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    with torch.no_grad():
        X, Vq = dyadic(X[None], cpu.fsw_embed.proj_vecs.t())
        X = X[0]
        cpu.fsw_embed.proj_vecs.copy_(Vq.t())
    gpu = copy.deepcopy(cpu).to(cuda_device)
    grads = []
    for model, dev in ((cpu, 'cpu'), (gpu, cuda_device)):
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        out = model(X.to(dev), mt.to(dev))
        (out * out).sum().backward()
        grads.append({k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()})
        opt.step()
    for k, want in grads[0].items():
        torch.testing.assert_close(grads[1][k], want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item(),
                                   msg=k)
    for (k, a), b in zip(cpu.named_parameters(), gpu.parameters()):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-5,
                                   atol=1e-6, msg=k)
