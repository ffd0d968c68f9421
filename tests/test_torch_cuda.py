"""The port's CUDA kernels against their plain PyTorch versions on the
card.  They skip where there is no card.  This file imports no JAX, so on
the GPU machine it runs on its own:

    python -m pytest tests/test_torch_cuda.py -o addopts= --noconftest -m cuda
"""
import numpy as np
import pytest
import torch

from fsw_gnn_tpu_torch.ops.fsw_rank import (fsw_rank_aggregate_proj,
                                            fsw_rank_aggregate_proj_plain)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import,
    so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is '
                    'False')
    return torch.device('cuda')


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
    got = fsw_rank_aggregate_proj(*args, uniform_w=uniform_w)
    torch.cuda.synchronize()
    assert fsw_rank_aggregate_proj.launches == before + 1
    want = fsw_rank_aggregate_proj_plain(*args, uniform_w=uniform_w)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=2e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_rank_kernel_refuses_grad_and_bad_inputs(cuda_device):
    args = [torch.zeros(s, device=cuda_device) for s in
            [(2, 8, 3), (2, 8), (2,), (4,), (3, 4)]]
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match='K1b'):
        fsw_rank_aggregate_proj(*args)
    with torch.no_grad():
        assert fsw_rank_aggregate_proj(*args).shape == (2, 4)
    args[0] = args[0].detach().double()
    with pytest.raises(TypeError, match='float32'):
        fsw_rank_aggregate_proj(*args)
