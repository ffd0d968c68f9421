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
    fsw_rank_aggregate, fsw_rank_aggregate_bwd, fsw_rank_aggregate_bwd_plain,
    fsw_rank_aggregate_plain, fsw_rank_aggregate_proj,
    fsw_rank_aggregate_proj_bwd, fsw_rank_aggregate_proj_bwd_plain,
    fsw_rank_aggregate_proj_plain)

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
    Z[:, 1::4, :] = Z[:, 0:B - 1:4, :]
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


# K1's shapes: the served and bench classes (D = 64, S = 127), wide rows,
# the Trainer's layer 0 on Cora (D = 1433, S = 2865) and Citeseer's width
# (D = 3703, S = 7405), and a ragged small one
K1_SHAPES = [(8, 64, 127), (16, 64, 127), (24, 64, 127), (32, 64, 127),
             (64, 64, 127), (256, 256, 200), (8, 1433, 2865),
             (16, 1433, 2865), (8, 3703, 7405), (48, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,D,S', K1_SHAPES)
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
        got = fsw_rank_aggregate_proj(*args, uniform_w=uniform_w,
                                      with_dw=False)
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
@pytest.mark.parametrize('B,D,S', [(8, 64, 127), (24, 64, 127),
                                   (48, 64, 127), (256, 256, 200),
                                   (8, 1433, 2865), (16, 1433, 2865),
                                   (8, 3703, 7405), (48, 5, 7)])
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
@pytest.mark.parametrize('B,D,S', K1_SHAPES)
def test_rank_proj_kernels_project_alike(cuda_device, B, D, S):
    """K1b's recomputed projections (its step 1) equal K1f's, which K1f's
    own kernel writes out instead of ranking, bit for bit, and two calls
    give the same bits: the backward ranks exactly as the forward did.
    Against the float64 product each is within 1e-5 of sum_d |z_d v_d|
    (3xTF32 with the chunked sums: tests/test_torch_tf32.py emulates it at
    about 1e-7 of that scale; the bound leaves room for the tensor cores'
    truncating additions, 12 a chunk of 32 features)."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_proj_projections
    rng = np.random.default_rng(B + D)
    Z, _, _, _, V = _args(rng, 37, B, D, S, False)
    Zd, Vd = Z.to(cuda_device), V.to(cuda_device)
    fwd = fsw_rank_proj_projections(Zd, Vd, 'fsw_rank_fwdp')
    bwd = fsw_rank_proj_projections(Zd, Vd, 'fsw_rank_bwdp')
    again = fsw_rank_proj_projections(Zd, Vd, 'fsw_rank_fwdp')
    torch.cuda.synchronize()
    assert torch.equal(fwd, bwd)
    assert torch.equal(fwd, again)
    Z64, V64 = Z.double().reshape(-1, D), V.double()
    want = Z64 @ V64
    scale = Z64.abs() @ V64.abs()
    err = (fwd.cpu().double() - want).abs()
    assert bool(torch.all(err <= 1e-5 * scale)), float((err / scale).max())


@pytest.mark.cuda
def test_smem_need_matches_every_library(cuda_device):
    """`smem_bytes`, which the routing and `_fits` use without loading a
    library, equals each rank kernel library's own `*_smem_bytes` export
    on a grid of widths, frequency counts and flags."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    for B in (1, 7, 8, 9, 24, 25, 32, 33, 63, 64, 100, 128, 443, 444, 446,
              447, 448, 449, 691, 692, 705, 706, 752, 753, 893, 894, 1024,
              1753, 1754, 1755, 1760, 1761):
        for dw in (False, True):
            for unif in (False, True):
                for F in (1, 8, 111, 130):
                    got = {name: R.smem_bytes(name, B, F, dw, unif)
                           for name in R.RANK_KERNELS}
                    lib = {n: R._kernel(n)[1]['smem_bytes']
                           for n in R.RANK_KERNELS}
                    want = {
                        'fsw_rank_fwdp': lib['fsw_rank_fwdp'](B),
                        'fsw_rank_bwdp': lib['fsw_rank_bwdp'](B, int(dw)),
                        'fsw_rank_fwd': lib['fsw_rank_fwd'](B),
                        'fsw_rank_bwd': lib['fsw_rank_bwd'](B, int(dw)),
                        'fsw_rank_cart_fwd': lib['fsw_rank_cart_fwd'](B, F),
                        'fsw_rank_cart_bwd': lib['fsw_rank_cart_bwd'](
                            B, F, int(dw), int(unif))}
                    assert got == want, (B, F, dw, unif)


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


def _args2(rng, R, B, S, uniform_w, dev, heavy_ties=False):
    """K2's float32 inputs on the card: projections P (R, B, S) with ties
    (every fourth entry repeats the one before it; with heavy_ties every
    projection is one of five values, zero among them), the rest as
    `_args`."""
    Z, wn, pad, freqs, _ = _args(rng, R, B, 1, S, uniform_w)
    P = rng.standard_normal((R, B, S)).astype(np.float32)
    P[:, 1::4] = P[:, 0:B - 1:4]
    if heavy_ties:
        P = (rng.integers(-2, 3, (R, B, S)) * 0.5).astype(np.float32)
    return [a.to(dev).contiguous() for a in
            (torch.from_numpy(P), wn, pad, freqs)]


def _first_misfit(name, F, with_dw):
    """The narrowest width that kernel `name` cannot hold."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import _MAX_SMEM, smem_bytes
    B = 1
    while smem_bytes(name, B, F, with_dw) <= _MAX_SMEM:
        B += 1
    return B


@pytest.mark.cuda
@pytest.mark.parametrize('B,S', [(8, 127), (100, 1000), (128, 200),
                                 (13, 7), (300, 65)])
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank2_kernel_matches_plain(cuda_device, B, S, uniform_w):
    """K2f against its plain version: |kernel - plain| <= 2e-5 *
    max|plain| + 1e-5 * |plain|.  P is given, so the ranks agree to the
    bit; the trig differs (sincospi against sin/cos of the wrapped
    phase)."""
    args = _args2(np.random.default_rng(B), 37, B, S, uniform_w,
                  cuda_device)
    before = fsw_rank_aggregate.launches
    with torch.no_grad():
        got = fsw_rank_aggregate(*args, uniform_w=uniform_w, with_dw=False)
    torch.cuda.synchronize()
    assert fsw_rank_aggregate.launches == before + 1
    want = fsw_rank_aggregate_plain(*args, uniform_w=uniform_w)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=2e-5 * want.abs().max().item())


# K2b's and K4b's shapes beyond K2f's: the widths where the entry kernel's
# threads a slice change (with with_dw 1 up to B = 8, 2, 3, then 4 from
# B = 25; without, 1 up to B = 32, then 4), and the widest K2b held with
# weight gradients before its redesign
BWD2_SHAPES = [(8, 127), (9, 64), (17, 33), (25, 40), (33, 50), (100, 1000),
               (128, 200), (13, 7), (300, 65), (443, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,S', BWD2_SHAPES)
@pytest.mark.parametrize('with_dw', [False, True])
@pytest.mark.parametrize('heavy_ties', [False, True])
def test_rank2_bwd_kernel_matches_plain(cuda_device, B, S, with_dw,
                                        heavy_ties):
    """K2b against its plain version, each output within 1e-4 of its
    largest plain entry + 1e-4 * |plain| (the trig, and the summation
    orders of df over R and of dwn over S and, in the kernel, over each
    slice's sorted order); zero-weight entries get exactly 0; two calls
    give the same bits."""
    rng = np.random.default_rng(2000 + B)
    for uniform_w in (False, True):
        args = _args2(rng, 37, B, S, uniform_w, cuda_device, heavy_ties)
        G = torch.from_numpy(rng.standard_normal((37, S)).astype(
            np.float32)).to(cuda_device)
        before = fsw_rank_aggregate_bwd.launches
        got = fsw_rank_aggregate_bwd(*args, G, uniform_w=uniform_w,
                                     with_dw=with_dw)
        torch.cuda.synchronize()
        assert fsw_rank_aggregate_bwd.launches == before + 1
        want = fsw_rank_aggregate_bwd_plain(*args, G, uniform_w=uniform_w,
                                            with_dw=with_dw)
        for g, w, name in zip(got, want, ('dP', 'dwn', 'dpad', 'df')):
            if w is None:
                assert g is None and not with_dw
                continue
            assert torch.isfinite(g).all(), name
            torch.testing.assert_close(g, w, rtol=1e-4,
                                       atol=1e-4 * w.abs().max().item(),
                                       msg=name)
        assert torch.all(got[0][args[1] == 0] == 0)
        again = fsw_rank_aggregate_bwd(*args, G, uniform_w=uniform_w,
                                       with_dw=with_dw)
        for a, b in zip(got, again):
            assert a is None or torch.equal(a, b)


@pytest.mark.cuda
def test_rank2_autograd_and_width_limits(cuda_device):
    """The custom ops run K2f and K2b on the card and its
    gradients equal the plain backward's; a width whose row does not fit
    in a block's shared memory raises a ValueError naming it, for all
    four kernels, before anything is launched."""
    rng = np.random.default_rng(7)
    args = _args2(rng, 11, 24, 40, False, cuda_device)
    G = torch.from_numpy(rng.standard_normal((11, 40)).astype(
        np.float32)).to(cuda_device)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (fsw_rank_aggregate.launches, fsw_rank_aggregate_bwd.launches)
    (fsw_rank_aggregate(*leaves) * G).sum().backward()
    torch.cuda.synchronize()
    assert (fsw_rank_aggregate.launches,
            fsw_rank_aggregate_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    want = fsw_rank_aggregate_bwd_plain(*args, G, with_dw=True)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())

    # with_dw: K2b holds B up to 705 (443 before its redesign)
    Bw = _first_misfit('fsw_rank_bwd', 1, True)
    assert Bw > 444
    wide = _args2(rng, 2, Bw, 8, False, cuda_device)
    Gw = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match=f'bucket width {Bw}'):
        fsw_rank_aggregate_bwd(*wide, Gw, with_dw=True)
    with pytest.raises(ValueError, match=f'bucket width {Bw}'):
        fsw_rank_aggregate(*[a.requires_grad_(True) for a in wide])
    assert fsw_rank_aggregate_bwd(*wide, Gw, with_dw=False)[0].shape == (
        2, Bw, 8)
    huge = _args2(rng, 1, 4096, 8, False, cuda_device)
    with pytest.raises(ValueError, match='bucket width 4096'):
        fsw_rank_aggregate(*huge)
    Z, wn, pad, freqs, V = [a.to(cuda_device) for a in
                            _args(rng, 2, 1024, 64, 8, False)]
    with pytest.raises(ValueError, match='bucket width 1024'):
        fsw_rank_aggregate_proj(Z, wn, pad, freqs, V)
    # without with_dw K1b holds B up to 1754 (893 before its entry
    # kernel's redesign)
    Bp = _first_misfit('fsw_rank_bwdp', 1, False)
    assert Bp > 1024
    Z, wn, pad, freqs, V = [a.to(cuda_device) for a in
                            _args(rng, 2, Bp, 64, 8, False)]
    with pytest.raises(ValueError, match=f'bucket width {Bp}'):
        fsw_rank_aggregate_proj_bwd(Z, wn, pad, freqs, V,
                                    torch.zeros((2, 8), device=cuda_device),
                                    with_dw=False)


# ---- K3: the segmented cumsum ------------------------------------------------

def _segments(rng, n, avg):
    """Sorted int32 segment ids of average length `avg` (1: singletons),
    with empty ids skipped, as a CSR graph's recipients give them."""
    if avg == 1:
        return np.arange(n, dtype=np.int32)
    return np.sort(rng.integers(0, max(n // avg, 1), n)).astype(np.int32)


def _k3_close(got, values, ids, reverse=False):
    """Per element |kernel - plain| <= 8 eps (the segment's prefix of
    |v|, its suffix in reverse): both restart at every segment, so each
    error is a few roundings of partial sums no larger than that prefix.
    values (n,) or (rows, n) over the ids (n,)."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum_rows_plain,
                                                 segment_boundaries)
    mask = segment_boundaries(ids)
    v = values.reshape(-1, values.shape[-1])
    want = segcumsum_rows_plain(v, mask, reverse=reverse)
    prefix = segcumsum_rows_plain(v.abs().double(), mask, reverse=reverse)
    eps = torch.finfo(values.dtype).eps
    err = (got.reshape(v.shape).double() - want.double()).abs()
    assert bool(torch.all(err <= 8 * eps * prefix)), float(
        (err / prefix.clamp(min=1e-300)).max())


def _k3_calls(v, ids, reverse):
    """K3 on v (rows, n) three times: with the ids, again, and with the
    mask; forward through the public wrappers, reverse through the
    launcher the backward uses."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (_run, segcumsum,
                                                 segcumsum_rows,
                                                 segment_boundaries)
    mask = segment_boundaries(ids)
    if reverse:
        return [_run(v, ids, None, True), _run(v, ids, None, True),
                _run(v, None, mask, True)]
    if v.shape[0] == 1:
        return [segcumsum(v[0], ids)[None], segcumsum(v[0], ids)[None],
                segcumsum(v[0], boundaries=mask)[None]]
    return [_run(v, ids, None, False), _run(v, ids, None, False),
            segcumsum_rows(v, mask)]


def _k3_check(v, ids, reverse):
    """The same bits twice and by ids and by mask, one launch a call,
    within 8 eps x prefix of the plain version, and bit for bit the numpy
    emulation of the kernel's order (its first two rows, at small n)."""
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    from test_torch_segcumsum_order import _bits, emulate
    before = segcumsum.launches
    got, again, by_mask = _k3_calls(v, ids, reverse)
    torch.cuda.synchronize()
    assert segcumsum.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, by_mask)
    _k3_close(got, v, ids, reverse)
    if v.shape[1] <= 1 << 20:
        want = emulate(v[:2].cpu().numpy(), ids=ids.cpu().numpy(),
                       reverse=reverse)
        assert np.array_equal(_bits(got[:2].cpu().numpy()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize('n,avg', [(1, 1), (1000, 27), (2048, 2048),
                                   (2049, 7), (4096, 4096), (4097, 4097),
                                   (70000, 14000), (4096, 1), (65536, 65536),
                                   (1 << 20, 32), (1 << 20, 4096),
                                   (1 << 20, 1 << 20)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('reverse', [False, True])
def test_segcumsum_kernel_matches_plain(cuda_device, n, avg, dtype,
                                        reverse):
    """K3 with the ids and with the mask against the plain version, forward
    and reverse, across tile edges (a tile is 4096 elements: n = 1, a tile
    and one more), singletons, and one segment over every tile (avg = n,
    the longest look-back); the kernel gives the same bits twice, by ids
    and by mask, the emulation's bits, and counts one launch a call."""
    rng = np.random.default_rng(n + avg)
    ids = torch.from_numpy(_segments(rng, n, avg)).to(cuda_device)
    v = torch.from_numpy(rng.standard_normal((1, n))).to(cuda_device, dtype)
    _k3_check(v, ids, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize('rows,m', [(127, 130944), (5, 4097), (3, 130943),
                                    (2, 1), (9, 333), (4, 12288)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('reverse', [False, True])
def test_segcumsum_rows_kernel_matches_plain(cuda_device, rows, m, dtype,
                                             reverse):
    """The row form over one shared mask: the CSR path's shape (127 slices
    of the bench graph's 130944 padded edges, segments of about 16) and
    ragged row lengths, whose rows start off 16-byte alignment (the
    element-by-element loads)."""
    rng = np.random.default_rng(rows * m)
    ids = torch.from_numpy(_segments(rng, m, 16)).to(cuda_device)
    v = torch.from_numpy(rng.standard_normal((rows, m))).to(cuda_device,
                                                            dtype)
    _k3_check(v, ids, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_segcumsum_rows_backward_is_one_reverse_launch(cuda_device, dtype):
    """The row form's gradient: one launch of the reverse scan on the
    cotangent as it lies, the same bits as a direct reverse call."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (_run, segcumsum,
                                                 segcumsum_rows,
                                                 segment_boundaries)
    rng = np.random.default_rng(7)
    rows, m = 9, 30000
    ids = torch.from_numpy(_segments(rng, m, 300)).to(cuda_device)
    mask = segment_boundaries(ids)
    g = torch.from_numpy(rng.standard_normal((rows, m))).to(cuda_device,
                                                            dtype)
    v = torch.from_numpy(rng.standard_normal((rows, m))).to(
        cuda_device, dtype).requires_grad_(True)
    before = segcumsum.launches
    (segcumsum_rows(v, mask) * g).sum().backward()
    torch.cuda.synchronize()
    assert segcumsum.launches == before + 2
    assert torch.equal(v.grad, _run(g, None, mask, True))
    _k3_close(v.grad, g, ids, reverse=True)


@pytest.mark.cuda
def test_segcumsum_kernel_backward_and_refusals(cuda_device):
    """The backward is the reversed segmented cumsum of the cotangent, by
    the kernel (one more launch), with ids and with the mask; what the
    kernel does not take raises."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_plain,
                                                 segment_boundaries)
    rng = np.random.default_rng(3)
    n = 50000
    ids = torch.from_numpy(_segments(rng, n, 300)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal(n)).to(cuda_device)
    for kw in (dict(segment_ids=ids),
               dict(boundaries=segment_boundaries(ids))):
        v = torch.from_numpy(rng.standard_normal(n)).to(
            cuda_device).requires_grad_(True)
        before = segcumsum.launches
        (segcumsum(v, **kw) * g).sum().backward()
        assert segcumsum.launches == before + 2
        want = segcumsum_plain(g.flip(0), -ids.flip(0)).flip(0)
        torch.testing.assert_close(v.grad, want, rtol=1e-12, atol=1e-9)
    with pytest.raises(TypeError, match='float32 or float64'):
        segcumsum(torch.ones(4, device=cuda_device, dtype=torch.float16),
                  ids[:4])
    with pytest.raises(ValueError, match='contiguous'):
        segcumsum(torch.ones(8, device=cuda_device)[::2], ids[:4])
    with pytest.raises(ValueError, match='exactly one'):
        segcumsum(torch.ones(4, device=cuda_device))


@pytest.mark.cuda
def test_csr_fswconv_matches_cpu(cuda_device):
    """FSWConv on a CSR Graph on the card (K3 once a forward) against the
    CPU, forward and gradients, including the gradient of the edge
    weights (K3 again in the backward).  Every in-degree is 4 and the
    features and slice vectors are dyadic, so every projection and every
    cumulative weight is exact in any order and both sides sort alike."""
    import fsw_gnn_tpu_torch as T
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    rng = np.random.default_rng(1)
    n = 300
    src = np.concatenate([rng.choice(np.delete(np.arange(n), v), 4,
                                     replace=False) for v in range(n)])
    ei = np.stack([src, np.repeat(np.arange(n), 4)])
    g = T.from_edge_index(ei, n)
    cpu = T.FSWConv(16, 16, mlp_layers=3, minimize_slice_coherence=False,
                    device='cpu')
    X = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    with torch.no_grad():
        X, Vq = dyadic(X[None], cpu.fsw_embed.proj_vecs.t())
        X = X[0]
        cpu.fsw_embed.proj_vecs.copy_(Vq.t())
    gpu = copy.deepcopy(cpu).to(cuda_device)
    res = []
    for model, dev in ((cpu, 'cpu'), (gpu, cuda_device)):
        gd = g.to(dev)
        gd.weight = gd.weight.clone().requires_grad_(True)
        before = segcumsum.launches
        out = model(X.to(dev), gd)
        (out * out).sum().backward()
        if dev != 'cpu':
            assert segcumsum.launches == before + 2
        res.append([out.detach().cpu(), gd.weight.grad.cpu()] + [
            p.grad.detach().cpu() for p in model.parameters()])
    for got, want in zip(res[1], res[0]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


# ---- K4: the cartesian rank aggregation --------------------------------------

def _args4(rng, R, B, S, F, uniform_w, dev, heavy_ties=False):
    """K4's float32 inputs on the card: K2's (`_args2`) with an (S, F)
    frequency matrix whose rows differ, an f = 0 column and one
    'spread'-range frequency."""
    P, wn, pad, _ = _args2(rng, R, B, S, uniform_w, dev, heavy_ties)
    freqs = np.abs(rng.standard_normal((S, F))) + 0.1
    freqs[:, 1 % F] = 0.0
    freqs[-1, -1] = 2.0 * S - 1.0
    return [P, wn, pad, torch.from_numpy(freqs.astype(np.float32)).to(dev)]


CART_SHAPES = [(8, 127, 8), (32, 128, 8), (100, 130, 3), (128, 200, 8),
               (13, 7, 1), (300, 65, 5), (100, 130, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,S,F', CART_SHAPES)
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank_cart_kernel_matches_plain(cuda_device, B, S, F, uniform_w):
    """K4f against its plain version: |kernel - plain| <= 2e-5 *
    max|plain| + 1e-5 * |plain| (as K2f: the ranks agree to the bit, the
    trig differs)."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_cart, fsw_rank_aggregate_cart_plain)
    args = _args4(np.random.default_rng(B + F), 37, B, S, F, uniform_w,
                  cuda_device)
    before = fsw_rank_aggregate_cart.launches
    with torch.no_grad():
        got = fsw_rank_aggregate_cart(*args, uniform_w=uniform_w,
                                      with_dw=False)
    torch.cuda.synchronize()
    assert fsw_rank_aggregate_cart.launches == before + 1
    assert got.shape == (37, S, F)
    want = fsw_rank_aggregate_cart_plain(*args, uniform_w=uniform_w)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=2e-5 * want.abs().max().item())


def _compacted(P, wn):
    """(P', wn') of the same width: each row's entries of nonzero weight
    moved to the front in their order, its zero-weight entries after them
    (the width, and so the kernel's block shape, stays)."""
    keep = wn != 0
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    Pc = torch.gather(P, 1, order[:, :, None].expand(-1, -1, P.shape[2]))
    return Pc.contiguous(), torch.gather(wn, 1, order).contiguous()


# K2f (F = 1), and K4f at its F = 8 instance (ranks in registers) and at
# other F (the shared rank column), narrow and wide
SKIP_SHAPES = [(8, 127, 1), (32, 64, 1), (33, 64, 1), (100, 130, 1),
               (8, 127, 8), (32, 128, 8), (33, 40, 8), (100, 130, 8),
               (128, 70, 8), (9, 40, 3), (100, 65, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,S,F', SKIP_SHAPES)
@pytest.mark.parametrize('uniform_w', [False, True])
def test_rank_fwd_kernels_skip_padding(cuda_device, B, S, F, uniform_w):
    """K2f and K4f rank and sum a row's entries of nonzero weight only, in
    their order: on (P, wn) with zero weights at random positions and one
    row all zero they give the bits of the same kernel on the row-compacted
    (P', wn'), also where the padded projections are NaN or inf (which now
    contribute exactly 0); the all-zero row gives exactly 0; two calls give
    the same bits; and the outputs agree with the plain version (2e-5 of
    the output scale + 1e-5 relative, as K2f's test)."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_cart, fsw_rank_aggregate_cart_plain)
    rng = np.random.default_rng(4000 + B + F)
    P, wn, pad, freqs = _args4(rng, 37, B, S, F, uniform_w, cuda_device,
                               heavy_ties=B % 2 == 0)
    wn[3] = 0.0
    if F == 1:
        freqs = freqs[:, 0].contiguous()
        kernel, plain = fsw_rank_aggregate, fsw_rank_aggregate_plain
    else:
        kernel, plain = fsw_rank_aggregate_cart, fsw_rank_aggregate_cart_plain

    def run(p, w):
        with torch.no_grad():
            return kernel(p, w, pad, freqs, uniform_w=uniform_w,
                          with_dw=False)
    got = run(P, wn)
    want = run(*_compacted(P, wn))
    Pn = P.clone()
    dead = (wn == 0)[:, :, None].expand_as(P)
    Pn[dead] = float('nan')
    Pn[:, ::3][dead[:, ::3]] = float('inf')
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(run(Pn, wn), want)
    assert torch.equal(run(P, wn), got)
    assert torch.all(got[3] == 0)
    ref = plain(P, wn, pad, freqs, uniform_w=uniform_w)
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=2e-5 * ref.abs().max().item())


# K4b's shapes beyond K4f's: the entry kernel's threads a slice change at
# B = 9, 17, 25 (with with_dw) and 33 (without) at the frequency counts with
# their own instance (8, 1), and the widest K4b held with weight gradients
# at 8 frequencies before its redesign
BWD4_SHAPES = CART_SHAPES + [(9, 64, 8), (17, 33, 1), (25, 40, 8),
                             (33, 40, 8), (443, 70, 8), (423, 40, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,S,F', BWD4_SHAPES)
@pytest.mark.parametrize('with_dw', [False, True])
@pytest.mark.parametrize('heavy_ties', [False, True])
def test_rank_cart_bwd_kernel_matches_plain(cuda_device, B, S, F, with_dw,
                                            heavy_ties):
    """K4b against its plain version, each output within 1e-4 of its
    largest plain entry + 1e-4 * |plain| (the trig, and the summation
    orders over the frequencies, of df over R and of dwn over S and, in
    the kernel, over each slice's sorted order); zero-weight entries get
    exactly dP = 0; two calls give the same bits."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_cart_bwd, fsw_rank_aggregate_cart_bwd_plain)
    rng = np.random.default_rng(3000 + B + F)
    for uniform_w in (False, True):
        args = _args4(rng, 37, B, S, F, uniform_w, cuda_device, heavy_ties)
        G = torch.from_numpy(rng.standard_normal((37, S, F)).astype(
            np.float32)).to(cuda_device)
        before = fsw_rank_aggregate_cart_bwd.launches
        got = fsw_rank_aggregate_cart_bwd(*args, G, uniform_w=uniform_w,
                                          with_dw=with_dw)
        torch.cuda.synchronize()
        assert fsw_rank_aggregate_cart_bwd.launches == before + 1
        want = fsw_rank_aggregate_cart_bwd_plain(
            *args, G, uniform_w=uniform_w, with_dw=with_dw)
        assert got[3].shape == (S, F)
        for g, w, name in zip(got, want, ('dP', 'dwn', 'dpad', 'df')):
            if w is None:
                assert g is None and not with_dw
                continue
            assert torch.isfinite(g).all(), name
            torch.testing.assert_close(g, w, rtol=1e-4,
                                       atol=1e-4 * w.abs().max().item(),
                                       msg=name)
        assert torch.all(got[0][args[1] == 0] == 0)
        again = fsw_rank_aggregate_cart_bwd(*args, G, uniform_w=uniform_w,
                                            with_dw=with_dw)
        for a, b in zip(got, again):
            assert a is None or torch.equal(a, b)


@pytest.mark.cuda
def test_rank_cart_autograd_and_width_limits(cuda_device):
    """The custom ops run K4f and K4b on the card and its
    gradients equal the plain backward's; a width whose row K4b cannot
    hold raises a ValueError naming it before anything is launched, also
    through an explicit aggregate='rank' of the embedding."""
    import fsw_gnn_tpu_torch as T
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_cart, fsw_rank_aggregate_cart_bwd,
        fsw_rank_aggregate_cart_bwd_plain)
    rng = np.random.default_rng(9)
    args = _args4(rng, 11, 24, 40, 8, False, cuda_device)
    G = torch.from_numpy(rng.standard_normal((11, 40, 8)).astype(
        np.float32)).to(cuda_device)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = (fsw_rank_aggregate_cart.launches,
              fsw_rank_aggregate_cart_bwd.launches)
    (fsw_rank_aggregate_cart(*leaves) * G).sum().backward()
    torch.cuda.synchronize()
    assert (fsw_rank_aggregate_cart.launches,
            fsw_rank_aggregate_cart_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = fsw_rank_aggregate_cart_bwd_plain(*args, G, with_dw=True)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())

    # with_dw at 8 frequencies: K4b holds B up to 691 (423 before its
    # redesign)
    Bw = _first_misfit('fsw_rank_cart_bwd', 8, True)
    assert Bw > 424
    wide = _args4(rng, 2, Bw, 8, 8, False, cuda_device)
    Gw = torch.zeros((2, 8, 8), device=cuda_device)
    before = (fsw_rank_aggregate_cart.launches,
              fsw_rank_aggregate_cart_bwd.launches)
    with pytest.raises(ValueError, match=f'bucket width {Bw}'):
        fsw_rank_aggregate_cart_bwd(*wide, Gw, with_dw=True)
    with pytest.raises(ValueError, match=f'bucket width {Bw}'):
        fsw_rank_aggregate_cart(*[a.requires_grad_(True) for a in wide])
    cfg = T.FSWConfig(d_in=3, n_slices=8, n_freqs=8)
    emb = T.FSWEmbedding(cfg, device=cuda_device)
    X = torch.randn((2, Bw, 3), device=cuda_device)
    W = torch.rand((2, Bw), device=cuda_device).requires_grad_(True)
    with pytest.raises(ValueError, match=f'bucket width {Bw}'):
        emb(X, W, aggregate='rank')
    assert (fsw_rank_aggregate_cart.launches,
            fsw_rank_aggregate_cart_bwd.launches) == before
    assert fsw_rank_aggregate_cart_bwd(
        *[a.detach() for a in wide], Gw, with_dw=False)[0].shape == (
            2, Bw, 8)
    huge = _args4(rng, 1, 4096, 8, 8, False, cuda_device)
    with pytest.raises(ValueError, match='bucket width 4096'):
        fsw_rank_aggregate_cart(*huge)


# ---- the kernels as custom ops, CUDA graphs, the server's graphs, export ------

@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K2f', 'K2f uniform', 'K2b dw', 'K2b',
                                  'K1f', 'K1b dw', 'K1b', 'K4f', 'K4b dw',
                                  'K4b uniform', 'K3 ids',
                                  'K3 mask reverse', 'K3 rows',
                                  'K3 rows reverse'])
def test_custom_ops_opcheck_on_the_card(cuda_device, case):
    """`torch.library.opcheck` of every op with its CUDA kernel (the cases
    of test_torch_library_ops.py)."""
    from test_torch_library_ops import op_cases
    op, args = op_cases(cuda_device)[case]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
def test_segcumsum_replays_in_graphs(cuda_device):
    """K3 captured in two graphs on one stream (one workspace): the flat
    scan and the row form's reverse, each replayed in turn on two inputs;
    every replay gives the eager call's bits, and the captures count no
    launch."""
    from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_rows,
                                                 segment_boundaries)
    rng = np.random.default_rng(5)
    n, rows, m = 300000, 9, 40000
    mask = segment_boundaries(torch.from_numpy(
        _segments(rng, n, 32)).to(cuda_device))
    rmask = segment_boundaries(torch.from_numpy(
        _segments(rng, m, 16)).to(cuda_device))
    flat = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            .to(cuda_device) for _ in range(2)]
    rws = [torch.from_numpy(rng.standard_normal((rows, m)))
           .to(cuda_device) for _ in range(2)]
    from fsw_gnn_tpu_torch.ops.segcumsum import _run
    want_f = [segcumsum(v, boundaries=mask) for v in flat]
    want_r = [_run(v, None, rmask, True) for v in rws]
    sf, sr = flat[0].clone(), rws[0].clone()
    s = torch.cuda.Stream(cuda_device)
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        segcumsum(sf, boundaries=mask)
        _run(sr, None, rmask, True)
    torch.cuda.current_stream().wait_stream(s)
    g1, g2 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    before = segcumsum.launches
    with torch.cuda.graph(g1, stream=s):
        o1 = segcumsum(sf, boundaries=mask)
    with torch.cuda.graph(g2, stream=s):
        o2 = _run(sr, None, rmask, True)
    assert segcumsum.launches == before
    for _ in range(3):
        for i in (1, 0):
            sf.copy_(flat[i])
            g1.replay()
            sr.copy_(rws[i])
            g2.replay()
            assert torch.equal(o1, want_f[i]) and torch.equal(o2, want_r[i])
    # and eager calls on the default stream after the replays
    assert torch.equal(segcumsum(flat[1], boundaries=mask), want_f[1])
    assert torch.equal(segcumsum_rows(rws[0], rmask),
                       _run(rws[0], None, rmask, False))


def _small_server_pair(cuda_device, dtype=torch.float32):
    import fsw_gnn_tpu_torch as T
    rng = np.random.default_rng(9)
    n = 200
    A = rng.random((n, n)) < 0.05
    np.fill_diagonal(A, False)
    ei = np.stack(np.nonzero(A))
    model = T.FSWConv(8, 8, mlp_layers=3, minimize_slice_coherence=False,
                      device=cuda_device)
    classes, rows = T.multi_envelope(T.from_edge_index(ei, n), 256)
    kw = dict(classes=classes, class_rows=rows, dtype=dtype,
              device=cuda_device)
    eager = T.GraphServer(model, 256, 4096, cuda_graphs=False, **kw)
    graph = T.GraphServer(model, 256, 4096, **kw)
    reqs = []
    for seed, k in ((1, 200), (2, 131), (3, 256)):
        r = np.random.default_rng(seed)
        B = r.random((k, k)) < 0.05
        np.fill_diagonal(B, False)
        reqs.append((np.stack(np.nonzero(B)),
                     r.standard_normal((k, 8)).astype(np.float32)))
    star = np.stack([np.arange(1, 100), np.zeros(99, np.int64)])
    reqs.append((star, np.ones((100, 8), np.float32)))
    return eager, graph, reqs


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_graph_server_matches_eager_server(cuda_device, dtype):
    """The server's two routes through their CUDA graphs against the same
    server eagerly: the same outputs (within 1e-4 of the output's scale;
    the kernels and products are the same), warmup 2 graphs and none more
    after requests on both routes, predict_many's window of copies."""
    eager, graph, reqs = _small_server_pair(cuda_device, dtype)
    assert graph.warmup(8) == 2 and eager.warmup(8) == 2
    assert graph.warmup(8) == 0
    want = [eager.predict(*r) for r in reqs]
    got = [graph.predict(*r) for r in reqs]
    many = graph.predict_many(reqs, window=2)
    assert graph.num_compiles() == 2 and eager.fallbacks >= 1
    assert graph.fallbacks == 2 * eager.fallbacks   # the star, at least
    for g, m, w in zip(got, many, want):
        assert np.array_equal(g, m)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.cuda
def test_export_on_the_card(cuda_device):
    """export_forward for the card on a MultiTable and a CSR Graph; the
    loaded artifact's output against the module's."""
    import fsw_gnn_tpu_torch as T
    eager, _, reqs = _small_server_pair(cuda_device)
    ei, X = reqs[0]
    Xd = torch.from_numpy(X).to(cuda_device)
    g = T.from_edge_index(ei, X.shape[0])
    for graph in (T.to_multi_table(g), g):
        blob = T.export_forward(eager.model, Xd, graph, device=cuda_device)
        got = T.load_forward(blob)(Xd)
        with torch.no_grad():
            want = eager.model(Xd, graph.to(cuda_device))
        torch.testing.assert_close(got.detach(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_rank_rules_on_the_card_are_the_tables(cuda_device):
    """The H100's routing rules are the measured table (the card's kind
    matches it), whatever an autotune cache holds; the CPU's are the
    same."""
    from fsw_gnn_tpu_torch import embedding as E
    kind = torch.cuda.get_device_name(0).lower()
    if 'h100' not in kind:
        pytest.skip(f'not an H100: {kind}')
    assert E._rank_rules(cuda_device) is E._RANK_RULES_BY_KIND['h100']
    assert E._rank_rules('cpu') is E._RANK_RULES_BY_KIND['h100']


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['multi', 'csr'])
def test_checkify_embed_on_the_card(cuda_device, layout):
    """`checkify_embed` around FSWConv on the card (K1f on the `multi`
    layout, K3 on CSR): the unwrapped call's bits, and a node with two
    infinite features raises naming an op."""
    import fsw_gnn_tpu_torch as T
    from chip_smoke import simple_graph
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_aggregate_proj
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum
    from fsw_gnn_tpu_torch.utils import FloatCheckError, checkify_embed
    n = 512
    ei, rng = simple_graph(3, n, 8)
    g = T.from_edge_index(ei, n)
    graph = (T.to_multi_table(g) if layout == 'multi' else g).to(cuda_device)
    conv = T.FSWConv(16, 16, mlp_layers=2, minimize_slice_coherence=False,
                     device=cuda_device,
                     generator=torch.Generator().manual_seed(0))
    X = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)
                         ).to(cuda_device)
    counter = fsw_rank_aggregate_proj if layout == 'multi' else segcumsum
    before = counter.launches
    with torch.no_grad():
        got = checkify_embed(conv)(X, graph)
        assert counter.launches > before
        assert torch.equal(got, conv(X, graph))
        X[7, :2] = float('inf')
        with pytest.raises(FloatCheckError, match='NaN generated by'):
            checkify_embed(conv)(X, graph)


@pytest.mark.cuda
def test_measure_margins_on_the_card(cuda_device):
    """The autotune's cells at small shapes on the card: every rank route
    agrees with the other one and launches its kernels; every margin is
    finite and positive."""
    from fsw_gnn_tpu_torch.ops import fsw_rank as R
    from fsw_gnn_tpu_torch.utils import autotune as AT
    names = ('fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
             'fsw_rank_aggregate', 'fsw_rank_aggregate_bwd',
             'fsw_rank_aggregate_cart', 'fsw_rank_aggregate_cart_bwd')
    before = [getattr(R, k).launches for k in names]
    margins, transient, cells = AT._measure_margins(
        buckets=(16,), entries=2048, s=32, cart_buckets=(16,), k1_ds=(64,),
        k1_rhos=(0.5,), k1_nodes=512, steps=1, calls=1, device=cuda_device)
    assert transient == []
    assert all(getattr(R, k).launches > b for k, b in zip(names, before))
    for mode, by in margins.items():
        assert by and all(np.isfinite(m) and m > 0 for m in by.values())


# ---- the benchmark folder's kernels: A1, P1, P4, P6 -------------------------

def _table_inputs(rng, R, B, S):
    """A1's inputs: ties (every fourth projection repeats the one before),
    zero-weight padding, a phantom mass on the light rows."""
    P = rng.standard_normal((R, B, S))
    P[:, 1::4] = P[:, 0:B - 1:4]
    w = np.abs(rng.standard_normal((R, B))) * (rng.random((R, B)) < 0.8)
    w[::2] *= 0.05
    w_sum = w.sum(1)
    wsp = np.maximum(w_sum, 1.0)
    freqs = np.abs(rng.standard_normal(S)) + 0.1
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in
            (P, w / wsp[:, None], np.maximum(1.0 - w_sum, 0.0) / wsp, freqs)]


@pytest.mark.cuda
@pytest.mark.parametrize('B', [8, 16, 32, 64, 128, 256, 512, 1024])
def test_table_sort_kernel_matches_plain(cuda_device, B):
    """A1 against its plain version on the card, S = 129 (a ragged slice
    tile): |kernel - plain| <= 2e-5 * max|plain| + 1e-5 * |plain| (the same
    network, so the same pairs; the cumsum and the trig round apart)."""
    from fsw_gnn_tpu_torch.benchmarks.attic.fsw_table import (
        fsw_table_sort, fsw_table_sort_plain)
    args = [a.to(cuda_device) for a in
            _table_inputs(np.random.default_rng(B), max(4096 // B, 3), B,
                          129)]
    before = fsw_table_sort.launches
    got = fsw_table_sort(*args)
    torch.cuda.synchronize()
    assert fsw_table_sort.launches == before + 1
    want = fsw_table_sort_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=2e-5 * want.abs().max().item())
    assert torch.equal(fsw_table_sort(*args), got)      # fixed sum orders


@pytest.mark.cuda
def test_table_sort_refuses_widths_before_any_launch(cuda_device):
    from fsw_gnn_tpu_torch.benchmarks.attic.fsw_table import fsw_table_sort
    from fsw_gnn_tpu_torch.kernels import KernelError
    before = fsw_table_sort.launches
    for B in (12, 2048):
        args = [a.to(cuda_device) for a in
                _table_inputs(np.random.default_rng(0), 2, B, 8)]
        with pytest.raises(KernelError):
            fsw_table_sort(*args)
    assert fsw_table_sort.launches == before


@pytest.mark.cuda
def test_bench_smem_need_matches_the_libraries(cuda_device):
    """A1's lanes a column (`table_sort_lanes`; A1 needs no shared memory)
    and the staged probe's shared-memory need equal their libraries' own
    exports, and so do P1's 'wgmma' partials (`wgmma_parts`)."""
    from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1
    from fsw_gnn_tpu_torch.benchmarks.probe_emit_pipeline import \
        stage_smem_bytes
    from fsw_gnn_tpu_torch.ops.fsw_rank import _kernel, table_sort_lanes
    lanes = _kernel('fsw_table_sort')[1]['lanes']
    stage = _kernel('probe_stage')[1]['smem_bytes']
    for B in (2, 8, 16, 32, 64, 100, 128, 256, 447, 512, 1024, 2048):
        assert lanes(B) == table_sort_lanes(B), B
        for S in (4, 36, 128, 132, 300):
            assert stage(B, S) == stage_smem_bytes(B, S), (B, S)
    parts = _kernel('probe_matmul')[1]['wgmma_parts']
    for shape in list(P1.SHAPES) + [('ragged', 301, 3, 1433, 127)]:
        for kind in P1.KINDS:
            assert parts(P1.KINDS_C[kind], *shape[1:]) == P1.wgmma_parts(
                kind, *shape[1:]), (shape, kind)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['probe', 'headline', 'cora_layer0',
                                   'ragged'])
def test_kernel_matmul_contractions_against_float64(cuda_device, shape):
    """P1's five contractions on K1's 3xTF32 tiles against float64: within
    1e-5 of each result's scale (3xTF32 keeps float32's accuracy)."""
    from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1
    shapes = dict((s[0], s) for s in P1.SHAPES)
    shapes['ragged'] = ('ragged', 37, 5, 70, 131)
    x = P1.operands(shapes[shape], cuda_device)
    before = P1.kernel_matmul.launches
    for kind in P1.KINDS:
        err, rel = P1.check(kind, x)
        assert rel <= P1.TOL_REL, (kind, err, rel)
    torch.cuda.synchronize()
    assert P1.kernel_matmul.launches == before + len(P1.KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize('routine', ['wgmma', 'k1'])
@pytest.mark.parametrize('shape', [('aligned', 64, 8, 128, 256),
                                   ('ragged', 301, 3, 1433, 127)])
def test_kernel_matmul_routines_against_float64_and_stable(cuda_device,
                                                           shape, routine):
    """Both tile routines at an aligned shape (TMA and 16-byte copies)
    and a ragged one (D = 1433, S = 127, M = 903 not a multiple of 128:
    4-byte copies, partial tiles): each contraction within TOL_REL of
    float64 and the same bits on two calls."""
    from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1
    x = P1.operands(shape, cuda_device)
    before = P1.kernel_matmul.launches
    for kind in P1.KINDS:
        err, rel = P1.check(kind, x, routine)
        assert rel <= P1.TOL_REL, (kind, err, rel)
        a, b = (x[n] for n in P1.SPEC[kind][0])
        assert torch.equal(P1.kernel_matmul(kind, a, b, routine),
                           P1.kernel_matmul(kind, a, b, routine)), kind
    torch.cuda.synchronize()
    assert P1.kernel_matmul.launches == before + 3 * len(P1.KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_table_gather_matches_plain_and_the_p_entry(cuda_device, B):
    """A1's gathered entry (`fsw_table_forward`: Xp[idx] read inside the
    kernel) against its plain version at S = 129, with tied sender rows
    (every fourth idx repeats the one before) and tied projections, and
    bit for bit the P entry on the same gathered values."""
    from fsw_gnn_tpu_torch.benchmarks.attic.fsw_table import (
        _gather, fsw_table_forward, fsw_table_forward_plain, fsw_table_sort)
    rng = np.random.default_rng(B + 1)
    R = max(4096 // B, 3)
    _, wn, pad, freqs = [a.to(cuda_device) for a in
                         _table_inputs(rng, R, B, 129)]
    Xp = rng.standard_normal((600, 129))
    Xp[1::3] = Xp[0:-1:3]
    Xp = torch.from_numpy(Xp.astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, 600, (R, B))
    idx[:, 1::4] = idx[:, 0:B - 1:4]
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    before = fsw_table_forward.launches
    got = fsw_table_forward(idx, wn, pad, Xp, freqs)
    torch.cuda.synchronize()
    assert fsw_table_forward.launches == before + 1
    want = fsw_table_forward_plain(idx, wn, pad, Xp, freqs)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=2e-5 * want.abs().max().item())
    assert torch.equal(got, fsw_table_sort(_gather(idx, Xp), wn, pad, freqs))
    assert torch.equal(fsw_table_forward(idx.long(), wn, pad, Xp, freqs),
                       got)


# P4's widths: today's four; B = W and W + 1 of the register loop; S not a
# multiple of its 128-slice tiles (the tensor map's ragged edge), alone and
# with weight rows not 16-byte aligned (B % 4 != 0: 4-byte copies); a tensor
# map over whole tiles; a block narrower than a warp's multiple
P4_SHAPES = [(32, 128), (13, 40), (100, 196), (8, 64), (33, 128), (32, 300),
             (13, 300), (30, 256), (31, 36), (1, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,S', P4_SHAPES)
@pytest.mark.parametrize('uniform_w', [False, True])
def test_staged_forward_is_k2f_bit_for_bit(cuda_device, B, S, uniform_w):
    """P4's staged kernel against K2f on the same inputs, padded entries
    holding NaN projections (both skip them): the same bits, on the loop
    and staging the library reports for the width (`stage_loop`)."""
    from fsw_gnn_tpu_torch.benchmarks.probe_emit_pipeline import (
        fsw_rank_aggregate_staged, stage_loop)
    rng = np.random.default_rng(B + S)
    args = [a.to(cuda_device) for a in _table_inputs(rng, 300, B, S)]
    if uniform_w:
        args[1] = torch.where(args[1] > 0, 1.0 / B, 0.0).contiguous()
    args[0] = torch.where(args[1][:, :, None] == 0, float('nan'),
                          args[0]).contiguous()
    loop = stage_loop(B, S)
    before = fsw_rank_aggregate_staged.launches
    on_loop = fsw_rank_aggregate_staged.loops.get(loop, 0)
    got = fsw_rank_aggregate_staged(*args, uniform_w=uniform_w)
    want = fsw_rank_aggregate(*args, uniform_w=uniform_w, with_dw=False)
    torch.cuda.synchronize()
    assert fsw_rank_aggregate_staged.launches == before + 1
    assert fsw_rank_aggregate_staged.loops[loop] == on_loop + 1
    assert loop.startswith('registers') == (B <= 32)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_staged_forward_walks_many_rows_per_block(cuda_device):
    """More rows than the card holds blocks (each block walks rows through
    its three-stage ring many times over, the barriers' phases wrapping):
    K2f's bits at the probe's width, both stagings."""
    from fsw_gnn_tpu_torch.benchmarks.probe_emit_pipeline import (
        fsw_rank_aggregate_staged)
    for S in (128, 260):
        args = [a.to(cuda_device) for a in
                _table_inputs(np.random.default_rng(S), 5003, 32, S)]
        got = fsw_rank_aggregate_staged(*args)
        assert torch.equal(got, fsw_rank_aggregate(*args, with_dw=False)), S


@pytest.mark.cuda
@pytest.mark.parametrize('B', [32, 40])
def test_select_bodies_match_plain(cuda_device, B):
    """P6's 21 bodies and its three pipe bodies against their plain
    versions on the card, at the probe's width (the loop bodies on the
    register loop) and at one above it (every body in shared memory):
    within 1e-5 of max |plain| (sinf/cosf and fused multiply-adds against
    PyTorch's kernels); each launch counted on the loop `loop_of` names."""
    from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6
    rng = np.random.default_rng(6)
    P = torch.from_numpy(rng.standard_normal((64, B, 130)).astype(
        np.float32)).to(cuda_device)
    wn = torch.from_numpy(rng.random((64, B)).astype(np.float32)).to(
        cuda_device)
    before = P6.probe_select.launches
    start = dict(P6.probe_select.loops)
    loops = dict(start)
    for name in P6.KERNEL_BODIES:
        got = P6.probe_select(name, P, wn, 2)
        want = P6.probe_select_plain(name, P, wn, 2)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item(),
                                   msg=name)
        loop = P6.loop_of(name, B)
        loops[loop] = loops.get(loop, 0) + 1
        assert P6.probe_select.loops == loops, name
    torch.cuda.synchronize()
    assert P6.probe_select.launches == before + len(P6.KERNEL_BODIES)
    on_registers = loops.get('registers', 0) - start.get('registers', 0)
    assert on_registers == (3 if B <= 32 else 0)


@pytest.mark.cuda
def test_probe_loops_match_the_libraries(cuda_device):
    """The libraries' own choice of loop (`probe_stage_loop`,
    `probe_select_loop`) against the scripts' mirrors, across widths."""
    from fsw_gnn_tpu_torch.benchmarks import probe_emit_pipeline as P4
    from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6
    from fsw_gnn_tpu_torch.ops.fsw_rank import _kernel
    stage = _kernel('probe_stage')[1]['loop']
    select = _kernel('probe_select')[1]['loop']
    for B in (1, 8, 13, 31, 32, 33, 64, 100):
        for S in (4, 128, 132, 1000):
            assert P4.LOOPS[stage(B, S)] == P4.stage_loop(B, S), (B, S)
        for i, name in enumerate(P6.KERNEL_BODIES):
            assert P6.LOOPS[select(i, B)] == P6.loop_of(name, B), (B, name)


# ---- K3's probes: P5's loops, P2's stages, K3's packed form -----------------

def _sorted_ids(rng, n, avg):
    return torch.from_numpy(np.sort(rng.integers(0, max(n // avg, 1), n))
                            .astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['roll', 'shift', 'fma'])
@pytest.mark.parametrize('n,avg', [(1, 1), (5, 2), (128, 128), (1000, 29),
                                   (8192, 32), (8193, 7), (40000, 29),
                                   (70000, 70000), (1 << 20, 32),
                                   (1 << 20, 1 << 20)])
def test_segscan_variant_matches_plain(cuda_device, variant, n, avg):
    """P5's kernel against its plain version (the TPU's tiles of 256 rows)
    and K3 in float64: within 2 TOL_ULPS and TOL_ULPS float32 eps of each
    element's segment prefix of |v| (both sum trees of adds); the same bits
    twice, one launch a call."""
    from fsw_gnn_tpu_torch.benchmarks import probe_segscan_variants as P5
    rng = np.random.default_rng(n + avg)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    ids = _sorted_ids(rng, n, avg)
    want = P5.segscan_variant_plain(v, ids, variant)
    v, ids = v.to(cuda_device), ids.to(cuda_device)
    before = P5.segscan_variant.launches
    got = P5.segscan_variant(v, ids, variant)
    again = P5.segscan_variant(v, ids, variant)
    torch.cuda.synchronize()
    assert P5.segscan_variant.launches == before + 2
    assert torch.equal(got, again)
    assert P5.ulps_of_prefix(got, v, ids) <= P5.TOL_ULPS
    prefix = P5.segcumsum(v.abs().double(), ids).cpu()
    err = (got.cpu().double() - want.double()).abs()
    eps = torch.finfo(torch.float32).eps
    assert bool(torch.all(err <= 2 * P5.TOL_ULPS * eps * prefix))


@pytest.mark.cuda
@pytest.mark.parametrize('ablate,passes', [('io', 0), ('fill1', 1),
                                           ('fill7', 7), ('mxu_only', 0),
                                           ('nofill', 0), ('full', 0)])
@pytest.mark.parametrize('n,avg,block_rows', [
    (128, 1, 64), (8192, 64, 64), (8192 * 3 + 640, 700, 64),
    (8192 * 3 + 640, 700, 128), (1 << 20, 4096, 64), (1 << 20, 4096, 256),
    (1 << 20, 1 << 20, 64)])
def test_fill_floor_stage_matches_plain(cuda_device, ablate, passes, n, avg,
                                        block_rows):
    """P2's stage kernels against their plain versions (the TPU's tiles of
    1024 rows, its honest carry depth): io and the fills bit for bit, the
    others against the plain version in float64 within TOL_EPS float32 eps
    of their scale (`within`); full also against K3 in float64;
    the same bits twice, one launch a call."""
    from fsw_gnn_tpu_torch.benchmarks import probe_fill_floor as P2
    from fsw_gnn_tpu_torch.ops.segcumsum import segment_boundaries
    rng = np.random.default_rng(n + avg)
    v = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32))
    ids = _sorted_ids(rng, n, avg)
    m = segment_boundaries(ids)
    max_seg = int(torch.bincount(ids).max())
    want = P2.fill_floor_plain(v, m, ablate, passes, max_seg)
    v, m = v.to(cuda_device), m.to(cuda_device)
    before = P2.fill_floor.launches
    got = P2.fill_floor(v, m, ablate, passes, block_rows=block_rows)
    again = P2.fill_floor(v, m, ablate, passes, block_rows=block_rows)
    torch.cuda.synchronize()
    assert P2.fill_floor.launches == before + 2
    assert torch.equal(got, again)
    got, v = got.cpu(), v.cpu()
    if ablate in ('io', 'fill1', 'fill7'):
        assert torch.equal(got, want)
    else:
        want = P2.fill_floor_plain(v.double(), m.cpu(), ablate, passes,
                                   max_seg)
        assert P2.within(got, want, v, m.cpu())[1] <= P2.TOL_EPS
    if ablate == 'full':
        ref = P2.segcumsum(v.double(), boundaries=m.cpu())
        assert P2.within(got, ref, v, m.cpu())[1] <= P2.TOL_EPS


@pytest.mark.cuda
@pytest.mark.parametrize('n,avg', [(1, 1), (5, 2), (4096, 4096), (4097, 9),
                                   (70000, 256), (70000, 70000),
                                   (1 << 20, 256), (1 << 20, 3)])
def test_packed_k3_is_mask_k3(cuda_device, n, avg):
    """K3's packed form against its mask form on the same values and ends,
    zeros at some ends (-0.0 packed): the same bits; against the plain
    version within K3's 8 eps of the prefix; one launch a call."""
    from fsw_gnn_tpu_torch.benchmarks import probe_segcumsum_fill as P3
    from fsw_gnn_tpu_torch.ops.segcumsum import segcumsum, segment_boundaries
    rng = np.random.default_rng(n + avg)
    vals = np.abs(rng.standard_normal(n)).astype(np.float32)
    m = segment_boundaries(_sorted_ids(rng, n, avg))
    vals[(m.numpy() == 1) & (rng.random(n) < 0.3)] = 0.0
    v = torch.from_numpy(vals)
    packed = P3.pack(v, m)
    assert int(torch.signbit(packed).sum()) == int(m.sum())
    want = P3.segcumsum_packed_plain(packed)
    before = P3.segcumsum_packed.launches
    got = P3.segcumsum_packed(packed.to(cuda_device))
    by_mask = segcumsum(v.to(cuda_device), boundaries=m.to(cuda_device))
    torch.cuda.synchronize()
    assert P3.segcumsum_packed.launches == before + 1
    assert torch.equal(got, by_mask)
    _k3_close(got, v.to(cuda_device),
              torch.cumsum(m.long(), 0).sub(m.long()).to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_segscan_probes_refuse_bad_inputs(cuda_device):
    from fsw_gnn_tpu_torch.benchmarks import probe_fill_floor as P2
    from fsw_gnn_tpu_torch.benchmarks import probe_segcumsum_fill as P3
    from fsw_gnn_tpu_torch.benchmarks import probe_segscan_variants as P5
    from fsw_gnn_tpu_torch.kernels import KernelError
    v = torch.ones(1024, device=cuda_device)
    ids = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    m = torch.zeros(1024, dtype=torch.int8, device=cuda_device)
    counts = (P5.segscan_variant.launches, P2.fill_floor.launches,
              P3.segcumsum_packed.launches)
    with pytest.raises(KernelError):
        P5.segscan_variant(v[1:], ids[1:], 'fma')          # misaligned
    with pytest.raises(TypeError):
        P5.segscan_variant(v.double(), ids, 'fma')
    with pytest.raises(KernelError):
        P2.fill_floor(v[1:], m[1:], 'io')
    with pytest.raises(TypeError):
        P3.segcumsum_packed(v.half())
    assert counts == (P5.segscan_variant.launches, P2.fill_floor.launches,
                      P3.segcumsum_packed.launches)
