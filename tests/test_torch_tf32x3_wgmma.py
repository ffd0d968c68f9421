"""Probe P1's 'wgmma' routine (csrc/tf32x3_wgmma.cuh) emulated in numpy: its
accumulation against float64 at Cora's depth and at the headline dv's,
and `kernel_matmul`'s `routine` argument on the CPU.

The emulation follows the kernel: each operand x is split once a staged
chunk as hi = tf32(x) (round to nearest, ties away: `cvt.rna.tf32.f32`)
and lo = tf32(x - hi); a chunk of 32 k takes four k8 steps, each adding
lo_a hi_b, hi_a lo_b and hi_a hi_b into the chunk's accumulator (the
8-term products exact, the accumulator rounded to float32 after each, as
an upper model of the tensor cores' truncating additions); the chunk is
folded into the float32 sum once, in the order of k; for dv the depth is
cut into the ranges of `wgmma_dv_split` and their partials are summed in
range order (`sum_parts`).  The result must stay within P1's TOL_REL of
the float64 product's scale, as the card's check asks.
"""
import numpy as np
import pytest
import torch

from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1

KC, K8 = 32, 8


def tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi.astype(np.float64), tf32(x - hi).astype(np.float64)


def wgmma_range(a, b):
    """The routine's float32 sum of a . b over one range of k, for a few
    output elements at once: a, b (n, K) float32."""
    n, K = a.shape
    pad = -K % KC
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, 0), (0, pad)))
    (ah, al), (bh, bl) = split(a), split(b)
    steps = (K + pad) // K8

    def step_sums(x, y):      # (n, steps): each k8 step's exact product sum
        return (x * y).reshape(n, steps, K8).sum(axis=2)

    terms = (step_sums(al, bh), step_sums(ah, bl), step_sums(ah, bh))
    acc = np.zeros(n, np.float32)
    for c in range(steps // 4):
        part = np.zeros(n, np.float32)
        for s in range(4 * c, 4 * c + 4):
            for t in terms:
                part = (part.astype(np.float64) + t[:, s]).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return acc


def wgmma_dot(a, b, chunk):
    """Ranges of `chunk` k, their partials summed in order."""
    out = np.zeros(a.shape[0], np.float32)
    for k0 in range(0, a.shape[1], chunk):
        out = (out + wgmma_range(a[:, k0:k0 + chunk],
                                 b[:, k0:k0 + chunk])).astype(np.float32)
    return out


@pytest.mark.parametrize('case', ['cora_fwd', 'cora_dv', 'headline_dv'])
def test_wgmma_accumulation_keeps_float32_accuracy(case):
    """A few output elements: Cora's layer 0 forward (K = D = 1433, one
    range), its dv (K = 21696, the split of 276 tiles) and the headline's
    dv (K = 131072 entries, one tile: 256 ranges of 512), within TOL_REL
    of the elements' float64 scale."""
    name = {'cora_fwd': 'cora_layer0', 'cora_dv': 'cora_layer0',
            'headline_dv': 'headline'}[case]
    _, TR, B, D, S = dict((s[0], s) for s in P1.SHAPES)[name]
    K = D if case == 'cora_fwd' else TR * B
    tiles = 1 if case == 'cora_fwd' else -(-D // 128) * -(-S // 128)
    chunk = K if case == 'cora_fwd' else P1.wgmma_dv_split(K, tiles)[0]
    rng = np.random.default_rng(K)
    a = rng.standard_normal((4, K)).astype(np.float32)
    b = rng.standard_normal((4, K)).astype(np.float32)
    exact = (a.astype(np.float64) * b.astype(np.float64)).sum(axis=1)
    got = wgmma_dot(a, b, chunk)
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= P1.TOL_REL * scale
    # plain TF32 (hi_a hi_b alone) would not be
    hi = (tf32(a).astype(np.float64) * tf32(b).astype(np.float64)).sum(1)
    assert np.abs(hi - exact).max() > np.abs(got - exact).max()


def test_dv_split_fills_the_card_at_the_headline():
    """The headline's dv (one 64 x 127 output tile) and dv_loop (16 b)
    give at least 132 units, every range a whole number of chunks, the
    ranges covering the depth; Cora's dv at least 528 units."""
    _, TR, B, D, S = dict((s[0], s) for s in P1.SHAPES)['headline']
    for kind in ('dv', 'dv_loop'):
        assert P1.wgmma_parts(kind, TR, B, D, S) >= 132
    chunk, splits = P1.wgmma_dv_split(TR * B, 1)
    assert chunk % KC == 0 and (splits - 1) * chunk < TR * B <= splits * chunk
    _, TR, B, D, S = dict((s[0], s) for s in P1.SHAPES)['cora_layer0']
    tiles = -(-D // 128) * -(-S // 128)
    assert tiles * P1.wgmma_parts('dv', TR, B, D, S) >= 528
    assert P1.wgmma_parts('fwd', TR, B, D, S) == 0


@pytest.mark.parametrize('kind', P1.KINDS)
def test_both_routines_are_the_plain_version_on_the_cpu(kind):
    x = P1.operands(('tiny', 3, 4, 10, 7), torch.device('cpu'))
    a, b = (x[n] for n in P1.SPEC[kind][0])
    want = P1.kernel_matmul_plain(kind, a, b)
    for routine in P1.ROUTINES:
        assert torch.equal(P1.kernel_matmul(kind, a, b, routine), want)
    assert torch.equal(P1.kernel_matmul(kind, a, b), want)
    with pytest.raises(ValueError, match='routine'):
        P1.kernel_matmul(kind, a, b, 'mma')
