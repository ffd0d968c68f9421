"""K1's projection P = Z V on the tensor cores, emulated in numpy: the
3xTF32 split that csrc/fsw_rank_common.cuh (`tile_product`) uses, against
float64, beside plain TF32 and a sequential float32 sum (the FMA loop of
K1's first design).

The emulation follows the kernel: each operand x is split as hi = tf32(x)
(round to nearest, ties away, to 10 mantissa bits: `cvt.rna.tf32.f32`) and
lo = tf32(x - hi); a chunk of 32 features sums lo_z hi_v + hi_z lo_v +
hi_z hi_v (the products are exact, and the chunk's sum is rounded once
here), and the chunks are added to a float32 running sum in order.

What it shows, at the bench width and at Cora's and Citeseer's feature
widths: the split's error is at float32's level (no larger than the
sequential float32 sum's), plain TF32's is a thousand times larger.  The
card's tensor cores truncate inside a chunk instead of rounding once; the
worst case of that (12 additions a chunk, each within 2^-23 of the
chunk's sum of |z v|), the dropped lo_z lo_v term (2^-22) and the chunk
folds (each within 2^-24 of the running sum) stays below 1e-5 of
sum_d |z_d v_d| up to D = 3703: the tolerance of
tests/test_torch_cuda.py::test_rank_proj_kernels_project_alike, which
plain TF32 would miss.
"""
import numpy as np
import pytest

KC = 32            # features a staged chunk (csrc/fsw_rank_common.cuh)
CARD_TOL = 1e-5    # the card test's tolerance, of sum_d |z_d v_d|


def tf32(x):
    """Round float32 values to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as `cvt.rna.tf32.f32` does."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def k1_product(Z, V, split=True):
    """The kernel's chunked product in float32; with split=False plain
    TF32 (hi_z hi_v only)."""
    acc = np.zeros((Z.shape[0], V.shape[1]), np.float32)
    for c in range(0, Z.shape[1], KC):
        z, v = Z[:, c:c + KC], V[c:c + KC]
        zh, vh = tf32(z).astype(np.float64), tf32(v).astype(np.float64)
        part = zh @ vh
        if split:
            zl = tf32(z - tf32(z)).astype(np.float64)
            vl = tf32(v - tf32(v)).astype(np.float64)
            part = zl @ vh + zh @ vl + part
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def sequential_f32(Z, V):
    """sum_d in the order d = 0 .. D-1, one rounding a step (fmaf)."""
    acc = np.zeros((Z.shape[0], V.shape[1]), np.float32)
    for d in range(Z.shape[1]):
        acc = (acc + Z[:, d:d + 1].astype(np.float64) * V[d:d + 1]).astype(
            np.float32)
    return acc


@pytest.mark.parametrize('D', [64, 1433, 3703])
def test_3xtf32_split_keeps_float32_accuracy(D):
    rng = np.random.default_rng(D)
    Z = rng.standard_normal((64, D)).astype(np.float32)
    V = (rng.standard_normal((D, 64)) / np.sqrt(D)).astype(np.float32)
    exact = Z.astype(np.float64) @ V.astype(np.float64)
    scale = np.abs(Z).astype(np.float64) @ np.abs(V).astype(np.float64)

    def err(P):
        return float((np.abs(P - exact) / scale).max())
    e3, e1, ef = err(k1_product(Z, V)), err(k1_product(Z, V, False)), err(
        sequential_f32(Z, V))
    assert e3 <= ef                     # float32's level
    assert e1 >= 50 * ef                # plain TF32 is not
    n_chunks = -(-D // KC)
    worst = 12 * 2.0 ** -23 + 2.0 ** -22 + n_chunks * 2.0 ** -24
    assert e3 + worst <= CARD_TOL
    assert e1 > CARD_TOL
