"""The H100's bound model of the rank kernels: the least time the card
could take for a call's work.

A bound is the largest of (bytes that must move) / 3.35 TB/s, (float32
operations outside the tensor cores) / 67 TFLOP/s and, for K1's
projections, (their operations) / (495 / 3) TFLOP/s: the H100 SXM's
published peaks at 700 W, TF32 on the tensor cores taken three times a
float32 product (the 3xTF32 split K1 runs; the pipes overlap, so the
largest time bounds).  Bytes: every input read once and every output
written once, except that K2f and K4f read only the real entries' columns
of P.  Operations: the least that the call's data needs.  Zero-weight
(padding) entries contribute exactly 0, and ranking d entries of one slice
needs no more than a stable sort and a cumsum, d log2 d + d operations, so
a row with d real entries needs
  K1f: S * (d (2 D + 20) + d log2 d + d): 2 D an entry for the projection
       (on the tensor cores), about 20 for the trig of one entry-slice;
  K1b: S * (d (6 D + 45) + d log2 d + d): 2 D each for the recomputed
       projection, dZ and dV (on the tensor cores), about 45 for the two
       sincospi, the dp, phi_f and df terms of one entry-slice;
  K2f, K2b: K1f's and K1b's without the products (plus d with with_dw);
  K4f, K4b: with F frequencies, the trig F times over one ranking.

`chip_smoke.py` prints every kernel's bound from these functions and
`bench.speed_of_light_step` sums K1f's and K1b's over the degree classes,
so the two cannot drift apart.  The functions take the (R, B) weights as
a tensor and read only which entries are real.
"""
from __future__ import annotations

import math

PEAK_F32_OPS = 67e12
PEAK_TF32_OPS = 495e12
PEAK_BYTES = 3.35e12
TRIG_OPS, BWD_TRIG_OPS = 20, 45


def bound(ops, nbytes, mma_ops=0.0):
    """(bound ms, 'operations' or 'bytes') of `ops` float32 operations,
    `mma_ops` more as 3xTF32 products on the tensor cores, and `nbytes`."""
    t_ops = max(ops / PEAK_F32_OPS, 3 * mma_ops / PEAK_TF32_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def rank_ops(deg):
    """Operations that rank the real entries of one slice at the least,
    per row of deg real entries (a float64 tensor): a stable sort's
    deg log2 deg compares and a cumsum's deg adds."""
    return deg * deg.clamp(min=1.0).log2() + deg


def _degrees(wn):
    return (wn > 0).sum(dim=1).double()


def rank_work(wn, D, S):
    """(float32 operations, 3xTF32 product operations, bytes) of one K1f
    call on (R, B) normalized weights wn, zero at the padding: reads Z,
    wn, pad, freqs and V, writes out."""
    R, B = wn.shape
    deg = _degrees(wn)
    ops = S * float((deg * TRIG_OPS + rank_ops(deg)).sum())
    mma = S * float(deg.sum()) * 2 * D
    nbytes = 4 * (R * B * D + R * B + R + S + D * S + R * S)
    return ops, mma, nbytes


def rank_bwd_work(wn, D, S):
    """(float32 operations, 3xTF32 product operations, bytes) of one K1b
    call without with_dw: reads Z, wn, pad, freqs, V and the output
    cotangent, writes dZ, df and dV."""
    R, B = wn.shape
    deg = _degrees(wn)
    ops = S * float((deg * BWD_TRIG_OPS + rank_ops(deg)).sum())
    mma = S * float(deg.sum()) * 6 * D
    nbytes = 4 * (2 * R * B * D + R * B + R + 2 * S + 2 * D * S + R * S)
    return ops, mma, nbytes


def rank_bound_ms(wn, D, S):
    """(bound ms, 'operations' or 'bytes', padded-shape bound ms) of one
    K1f call (`rank_work`); the padded shape counts every table entry."""
    R, B = wn.shape
    ops, mma, nbytes = rank_work(wn, D, S)
    ms, by = bound(ops, nbytes, mma)
    padded = bound(R * S * (B * TRIG_OPS + B * math.log2(max(B, 1)) + B),
                   nbytes, R * S * B * 2 * D)[0]
    return ms, by, padded


def rank_bwd_bound_ms(wn, D, S):
    """(bound ms, 'operations' or 'bytes') of one K1b call without with_dw
    (`rank_bwd_work`)."""
    ops, mma, nbytes = rank_bwd_work(wn, D, S)
    return bound(ops, nbytes, mma)


def rank2_bound_ms(wn, S, bwd=False, with_dw=False, F=1):
    """(bound ms, 'operations' or 'bytes') of one K2f call, or K2b call
    with or without with_dw, on (R, B) normalized weights wn, zero at the
    padding; with F frequency columns, of K4f or K4b.  The forward reads
    the real entries' columns of P, wn, pad, freqs and writes out; the
    backward reads P, wn, pad, freqs and the cotangent and writes dP, df
    (and dwn, dpad)."""
    R, B = wn.shape
    deg = _degrees(wn)
    per = (BWD_TRIG_OPS * F + (1 if with_dw else 0)) if bwd else TRIG_OPS * F
    ops = S * float((deg * per + rank_ops(deg)).sum())
    if bwd:
        nbytes = 4 * (2 * R * B * S + R * S * F + R * B + R + 2 * S * F
                      + (R * B + R if with_dw else 0))
    else:
        nbytes = 4 * (S * float(deg.sum()) + R * B + R + S * F + R * S * F)
    return bound(ops, nbytes)
