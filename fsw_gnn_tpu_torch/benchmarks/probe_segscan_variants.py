"""Probe P5: three forms of the segmented scan's inner loop, against K3.

Counterpart of benchmarks/probe_segscan_variants.py, which runs the
segmented inclusive cumsum of values by sorted int32 ids over rows of 128
lanes with one of three lane-doubling loops (`roll`: wrap, then a
lane >= stride mask; `shift`: no wrap, pad id -2; `fma`: add
shifted * (float)(ids equal)), then the affine row carry and the tile
carry.  On the card each variant is csrc/probe_segscan.cu's kernel for
it: a warp a row, four elements a lane, the doubling over warp shuffles in
the variant's form, then a deterministic carry across rows and blocks.

For each variant the script first runs the probe's own correctness case
(40000 elements, ids of mean segment 29, against a float64 oracle: max abs
error below 1e-3, as the probe asserts), then the timed case (N elements,
segments of AVG_SEG): the variant against K3 in float64 (within TOL_ULPS
float32 eps of each element's segment prefix of |v|), then timed in turns
with K3's ids form (`ops.segcumsum.segcumsum`) on the same data; GB/s
counts 12 bytes an element.  A variant outside either bound raises after
its line.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_segscan_variants [--device cpu]

Knobs (the TPU probe's, with its defaults): FSW_SEGBENCH_N 2^24,
FSW_SEGBENCH_SEG 32, FSW_SEGBENCH_ITERS 20 (calls a timing window),
FSW_SEGBENCH_ROWS 256 (the TPU's tile: the plain version's; a block on the
card takes 64 rows), FSW_SEGBENCH_VARIANTS 'roll,shift,fma',
FSW_SEGBENCH_MAXSEG 0 (the TPU kernel's bound on the row carry's depth,
0 for none: the plain version truncates as the TPU kernel does; the card's
kernel is exact for any segment length).

`segscan_variant` runs a variant's kernel on CUDA tensors (each call adding
one to `segscan_variant.launches`) and its plain version,
`segscan_variant_plain` (the TPU kernel's loops and carries, a tile at a
time), on CPU tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..ops.fsw_rank import _count, _kernel, _launch
from ..ops.segcumsum import segcumsum
from . import _timing

N = int(os.environ.get('FSW_SEGBENCH_N', 1 << 24))
AVG_SEG = int(os.environ.get('FSW_SEGBENCH_SEG', 32))
ITERS = int(os.environ.get('FSW_SEGBENCH_ITERS', 20))
ROWS = int(os.environ.get('FSW_SEGBENCH_ROWS', 256))
VARIANTS = os.environ.get('FSW_SEGBENCH_VARIANTS', 'roll,shift,fma').split(',')
MAXSEG = int(os.environ.get('FSW_SEGBENCH_MAXSEG', 0))

LANES = 128
INT32_MAX = 2 ** 31 - 1
VARIANT_CODES = {'roll': 0, 'shift': 1, 'fma': 2}
CHECK_N, CHECK_SEG, CHECK_ATOL = 40000, 29, 1e-3
CARD_BLOCK_ROWS = 64          # rows of 128 a block of the card's kernel
# Each element is a binary tree of adds over its segment: seven in-row
# passes, the chunk's row scan (up to seven levels) and the carries into
# its row and block; 16 float32 roundings of partial sums no larger than
# the segment's prefix of |v| bound it.
TOL_ULPS = 16


def _shift_in(x, stride, fill):
    """x shifted right by `stride` along the last axis, `fill` shifted in
    (the TPU probe's `_shift`)."""
    pad = torch.full(x.shape[:-1] + (stride,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-stride]], -1)


def row_segscan_roll(vals, segs):
    lane = torch.arange(LANES, device=vals.device)
    stride = 1
    while stride < LANES:
        shifted_v = torch.roll(vals, stride, -1)
        shifted_s = torch.roll(segs, stride, -1)
        ok = (lane >= stride) & (shifted_s == segs)
        vals = vals + torch.where(ok, shifted_v, torch.zeros_like(vals))
        stride *= 2
    return vals


def row_segscan_shift(vals, segs):
    stride = 1
    while stride < LANES:
        shifted_v = _shift_in(vals, stride, 0.0)
        shifted_s = _shift_in(segs, stride, -2)
        vals = vals + torch.where(shifted_s == segs, shifted_v,
                                  torch.zeros_like(vals))
        stride *= 2
    return vals


def row_segscan_fma(vals, segs):
    stride = 1
    while stride < LANES:
        shifted_v = _shift_in(vals, stride, 0.0)
        shifted_s = _shift_in(segs, stride, -2)
        vals = vals + shifted_v * (shifted_s == segs).to(vals.dtype)
        stride *= 2
    return vals


SCANS = {'roll': row_segscan_roll, 'shift': row_segscan_shift,
         'fma': row_segscan_fma}


def affine_carry_scan(a, b, max_depth):
    """C_r = a_r + b_r C_{r-1} along axis 0 of (rows, 1) columns, composed
    by doubling over at most `max_depth` rows back (the TPU kernels'
    `_affine_carry_scan`)."""
    pos = torch.arange(a.shape[0], device=a.device)[:, None]
    stride = 1
    while stride <= max_depth:
        valid = pos >= stride
        a_sh, b_sh = torch.roll(a, stride, 0), torch.roll(b, stride, 0)
        a = a + torch.where(valid, b * a_sh, torch.zeros_like(a))
        b = b * torch.where(valid, b_sh, torch.zeros_like(b))
        stride *= 2
    return a


def segscan_variant_plain(values, ids, variant, rows=ROWS, maxseg=MAXSEG):
    """The TPU probe's `segcumsum(values, ids, variant)`: padded to tiles of
    `rows` rows of 128 (value 0, id INT32_MAX), each tile's rows scanned by
    the variant's loop, the affine row carry (at most MAXSEG // 128 rows
    deep when MAXSEG is set), the previous tile's last element and id
    carried into the next."""
    n = values.shape[0]
    block = rows * LANES
    pad = -(-max(n, 1) // block) * block - n
    v2 = torch.nn.functional.pad(values, (0, pad)).reshape(-1, LANES)
    s2 = torch.nn.functional.pad(ids.to(torch.int32), (0, pad),
                                 value=INT32_MAX).reshape(-1, LANES)
    depth = min(maxseg // LANES if maxseg else rows - 1, rows - 1)
    out = torch.empty_like(v2)
    carry_v = torch.zeros((), dtype=values.dtype, device=values.device)
    carry_s = torch.full((), -1, dtype=torch.int32, device=values.device)
    for t0 in range(0, v2.shape[0], rows):
        vals, segs = v2[t0:t0 + rows], s2[t0:t0 + rows]
        scanned = SCANS[variant](vals, segs)
        t = scanned[:, -1:]
        first_s, last_s = segs[:, :1], segs[:, -1:]
        prev_last_s = torch.roll(last_s, 1, 0)
        prev_t = torch.roll(t, 1, 0)
        prev_single = torch.roll((first_s == last_s).to(vals.dtype), 1, 0)
        prev_last_s[0] = carry_s
        prev_t[0] = carry_v
        prev_single[0] = 0.0
        g = (first_s == prev_last_s).to(vals.dtype)
        a = affine_carry_scan(g * prev_t, g * prev_single, depth)
        scanned = scanned + torch.where(segs == first_s, a,
                                        torch.zeros_like(scanned))
        out[t0:t0 + rows] = scanned
        carry_v, carry_s = scanned[-1, -1], segs[-1, -1]
    return out.reshape(-1)[:n]


def segscan_variant(values, ids, variant):
    """The segmented inclusive cumsum of values (n,) float32 by sorted ids
    (n,) int32 (int64 is converted), scanned in rows of 128 by `variant`'s
    loop: its kernel on CUDA tensors (contiguous, 16-byte aligned; each
    call adding one to `segscan_variant.launches`), its plain version on
    CPU tensors."""
    if values.shape != ids.shape or values.dim() != 1:
        raise ValueError(f'values {tuple(values.shape)} and ids '
                         f'{tuple(ids.shape)} must be flat and alike')
    if variant not in VARIANT_CODES:
        raise ValueError(f'variant must be one of {tuple(VARIANT_CODES)}')
    if values.device.type == 'cpu':
        return segscan_variant_plain(values, ids, variant)
    if values.dtype != torch.float32:
        raise TypeError(f'values must be float32, got {values.dtype}')
    ids = ids.to(torch.int32)
    if not (values.is_contiguous() and ids.is_contiguous()) or any(
            t.data_ptr() % 16 for t in (values, ids)):
        raise kernels.KernelError('P5: values and ids must be contiguous '
                                  'and 16-byte aligned')
    out = torch.empty_like(values)
    n = values.shape[0]
    if n == 0:
        return out
    fns = _kernel('probe_segscan')[1]
    blocks = fns['blocks'](n, CARD_BLOCK_ROWS)
    agg = torch.empty(blocks, dtype=torch.float32, device=values.device)
    fresh, lead = (torch.empty(blocks, dtype=torch.int32,
                               device=values.device) for _ in range(2))
    _launch('probe_segscan_variant', fns['variant_f32'], values, ids, out,
            agg, fresh, lead, n, CARD_BLOCK_ROWS, VARIANT_CODES[variant])
    _count(segscan_variant)
    return out


segscan_variant.launches = 0


def ulps_of_prefix(got, values, ids):
    """max |got - ref| / (eps32 x prefix): ref the segmented cumsum in
    float64 and prefix that of |values| (K3 in float64 on the card)."""
    ref = segcumsum(values.double(), ids)
    prefix = segcumsum(values.abs().double(), ids)
    eps = torch.finfo(torch.float32).eps
    err = (got.double() - ref).abs()
    return float((err / (eps * prefix).clamp(min=1e-300)).max())


def inputs(dev, n=N, avg=AVG_SEG, seed=0):
    """The TPU probe's two cases from one generator: (small values, small
    ids, their float64 oracle, values, ids) on `dev`."""
    rng = np.random.default_rng(seed)
    ids_small = np.sort(rng.integers(0, CHECK_N // CHECK_SEG,
                                     CHECK_N)).astype(np.int32)
    vals_small = rng.standard_normal(CHECK_N).astype(np.float32)
    bounds = np.flatnonzero(np.diff(ids_small)) + 1
    want = np.concatenate([np.cumsum(c) for c in np.split(
        vals_small.astype(np.float64), bounds)])
    ids = np.sort(rng.integers(0, max(n // avg, 1), n)).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (vals_small, ids_small, want, vals, ids))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_segscan_variants')
    vs, ss, want, v, s = inputs(dev)
    key = _timing.time_key(dev)
    for name in VARIANTS:
        err = float((segscan_variant(vs, ss, name).double() - want).abs()
                    .max())
        _timing.emit(dev, variant=name, check_max_abs_err=err,
                     ok=err < CHECK_ATOL)
        if not err < CHECK_ATOL:
            raise RuntimeError(f'P5 {name}: {err:.3e} from the float64 '
                               f'oracle, not below {CHECK_ATOL}')
        ulps = ulps_of_prefix(segscan_variant(v, s, name), v, s)
        times = _timing.aba_ms(
            {name: lambda: segscan_variant(v, s, name),
             'k3_ids': lambda: segcumsum(v, s)}, dev, iters=ITERS)
        ms, k3 = _timing.median(times[name]), _timing.median(times['k3_ids'])
        fields = {'variant': name, 'rows': ROWS,
                  'card_block_rows': CARD_BLOCK_ROWS,
                  'n': N, key: ms, f'k3_ids_{key}': k3,
                  f'all_{key}': times[name],
                  f'k3_ids_all_{key}': times['k3_ids'],
                  'max_ulps_of_prefix_vs_f64': ulps}
        if dev.type == 'cuda':
            fields.update(GB_s=12 * N / ms / 1e6, k3_ids_GB_s=12 * N / k3 / 1e6)
        _timing.emit(dev, **fields)
        if not ulps <= TOL_ULPS:
            raise RuntimeError(f'P5 {name}: {ulps:.2f} eps of the segment '
                               f'prefix from float64, above {TOL_ULPS}')


if __name__ == '__main__':
    main()
