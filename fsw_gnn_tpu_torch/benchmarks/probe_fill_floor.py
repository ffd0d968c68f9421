"""Probe P2: where the boundary-mask segmented cumsum's time goes, stage by
stage.

Counterpart of benchmarks/probe_fill_floor.py, which cuts the TPU's mask
kernel into nested functions of values v >= 0 and an int8 is_end mask
(1 on the last element of each segment) over rows of 128:

  io        v + is_end                                   the loads' floor
  fill1/7   1 or 7 running-max passes (element 2^i before) + is_end
  mxu_only  in-row inclusive prefix + ends strictly before, in the row
  nofill    the prefix + the row and tile carry (no fill-forward)
  full      the segmented cumsum: the prefix minus the fill-forward base
            (the prefix at the last end before, by the running max), then
            the carry

On the card each stage is csrc/probe_segscan.cu's kernel for it (a warp a
row, the prefix and the passes over warp shuffles, the carry deterministic
across rows and blocks), so the differences price the loads, the warp's
in-row scan, the row-and-block carry and the fill.  Every stage is checked
against its plain version (`fill_floor_plain`, the TPU kernel's formulas
with its tiles of ROWS rows): io, fill1 and fill7 bit for bit, the others
against the plain version in float64, within TOL_EPS float32 eps of each
element's scale: the sum of v from the first element of the row where its
segment starts, plus its value (the error class of a prefix-minus-base
formulation, which the TPU kernel shares: eps times the in-row prefixes it
subtracts, carried into the rows after); full also against K3 in float64.  A stage outside its bound
raises after its line.  Then full is timed in turns
with K3's mask form, which computes the same function on the same data,
and the stage differences and the bytes' bound (9 bytes an element at
3.35 TB/s) are printed.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_fill_floor [--device cpu]

Knobs (the TPU probe's, with its defaults): FSW_SEGBENCH_N 2^24,
FSW_SEGBENCH_SEG 4096, FSW_SEGBENCH_ITERS 20, FSW_SEGBENCH_ROWS 1024 (the
TPU's tile: the plain version's; a block on the card walks 64 rows, 32 at
a time),
FSW_PROBE_PHASE 1.  FSW_PROBE_PHASE=2 runs the rows ladder instead: full
and io with blocks of 256, 512 and ROWS rows (a block's loop over them
takes the place of the TPU's sequential tile), full checked at each.  The
TPU probe's precision pair (`highest`, `bf16x3`) has no counterpart: the
in-row prefix is summed in float32 adds, not in decomposed products, and a
line says so.

`fill_floor` runs a stage's kernel on CUDA tensors (each call adding one
to `fill_floor.launches`) and its plain version on CPU tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..ops.fsw_rank import _count, _kernel, _launch
from ..ops.segcumsum import segcumsum, segment_boundaries
from . import _timing
from .probe_segscan_variants import LANES, _shift_in, affine_carry_scan

N = int(os.environ.get('FSW_SEGBENCH_N', 1 << 24))
AVG_SEG = int(os.environ.get('FSW_SEGBENCH_SEG', 4096))
ITERS = int(os.environ.get('FSW_SEGBENCH_ITERS', 20))
ROWS = int(os.environ.get('FSW_SEGBENCH_ROWS', 1024))
PHASE = os.environ.get('FSW_PROBE_PHASE', '1')

ABLATIONS = (('io', 0), ('fill1', 1), ('fill7', 7), ('mxu_only', 0),
             ('nofill', 0), ('full', 0))
STAGES = {'io': 0, 'fill': 1, 'mxu_only': 2, 'nofill': 3, 'full': 4}
EXACT = ('io', 'fill')
CHUNK_ROWS = 64
PEAK_BYTES = 3.35e12
# a prefix minus a base, each a tree of nine float32 adds over a row of
# 128 (its lane's four, five warp levels, the offset), then the carries
# into the row and the block: 32 roundings of the scale (`within`) bound
# the kernel's error against float64
TOL_EPS = 32


def _stage(ablate):
    return 'fill' if ablate.startswith('fill') else ablate


def fill_base_ends(p_full, is_end_f, max_stride):
    """The prefix at the last end strictly before each element, by the
    running max (the TPU kernels' `_fill_base_ends`)."""
    ends = torch.where(is_end_f > 0, p_full, torch.zeros_like(p_full))
    base = _shift_in(ends, 1, 0.0)
    stride = 1
    while stride < max_stride:
        base = torch.maximum(base, _shift_in(base, stride, 0.0))
        stride *= 2
    return base


def fill_floor_plain(v, m, ablate, passes=0, max_seg=None, rows=ROWS):
    """The TPU probe's `kernel(ablate, fill_passes)` over values v (n,) and
    the mask m (n,), n a multiple of 128: the stages a row at a time, the
    carry a tile of `rows` rows at a time, at most
    min(max_seg // 128, rows - 1) rows deep, the fill min(max_seg, 128)
    wide (max_seg None: n)."""
    v2 = v.reshape(-1, LANES)
    e = m.reshape(-1, LANES).to(v.dtype)
    if ablate == 'io':
        return (v2 + e).reshape(-1)
    if ablate.startswith('fill'):
        base, stride = v2, 1
        for _ in range(passes):
            base = torch.maximum(base, _shift_in(base, stride, 0.0))
            stride *= 2
        return (base + e).reshape(-1)
    # the in-row prefixes as the TPU kernel forms them: products with the
    # upper triangle of ones (float32, no TF32 on the card)
    lane = torch.arange(LANES, device=v.device)
    tri = (lane[:, None] <= lane[None, :]).to(v.dtype)
    p_full = v2 @ tri
    cnt_strict = e @ tri - e
    if ablate == 'mxu_only':
        return (p_full + cnt_strict).reshape(-1)
    max_seg = v.shape[0] if max_seg is None else max_seg
    scanned = p_full
    if ablate == 'full':
        scanned = p_full - fill_base_ends(p_full, e, min(max_seg, LANES))
    depth = min(max_seg // LANES, rows - 1)
    out = torch.empty_like(scanned)
    carry_v = torch.zeros((), dtype=v.dtype, device=v.device)
    carry_m = torch.ones((), dtype=v.dtype, device=v.device)
    for t0 in range(0, scanned.shape[0], rows):
        sc, ee, cs = (x[t0:t0 + rows] for x in (scanned, e, cnt_strict))
        t = sc[:, -1:]
        prev_last_end = torch.roll(ee[:, -1:], 1, 0)
        prev_t = torch.roll(t, 1, 0)
        prev_single = torch.roll((cs[:, -1:] == 0).to(v.dtype), 1, 0)
        prev_last_end[0] = carry_m
        prev_t[0] = carry_v
        prev_single[0] = 0.0
        g = 1.0 - prev_last_end
        c = affine_carry_scan(g * prev_t, g * prev_single, depth)
        sc = sc + torch.where(cs == 0, c, torch.zeros_like(sc))
        out[t0:t0 + rows] = sc
        carry_v, carry_m = sc[-1, -1], ee[-1, -1]
    return out.reshape(-1)


def fill_floor(v, m, ablate, passes=0, *, max_seg=None, rows=ROWS,
               block_rows=CHUNK_ROWS):
    """Stage `ablate` ('io', 'fill1' ..., 'mxu_only', 'nofill', 'full'; a
    fill stage runs `passes` passes) of values v (n,) float32 >= 0 and the
    is_end mask m (n,) int8 of 0 and 1: on CUDA tensors the kernel
    (contiguous, v 16-byte and m 4-byte aligned; `block_rows` rows a block,
    a multiple of 32; each call adding one to `fill_floor.launches`), on CPU
    tensors the plain version (`max_seg` and `rows` as there)."""
    if v.dim() != 1 or m.shape != v.shape:
        raise ValueError(f'v {tuple(v.shape)} and m {tuple(m.shape)} must '
                         f'be flat and alike')
    stage = STAGES[_stage(ablate)]
    if v.device.type == 'cpu':
        return fill_floor_plain(v, m, ablate, passes, max_seg, rows)
    if v.dtype != torch.float32 or m.dtype not in (torch.int8, torch.uint8,
                                                   torch.bool):
        raise TypeError(f'v must be float32 and m int8, got {v.dtype}, '
                        f'{m.dtype}')
    m = m.view(torch.int8)
    if (not (v.is_contiguous() and m.is_contiguous()) or v.data_ptr() % 16
            or m.data_ptr() % 4):
        raise kernels.KernelError('P2: v and m must be contiguous, v '
                                  '16-byte and m 4-byte aligned')
    out = torch.empty_like(v)
    n = v.shape[0]
    if n == 0:
        return out
    fns = _kernel('probe_segscan')[1]
    blocks = fns['blocks'](n, block_rows)
    agg = torch.empty(blocks, dtype=torch.float32, device=v.device)
    fresh, lead = (torch.empty(blocks, dtype=torch.int32, device=v.device)
                   for _ in range(2))
    _launch('probe_segscan_stage', fns['stage_f32'], v, m, out, agg, fresh,
            lead, n, block_rows, stage, passes)
    _count(fill_floor)
    return out


fill_floor.launches = 0


def within(got, want, v, m):
    """(bit-equal, max |got - want| / (eps32 scale)) elementwise, the scale
    of element i the sum of v from the first element of the row where i's
    segment starts (the ends in the mask m) up to i, plus |want_i|."""
    n = v.shape[0]
    csum = torch.cumsum(v.double(), 0)
    idx = torch.arange(n, device=v.device)
    start = torch.zeros(n, dtype=torch.long, device=v.device)
    start[1:] = torch.where(m[:-1] != 0, idx[1:], 0)
    row0 = torch.cummax(start, 0).values // LANES * LANES
    before = torch.where(row0 > 0, csum[(row0 - 1).clamp(min=0)], 0.0)
    scale = torch.finfo(torch.float32).eps * (
        csum - before + want.double().abs())
    err = (got.double() - want.double()).abs()
    return (bool(torch.equal(got, want)),
            float((err / scale.clamp(min=1e-300)).max()))


def inputs(dev, n=N, avg=AVG_SEG, seed=0):
    """The TPU probe's data: (v |normal|, the mask of sorted random ids,
    the longest segment)."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, max(n // avg, 1), n)).astype(np.int32)
    vals = np.abs(rng.standard_normal(n)).astype(np.float32)
    max_seg = int(np.max(np.bincount(ids)))
    v = torch.from_numpy(vals).to(dev)
    m = segment_boundaries(torch.from_numpy(ids).to(dev))
    return v, m, max_seg


def check(dev, v, m, ablate, passes, max_seg, got, label=None):
    """Raise unless `got` (stage `ablate` of v, m) is its plain version's
    bits (io, fill) or within TOL_EPS of it in float64; returns the fields
    of its line."""
    want = fill_floor_plain(v, m, ablate, passes, max_seg, ROWS)
    equal, eps_err = within(got, want, v, m)
    fields = {'bit_equal_plain': equal, 'eps_of_prefix_vs_plain': eps_err}
    if _stage(ablate) in EXACT:
        bad = not equal
    else:
        _, f64 = within(got, fill_floor_plain(v.double(), m, ablate, passes,
                                              max_seg, ROWS), v, m)
        fields['eps_of_prefix_vs_plain_f64'] = f64
        bad = not f64 <= TOL_EPS
    if ablate == 'full':
        _, ref = within(got, segcumsum(v.double(), boundaries=m), v, m)
        fields['eps_of_prefix_vs_f64'] = ref
        bad = bad or not ref <= TOL_EPS
    if bad:
        _timing.emit(dev, ablate=label or ablate, **fields)
        raise RuntimeError(f'P2 {label or ablate}: {fields}')
    return fields


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_fill_floor')
    v, m, max_seg = inputs(dev)
    _timing.emit(dev, n=N, avg_seg=AVG_SEG, max_seg=max_seg, rows=ROWS,
                 card_block_rows=CHUNK_ROWS, phase=PHASE)
    key = _timing.time_key(dev)
    card = dev.type == 'cuda'

    def run(ablate, passes, block_rows=CHUNK_ROWS):
        return fill_floor(v, m, ablate, passes, max_seg=max_seg,
                          block_rows=block_rows)

    def timed(name, ablate, passes, block_rows=CHUNK_ROWS):
        fields = check(dev, v, m, ablate, passes, max_seg,
                       run(ablate, passes, block_rows), name)
        ms = _timing.median_ms(lambda: run(ablate, passes, block_rows), dev,
                               iters=ITERS)
        if card:
            fields['GB_s_9B'] = 9 * N / ms / 1e6
        _timing.emit(dev, ablate=name, **{key: ms}, **fields)
        return ms

    results = {}
    if PHASE != '1':
        _timing.emit(dev, precision='not applicable',
                     note='the TPU probe compares the MXU triangle at '
                          "'highest' and in three bf16 passes; here the "
                          'in-row prefix is float32 adds on the warp')
        for rows in (256, 512, ROWS):
            results[f'full_rows{rows}'] = timed(f'full_rows{rows}', 'full',
                                                0, rows)
            results[f'io_rows{rows}'] = timed(f'io_rows{rows}', 'io', 0,
                                              rows)
        _timing.emit(dev, **{f'{k}_{key}': t for k, t in results.items()})
        return results
    for name, fp in ABLATIONS:
        results[name] = timed(name, name, fp)
    turns = _timing.aba_ms(
        {'full': lambda: run('full', 0),
         'k3_mask': lambda: segcumsum(v, boundaries=m)}, dev, iters=ITERS)
    _, vs_k3 = within(run('full', 0), segcumsum(v, boundaries=m), v, m)
    d = results
    _timing.emit(dev, stage_ms={
        'io': d['io'], 'in_row_scan': d['mxu_only'] - d['io'],
        'row_and_block_carry': d['nofill'] - d['mxu_only'],
        'fill_forward': d['full'] - d['nofill'],
        'per_shiftmax_pass': (d['fill7'] - d['fill1']) / 6},
        tpu_names={'io': 'dma_io', 'in_row_scan': 'mxu_triangles',
                   'row_and_block_carry': 'carry_selects'},
        full_turns={f'full_all_{key}': turns['full'],
                    f'k3_mask_all_{key}': turns['k3_mask']},
        **{f'full_{key}': _timing.median(turns['full']),
           f'k3_mask_{key}': _timing.median(turns['k3_mask'])},
        full_vs_k3_mask_eps_of_prefix=vs_k3,
        bytes_bound_ms=9 * N / PEAK_BYTES * 1e3)
    return results


if __name__ == '__main__':
    main()
