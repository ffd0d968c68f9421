"""Probe P3: the segmented cumsum with its segment ends given three ways:
by ids, by an int8 mask, and packed into the value's sign bit.

Counterpart of benchmarks/probe_segcumsum_fill.py, whose `mask_kernel`
computes the segmented cumsum of values >= 0 with the ends read from an
int8 is_end mask or, packed, from the sign bit of the value itself (the
last element of each segment stored negated, a 0 there as -0.0; the
kernel scans |value|): 12, 9 and 8 bytes an element with ids, mask and
packed.  On the card all three are K3 (csrc/segcumsum.cu): its ids and
mask forms, and its packed form (`segcumsum_packed_f32`, the same kernel
with the flag read from the sign bit of the loaded word), which no route
takes.  The TPU probe's `ids(default)`, `ids(highest)` and `ids(scan)`
choose the MXU's precision and the TPU kernel's method; each is K3's ids
form here, one measurement, and their lines say so.

The script runs the probe's correctness block (ids, mask8 and packed
against a float64 oracle, within 1e-4 of max(1, |oracle|), as the probe
asserts; packed must also be the mask form's bits, since the flags are the
same and K3's bits are deterministic), raising after its line where one
fails, then times ids, mask and packed in turns (ids, mask, packed,
packed, mask, ids a rep).

    python -m fsw_gnn_tpu_torch.benchmarks.probe_segcumsum_fill [--device cpu]

Knobs (the TPU probe's, with its defaults): SEG_N 2^24, SEG_AVG 256
(segment lengths geometric of that mean), SEG_MAX 2048 (their cap, passed
to K3 as `max_seg_size`, which it accepts and does not need), SEG_ROWS 1024
(the TPU's tile; K3's is 4096 elements), SEG_ITERS 20, SEG_INTERPRET=1
(correctness only, as the TPU probe's interpret mode).

`segcumsum_packed` runs K3's packed form on CUDA tensors (each call adding
one to `segcumsum_packed.launches`) and its plain version (`unpack`, then
K3's plain version with the mask) on CPU tensors.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import kernels
from ..ops.fsw_rank import _count
from ..ops.segcumsum import (_kernel, _workspace, segcumsum,
                             segcumsum_plain)
from . import _timing

N = int(os.environ.get('SEG_N', 1 << 24))
AVG_SEG = int(os.environ.get('SEG_AVG', 256))
MAX_SEG = int(os.environ.get('SEG_MAX', 2048))
ROWS = int(os.environ.get('SEG_ROWS', 1024))
ITERS = int(os.environ.get('SEG_ITERS', 20))
INTERP = os.environ.get('SEG_INTERPRET') == '1'

TOL_REL = 1e-4
PEAK_BYTES = 3.35e12
BYTES = {'ids': 12, 'mask8': 9, 'packed': 8}
_FN = {}


def pack(values, boundaries):
    """values >= 0 (n,) with the ends of `boundaries` (n,) in their sign
    bits: the last element of each segment negated (-0.0 for a 0)."""
    return torch.where(boundaries.bool(), -values, values)


def unpack(packed):
    """(|packed|, the int8 is_end mask of its sign bits)."""
    return packed.abs(), torch.signbit(packed).to(torch.int8)


def segcumsum_packed_plain(packed, max_seg_size=None):
    """K3's plain version on the unpacked values and mask."""
    v, m = unpack(packed)
    return segcumsum_plain(v, boundaries=m, max_seg_size=max_seg_size)


def _packed_fn():
    if not _FN:
        fn = kernels.load('segcumsum').segcumsum_packed_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN['packed'] = fn
    return _FN['packed']


def segcumsum_packed(packed):
    """The segmented inclusive cumsum of |packed| (n,) float32 over the ends
    in its sign bits: K3's packed form on a CUDA tensor (contiguous; each
    call adding one to `segcumsum_packed.launches`), the plain version on a
    CPU tensor."""
    if packed.dim() != 1:
        raise ValueError(f'packed must be flat, got {tuple(packed.shape)}')
    if packed.device.type == 'cpu':
        return segcumsum_packed_plain(packed)
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise TypeError(f'packed must be contiguous float32, got '
                        f'{packed.dtype}')
    out = torch.empty_like(packed)
    n = packed.shape[0]
    if n == 0:
        return out
    fns, fn = _kernel(), _packed_fn()
    dev = packed.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, cap = _workspace(dev, stream, fns['tiles'](1, n), fns['ws'])
        rc = fn(packed.data_ptr(), out.data_ptr(), ws.data_ptr(), cap, 1, n,
                stream)
    if rc != 0:
        raise kernels.KernelError(f'segcumsum_packed launch failed: CUDA '
                                  f'error {rc}')
    _count(segcumsum_packed)
    return out


segcumsum_packed.launches = 0


def inputs(dev, n=N, avg=AVG_SEG, cap=MAX_SEG, seed=0):
    """The TPU probe's data: (values |normal|, sorted ids of segments of
    geometric lengths capped at `cap`, the is_end mask, the packed values,
    the float64 oracle), the tensors on `dev`."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.geometric(1.0 / avg, n // 8) + 1, cap)
    seg_ids = np.repeat(np.arange(lens.size), lens)[:n].astype(np.int32)
    if seg_ids.size < n:
        extra = np.arange(seg_ids[-1] + 1, seg_ids[-1] + 1 + n - seg_ids.size)
        seg_ids = np.concatenate([seg_ids, extra.astype(np.int32)])
    vals = np.abs(rng.standard_normal(n)).astype(np.float32)
    is_end = np.empty(n, np.bool_)
    is_end[:-1] = seg_ids[1:] != seg_ids[:-1]
    is_end[-1] = True
    cs = np.cumsum(vals.astype(np.float64))
    starts = np.zeros(n, np.int64)
    starts[1:] = np.where(seg_ids[1:] != seg_ids[:-1], np.arange(1, n), 0)
    np.maximum.accumulate(starts, out=starts)
    want = cs - np.where(starts > 0, cs[starts - 1], 0.0)
    v = torch.from_numpy(vals).to(dev)
    m = torch.from_numpy(is_end.astype(np.int8)).to(dev)
    return (v, torch.from_numpy(seg_ids).to(dev), m, pack(v, m),
            torch.from_numpy(want).to(dev))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_segcumsum_fill')
    v, s, m, p, want = inputs(dev)
    _timing.emit(dev, n=N, avg_seg=AVG_SEG, max_seg=MAX_SEG, rows=ROWS,
                 k3_tile=4096)
    fns = {'ids': lambda: segcumsum(v, s, max_seg_size=MAX_SEG),
           'mask8': lambda: segcumsum(v, boundaries=m),
           'packed': lambda: segcumsum_packed(p)}
    outs = {name: fn() for name, fn in fns.items()}
    scale = want.abs().clamp(min=1.0)
    for name, got in outs.items():
        err = float(((got.double() - want).abs() / scale).max())
        _timing.emit(dev, variant=name, max_rel_err=err, ok=err < TOL_REL)
        if not err < TOL_REL:
            raise RuntimeError(f'P3 {name}: {err:.3e} of max(1, |oracle|) '
                               f'from float64, not below {TOL_REL}')
    same = bool(torch.equal(outs['packed'], outs['mask8']))
    _timing.emit(dev, packed_is_mask_bits=same)
    if not same:
        raise RuntimeError('P3: the packed form is not the mask form bit '
                           'for bit')
    _timing.emit(dev, variant='ids(default-precision)',
                 note="no MXU precision on the card: K3's ids form, as ids")
    if INTERP:
        _timing.emit(dev, note='SEG_INTERPRET=1: correctness only')
        return None
    times = _timing.aba_ms(fns, dev, iters=ITERS)
    key = _timing.time_key(dev)
    lines = [('ids(default)', 'ids'), ('ids(highest)', 'ids'),
             ('ids(scan)', 'ids'), ('mask8', 'mask8'), ('packed', 'packed')]
    for label, name in lines:
        ms = _timing.median(times[name])
        fields = {'variant': label, key: ms, f'all_{key}': times[name],
                  'bytes_per_el': BYTES[name]}
        if name == 'ids':
            fields['same_as'] = ("K3's ids form (one measurement for the "
                                 "three: the TPU's precision and method "
                                 "have no counterpart)")
        if dev.type == 'cuda':
            gbs = N * BYTES[name] / ms / 1e6
            fields.update(GBps=gbs, of_peak_bytes=gbs * 1e9 / PEAK_BYTES)
        _timing.emit(dev, **fields)
    return times


if __name__ == '__main__':
    main()
