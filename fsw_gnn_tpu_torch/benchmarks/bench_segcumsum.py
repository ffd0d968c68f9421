"""Microbenchmark: the segmented cumsum K3 against the cumsum-minus-base
formulation, and its bytes' bound.

Counterpart of benchmarks/bench_segcumsum.py.  Its XLA control is
`ops.segment.segment_cumsum(v, s, method='global')` here (one cumsum minus
each segment's prefix at its start: the same formulation, its error eps
times the global prefix).  Its Pallas variants map to K3
(csrc/segcumsum.cu):

  scan, scan_capped          K3's ids form (`max_seg_size` is accepted and,
                             as K3's header says, not needed)
  mask                       K3's mask form on |v| (the mask made outside the
                             timed region, as the TPU script does)
  matmul, matmul_capped,     the TPU's MXU formulation has no counterpart on
  matmul_nonneg              the card; the line names P2's `full` stage
                             (probe_fill_floor), that formulation's port,
                             and times nothing (matmul_nonneg takes |v| for
                             what follows, as the TPU script does)

Each K3 output is checked against K3 in float64 on the same data: within
8 float32 eps of each element's segment prefix of |v| (both restart at
every segment); outside it raises after its line.  GB/s counts 12 bytes an
element (values and ids read, output written), as the TPU script.  The last
line is the max disagreement between the control and the last kernel run,
relative to the kernel's max |out| (the control recomputed on the kernel's
input where a variant took |v|).

    python -m fsw_gnn_tpu_torch.benchmarks.bench_segcumsum [--device cpu]

Knobs (the TPU script's, with its defaults): FSW_SEGBENCH_N 2^24,
FSW_SEGBENCH_SEG 32, FSW_SEGBENCH_ITERS 20, FSW_SEGBENCH_SKIP_XLA (1 skips
the control), FSW_SEGBENCH_VARIANTS 'scan,scan_capped',
FSW_SEGBENCH_ROWS and FSW_SEGBENCH_PRECISION (reported as not applicable:
K3's tile is fixed at 4096 elements and it sums in float32 adds).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.segcumsum import segcumsum, segment_boundaries
from ..ops.segment import segment_cumsum
from . import _timing

N = int(os.environ.get('FSW_SEGBENCH_N', 1 << 24))
AVG_SEG = int(os.environ.get('FSW_SEGBENCH_SEG', 32))
ITERS = int(os.environ.get('FSW_SEGBENCH_ITERS', 20))
SKIP_XLA = os.environ.get('FSW_SEGBENCH_SKIP_XLA') == '1'
ROWS = os.environ.get('FSW_SEGBENCH_ROWS', '1024')
VARIANTS = os.environ.get('FSW_SEGBENCH_VARIANTS', 'scan,scan_capped').split(
    ',')
PRECISION = os.environ.get('FSW_SEGBENCH_PRECISION', 'highest')
K3_ULPS = 8


def ulps_of_prefix(got, v, ids=None, boundaries=None):
    """max |got - ref| / (eps32 x prefix), ref K3 in float64 of v and prefix
    that of |v|."""
    ref = segcumsum(v.double(), ids, boundaries=boundaries)
    prefix = segcumsum(v.abs().double(), ids, boundaries=boundaries)
    eps = torch.finfo(torch.float32).eps
    return float(((got.double() - ref).abs()
                  / (eps * prefix).clamp(min=1e-300)).max())


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'bench_segcumsum')
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, max(N // AVG_SEG, 1), N)).astype(np.int32)
    vals = rng.standard_normal(N).astype(np.float32)
    v = torch.from_numpy(vals).to(dev)
    s = torch.from_numpy(ids).to(dev)
    key = _timing.time_key(dev)

    def timed(fn, name, x, **fields):
        ms = _timing.median_ms(lambda: fn(x, s), dev, iters=ITERS)
        line = {'kernel': name, 'n': N, key: ms, **fields}
        if dev.type == 'cuda':
            line['GB_s'] = 12 * N / ms / 1e6
        _timing.emit(dev, **line)
        return fn(x, s)

    def k3(fn, name, x, **kw):
        out = timed(fn, name, x, runs="K3's " + ('mask' if 'boundaries' in kw
                                                 else 'ids') + ' form')
        ulps = ulps_of_prefix(out, x, None if 'boundaries' in kw else s, **kw)
        _timing.emit(dev, kernel=name, max_ulps_of_prefix_vs_f64=ulps)
        if not ulps <= K3_ULPS:
            raise RuntimeError(f'{name}: {ulps:.2f} eps of the segment '
                               f'prefix from float64, above {K3_ULPS}')
        return out

    def control(x):
        return segment_cumsum(x, s, method='global')

    out_x = x_of_control = None
    if not SKIP_XLA:
        out_x = timed(lambda x, s: control(x), 'cumsum_minus_base', v,
                      counterpart="the TPU script's xla_cumsum_minus_base")
        x_of_control = v
    _timing.emit(dev, rows=ROWS, precision=PRECISION,
                 note="not applicable: K3's tile is fixed at 4096 elements "
                      'and it sums in float32 adds')
    max_seg = int(np.max(np.bincount(ids)))
    _timing.emit(dev, max_seg_size=max_seg)
    out_p, x_of_p = None, v
    for name in VARIANTS:
        if name == 'scan':
            out_p = k3(lambda x, s: segcumsum(x, s), 'segscan', v)
        elif name == 'scan_capped':
            out_p = k3(lambda x, s: segcumsum(x, s, max_seg_size=max_seg),
                       'segscan_capped', v)
        elif name.startswith('matmul'):
            _timing.emit(dev, kernel=name, timed=False,
                         counterpart='P2 full: python -m fsw_gnn_tpu_torch.'
                                     'benchmarks.probe_fill_floor')
            if name == 'matmul_nonneg':
                v = v.abs()
                if not SKIP_XLA:
                    out_x = timed(lambda x, s: control(x),
                                  'cumsum_minus_base_nonneg', v)
                    x_of_control = v
        elif name == 'mask':
            v = v.abs()
            m = segment_boundaries(s)
            out_p = k3(lambda x, s: segcumsum(x, boundaries=m), 'mask', v,
                       boundaries=m)
        else:                  # the knob is P5's too: its loops' names
            _timing.emit(dev, kernel=name, skipped='not a variant here')
        if name in ('scan', 'scan_capped', 'mask'):
            x_of_p = v
    if out_p is None:
        out_p = segcumsum(x_of_p, s)
    if out_x is None or x_of_control is not x_of_p:
        out_x = control(x_of_p)
    err = float((out_x - out_p).abs().max()) / (
        1e-6 + float(out_p.abs().max()))
    _timing.emit(dev, max_rel_disagreement=err)
    return err


if __name__ == '__main__':
    main()
