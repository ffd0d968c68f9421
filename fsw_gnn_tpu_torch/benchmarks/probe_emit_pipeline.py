"""Probe P4: K2f with its next row's loads staged while a row ranks,
against K2f as it stands.

Counterpart of benchmarks/probe_emit_pipeline.py, which runs the TPU rank
forward with the implicit grid pipeline (`fwd_implicit`) against explicit
double-buffered copies (`fwd_emit`).  On the card the implicit case is
K2f (`fsw_rank_aggregate`, uniform_w off, no weight gradient) and the
explicit one kernel `csrc/probe_stage.cu`: each block walks rows of one
slice tile, the next row's projections and weights in flight by
`cp.async` into the second of two buffers while the current row ranks.
Both compute the same function with the same bits (the staged kernel
keeps K2f's rule for padded entries and its rank loop); outputs that
differ in a bit raise after the first line.  They are timed
in turns in one process (A B B A a rep).

    python -m fsw_gnn_tpu_torch.benchmarks.probe_emit_pipeline [--device cpu]

Knobs (the TPU probe's, with its defaults): BRK_R 8192, BRK_B 32,
BRK_S 128 (a multiple of 4), BRK_STEPS 60 (calls a timing window),
BRK_REPS 5.

`fsw_rank_aggregate_staged` runs the staged kernel on CUDA tensors (each
launch adding one to `fsw_rank_aggregate_staged.launches`) and K2's plain
version on CPU tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..ops.fsw_rank import (_MAX_SMEM, _check, _count, _kernel, _launch,
                            fsw_rank_aggregate, fsw_rank_aggregate_plain)
from . import _timing

R = int(os.environ.get('BRK_R', 8192))
B = int(os.environ.get('BRK_B', 32))
S = int(os.environ.get('BRK_S', 128))
STEPS = int(os.environ.get('BRK_STEPS', 60))
REPS = int(os.environ.get('BRK_REPS', 5))


def stage_smem_bytes(B: int) -> int:
    """Shared memory of one block of the staged kernel at width B: two
    buffers of a row (`probe_stage_smem_bytes`)."""
    return 8 * (64 * B + -(-B // 4) * 4)


def fsw_rank_aggregate_staged(P, wn, pad_norm, freqs,
                              uniform_w: bool = False):
    """K2's forward, out (R, S), by the staged kernel on CUDA tensors
    (float32, contiguous, S a multiple of 4, P 16-byte aligned; each launch
    adding one to `fsw_rank_aggregate_staged.launches`), by K2's plain
    version on CPU tensors.  A width whose two rows do not fit a block's
    shared memory raises KernelError before the launch."""
    if P.device.type == 'cpu':
        return fsw_rank_aggregate_plain(P, wn, pad_norm, freqs, uniform_w)
    Rr, Bb, Ss = P.shape
    _check(list(zip(('P', 'wn', 'pad_norm', 'freqs'),
                    (P, wn, pad_norm, freqs))),
           {'wn': (Rr, Bb), 'pad_norm': (Rr,), 'freqs': (Ss,)})
    if Ss % 4 or P.data_ptr() % 16:
        raise kernels.KernelError('P4: S must be a multiple of 4 and P '
                                  '16-byte aligned')
    if stage_smem_bytes(Bb) > _MAX_SMEM:
        raise kernels.KernelError(f'P4: bucket width {Bb} needs '
                                  f'{stage_smem_bytes(Bb)} bytes of shared '
                                  f'memory, above the {_MAX_SMEM} a block has')
    out = torch.empty((Rr, Ss), dtype=torch.float32, device=P.device)
    if Rr == 0 or Ss == 0:
        return out
    if Bb == 0:
        return out.zero_()
    _launch('probe_stage', _kernel('probe_stage')[0], P, wn, pad_norm, freqs,
            out, Rr, Bb, Ss, int(bool(uniform_w)))
    _count(fsw_rank_aggregate_staged)
    return out


fsw_rank_aggregate_staged.launches = 0


def inputs(dev, R=R, B=B, S=S, seed: int = 0):
    """The TPU probe's inputs: P normal, weights |normal| normalized by
    max(total, 1), the phantom mass, frequencies |normal| + 0.1."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((R, B, S)).astype(np.float32)
    w = np.abs(rng.standard_normal((R, B))).astype(np.float32)
    w_sum = w.sum(1)
    wn = w / np.maximum(w_sum, 1.0)[:, None]
    pad = np.maximum(1.0 - w_sum, 0.0) / np.maximum(w_sum, 1.0)
    freqs = (np.abs(rng.standard_normal(S)) + 0.1).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (P, wn, pad, freqs))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_emit_pipeline')
    args = inputs(dev)
    implicit = fsw_rank_aggregate(*args, with_dw=False)
    emit = fsw_rank_aggregate_staged(*args)
    diff = float((implicit - emit).abs().max())
    _timing.emit(dev, R=R, B=B, S=S, bit_equal=bool(torch.equal(implicit,
                                                                 emit)),
                 max_abs_diff=diff,
                 rel_err=diff / (float(implicit.abs().max()) or 1.0))
    if not torch.equal(implicit, emit):
        raise RuntimeError('P4: the staged forward is not K2f bit for bit')
    times = _timing.aba_ms(
        {'implicit': lambda: fsw_rank_aggregate(*args, with_dw=False),
         'emit': lambda: fsw_rank_aggregate_staged(*args)}, dev,
        iters=STEPS, reps=REPS)
    key = _timing.time_key(dev)
    for name, ts in times.items():
        _timing.emit(dev, case=name, **{key: _timing.median(ts)},
                     **{f'all_{key}': ts})
    return times


if __name__ == '__main__':
    main()
