"""Probe P4: K2f with its rows' loads staged ahead while a row ranks,
against K2f as it stands.

Counterpart of benchmarks/probe_emit_pipeline.py, which runs the TPU rank
forward with the implicit grid pipeline (`fwd_implicit`) against explicit
double-buffered copies (`fwd_emit`).  On the card the implicit case is
K2f (`fsw_rank_aggregate`, uniform_w off, no weight gradient) and the
explicit one kernel `csrc/probe_stage.cu`: at B <= REGS_W (32) persistent
blocks walk rows through a ring of three stages filled by the copy engine
(a block covering a row's slices and one `cp.async.bulk` of the row's
B x S block where S <= 128, a tensor map's tiles of 64 slices
otherwise), one thread issuing the copies and an `mbarrier` a stage
reporting them, and rank on the register loop of `csrc/rank_regs.cuh`,
K2f's quadrature after it; wider rows keep the
previous design (each block walks rows of one 64-slice tile, the next
row's projections and weights in flight by 16-byte `cp.async` copies
into the second of two buffers, K2f's shared-memory rank loop).
`stage_loop` mirrors the library's choice, which each launch counts in
`fsw_rank_aggregate_staged.loops`.  Both compute the same function with
the same bits (the staged kernel keeps K2f's rule for padded entries and
its rank sums); outputs that differ in a bit raise after the first line.
They are timed in turns in one process (A B B A a rep), beside the
bytes bound K2f is held to and the pair loop's issue floor
(`pair_floor_ms`: R B B S pairs at two issue slots each).

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
from ..utils.bounds import issue_floor_ms, rank2_bound_ms
from . import _timing

R = int(os.environ.get('BRK_R', 8192))
B = int(os.environ.get('BRK_B', 32))
S = int(os.environ.get('BRK_S', 128))
STEPS = int(os.environ.get('BRK_STEPS', 60))
REPS = int(os.environ.get('BRK_REPS', 5))


REGS_W = 32                  # csrc/rank_regs.cuh's W
# the register path's most slices a block (a whole row), a tensor map's
# tile of slices, and its ring's stages
TSB, TILE, STAGES = 128, 64, 3
# `probe_stage_loop`'s codes: the shared-memory loop on cp.async rows, the
# register loop on one bulk copy a row, or on a tensor map's tiles
LOOPS = ('shared', 'registers_bulk', 'registers_tensor_map')


def stage_loop(B: int, S: int) -> str:
    """The loop and staging the library takes at width B and S slices
    (mirrors `probe_stage_loop`)."""
    return LOOPS[0 if B > REGS_W else (1 if S <= TSB else 2)]


def stage_smem_bytes(B: int, S: int) -> int:
    """Shared memory of one block of the staged kernel at width B and S
    slices (`probe_stage_smem_bytes`): up to REGS_W, the ring of STAGES
    rows, each a B x cols block of projections (cols = S up to TSB, else
    a tensor map's TILE) and the weights, a multiple of 128 bytes; the
    ranks, REGS_W x TSB (REGS_W x TILE by a tensor map); the 128 bytes
    that align the ring and two barriers a stage; wider, two buffers of a
    row."""
    if B <= REGS_W:
        cols = S if S <= TSB else TILE
        stage = -(-(B * cols + -(-B // 4) * 4) // 32) * 32
        ranks = REGS_W * (TSB if S <= TSB else TILE)
        return 128 + 4 * (STAGES * stage + ranks) + 16 * STAGES
    return 8 * (64 * B + -(-B // 4) * 4)


def pair_floor_ms(R: int, B: int, S: int) -> float:
    """The register loop's floor in ms: R B B S pairs at two issue slots
    each (a compare and a fused multiply-add), at the FFMA issue rate."""
    return issue_floor_ms(R * B * B * S, 2)


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
    if stage_smem_bytes(Bb, Ss) > _MAX_SMEM:
        raise kernels.KernelError(f'P4: bucket width {Bb} needs '
                                  f'{stage_smem_bytes(Bb, Ss)} bytes of '
                                  f'shared memory, above the {_MAX_SMEM} a '
                                  f'block has')
    out = torch.empty((Rr, Ss), dtype=torch.float32, device=P.device)
    if Rr == 0 or Ss == 0:
        return out
    if Bb == 0:
        return out.zero_()
    fn, aux = _kernel('probe_stage')
    _launch('probe_stage', fn, P, wn, pad_norm, freqs, out, Rr, Bb, Ss,
            int(bool(uniform_w)))
    _count(fsw_rank_aggregate_staged, LOOPS[aux['loop'](Bb, Ss)])
    return out


fsw_rank_aggregate_staged.launches = 0
fsw_rank_aggregate_staged.loops = {}


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
                 rel_err=diff / (float(implicit.abs().max()) or 1.0),
                 loop=stage_loop(B, S),
                 bytes_bound_ms=rank2_bound_ms(args[1], S)[0],
                 pair_floor_ms=pair_floor_ms(R, B, S))
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
