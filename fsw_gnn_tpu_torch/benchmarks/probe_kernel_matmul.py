"""Probe P1: K1's three in-kernel contractions, each alone, on two
tensor-core tile routines.

Counterpart of benchmarks/probe_kernel_matmul.py, whose five kernels
(`k_fwd`, `k_dxr`, `k_dv`, `k_dv_loop`, `k_flat`) ask which contractions
lower inside a Pallas kernel:

    fwd      P   = Xr (TR, B, D) . V (D, S)            K1f's projection
    dxr      dXr = dP (TR, B, S) . V^T                 K1b's dZ
    dv       dV  = Xr^T dP, contracting (TR, B)        K1b's dV
    dv_loop  dV as a loop over B of (D, TR)(TR, S)
    flat     fwd on Xr reshaped to (TR B, D)

Each is an entry of csrc/probe_matmul.cu on one of two 3xTF32 routines
(`ROUTINES`): 'wgmma' (the default; csrc/tf32x3_wgmma.cuh: `wgmma` on
TF32, TMA or cp.async staging four chunks ahead, the hi/lo split once a
staged chunk) and 'k1', K1's own tile routine `tile_product`
(fsw_rank_common.cuh: `mma.sync` tiles), unchanged, so its times price
the routine K1 runs.  For every contraction, shape and routine it prints
the max abs error against a float64 einsum of the same inputs (and its
share of the result's scale), the ms and TFLOP/s (2 M N K / time), and
`torch.matmul`'s ms on the same operands with TF32 off and on: the library
yardstick, which the port never calls for these.  An error above TOL_REL of
the result's scale raises after its line.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_kernel_matmul [--device cpu]

Shapes: the TPU probe's own (TR 16, B 32, D 64, S 128), K1's at the
headline (TR 8192, B 16, D 64, S 127) and at Cora's layer 0 (the class of
2712 rows of width 8, D 1433, S 2865).  The TPU probe has no knobs; with
`--device cpu` only the probe's own shape runs, on the plain versions.

`kernel_matmul(kind, a, b, routine='wgmma')` runs a contraction's kernel
on CUDA tensors (each call adding one to `kernel_matmul.launches`) and its
plain version, `torch.einsum` in the input dtype (`kernel_matmul_plain`),
on CPU tensors, whichever the routine; an unknown routine raises.
"""
from __future__ import annotations


import numpy as np
import torch

from ..ops.fsw_rank import _check, _count, _kernel, _launch
from ..utils.bounds import PEAK_BYTES, PEAK_TF32_OPS
from . import _timing

KINDS = ('fwd', 'dxr', 'dv', 'dv_loop', 'flat')
ROUTINES = ('wgmma', 'k1')
TOL_REL = 1e-5        # max abs error against float64 / max |float64|
# (name, TR, B, D, S)
SHAPES = (('probe', 16, 32, 64, 128), ('headline', 8192, 16, 64, 127),
          ('cora_layer0', 2712, 8, 1433, 2865))
# the contraction codes of `probe_matmul_wgmma_f32`
KINDS_C = {'fwd': 0, 'flat': 1, 'dxr': 2, 'dv': 3, 'dv_loop': 4}
# (operand names, einsum) of each contraction
SPEC = {'fwd': (('Z', 'V'), 'rbd,ds->rbs'),
        'dxr': (('dP', 'V'), 'rbs,ds->rbd'),
        'dv': (('Z', 'dP'), 'rbd,rbs->ds'),
        'dv_loop': (('Z', 'dP'), 'rbd,rbs->ds'),
        'flat': (('Z', 'V'), 'rbd,ds->rbs')}


# csrc/probe_matmul.cu's split of the dv contractions' depth (routine
# 'wgmma'): enough ranges for WG_UNIT_TARGET units, at least
# WG_MIN_RANGE_CHUNKS chunks of WG_KC a range
WG_KC, WG_TILE, WG_UNIT_TARGET, WG_MIN_RANGE_CHUNKS = 32, 128, 4 * 132, 16


def wgmma_dv_split(K: int, units0: int):
    """(chunk, splits) of depth K for `units0` units before splitting
    (`dv_split` in csrc/probe_matmul.cu): it depends on the shape alone,
    so the bits do too."""
    nkc = -(-K // WG_KC)
    want = max(-(-WG_UNIT_TARGET // units0), 1)
    per = max(-(-nkc // want), WG_MIN_RANGE_CHUNKS)
    if per > nkc:
        per = max(nkc, 1)
    chunk = per * WG_KC
    return chunk, (-(-K // chunk) if K > 0 else 1)


def wgmma_parts(kind: str, TR: int, B: int, D: int, S: int) -> int:
    """Partials (each D x S) that routine 'wgmma' sums for dv (the ranges
    of TR B) and dv_loop (B groups of the ranges of TR); 0 otherwise."""
    if kind not in ('dv', 'dv_loop'):
        return 0
    tiles = -(-D // WG_TILE) * -(-S // WG_TILE)
    groups = B if kind == 'dv_loop' else 1
    K = TR if kind == 'dv_loop' else TR * B
    return groups * wgmma_dv_split(K, tiles * groups)[1]


def kernel_matmul_plain(kind: str, a, b):
    """The contraction `kind` in PyTorch, in the inputs' dtype: the TPU
    probe's `expect` of it (dv_loop as its loop over B)."""
    if kind == 'dv_loop':
        out = None
        for j in range(a.shape[1]):
            term = a[:, j, :].t() @ b[:, j, :]
            out = term if out is None else out + term
        return out
    if kind == 'flat':
        TR, B, D = a.shape
        return (a.reshape(TR * B, D) @ b).reshape(TR, B, -1)
    return torch.einsum(SPEC[kind][1], a, b)


def _pad_rows(x):
    """x copied into rows of a multiple of 4 floats (16 bytes), or x itself
    where its last axis is one.  The padding is left unwritten: the
    kernel's tensor maps end at the true extent and read zeros past it."""
    n = x.shape[-1]
    if n % 4 == 0:
        return x
    out = torch.empty((*x.shape[:-1], n + (-n % 4)), dtype=x.dtype,
                      device=x.device)
    out[..., :n].copy_(x)
    return out


def pads_operand(kind: str, name: str, TR: int, B: int, D: int,
                 S: int) -> bool:
    """Whether routine 'wgmma' pads operand `name` (of SPEC[kind]) by
    default, where its last axis is not a multiple of 4: where the
    contraction's products take longer than its bytes on the card (the
    3xTF32 tensor rate against HBM's), so the kernel, not the copy, is what
    costs; or where the operand is at most a sixteenth of the call's bytes
    (K1's V at the headline).  Otherwise its unaligned rows go by
    cp.async, whose copies cost less than a padded copy of a large
    operand."""
    M = TR * B
    nbytes = 4.0 * (M * D + D * S + M * S)
    if 3 * 2.0 * M * D * S / PEAK_TF32_OPS > nbytes / PEAK_BYTES:
        return True
    size = {'Z': M * D, 'V': D * S, 'dP': M * S}[name]
    return 4.0 * size <= nbytes / 16


def kernel_matmul(kind: str, a, b, routine: str = 'wgmma', pad=None):
    """Contraction `kind` of a and b, shaped as `SPEC` names them (Z
    (TR, B, D), V (D, S), dP (TR, B, S)), on tile routine `routine` (one of
    ROUTINES).  CPU tensors: the plain version.  CUDA tensors: the kernel
    (float32, contiguous), each call adding one to
    `kernel_matmul.launches`.  Routine 'wgmma' stages operands by TMA,
    which wants rows 16-byte aligned: with `pad` an operand whose last
    axis is not a multiple of 4 is first copied into one that is (inside
    the call); without, the kernel stages it by cp.async; None (the
    default) pads each operand where `pads_operand` says."""
    if kind not in KINDS:
        raise ValueError(f'unknown contraction {kind!r}')
    if routine not in ROUTINES:
        raise ValueError(f'unknown tile routine {routine!r}: one of '
                         f'{ROUTINES}')
    if a.device.type == 'cpu':
        return kernel_matmul_plain(kind, a, b)
    TR, B = a.shape[:2]
    names = SPEC[kind][0]
    D = a.shape[2] if names[0] == 'Z' else b.shape[0]
    S = b.shape[-1] if kind != 'dxr' else a.shape[2]
    want = {'Z': (TR, B, D), 'V': (D, S), 'dP': (TR, B, S)}
    _check(list(zip(names, (a, b))), want)
    f32 = dict(dtype=torch.float32, device=a.device)
    fns = _kernel('probe_matmul')[1]
    shape = (TR, B, D) if kind == 'dxr' else (
        (D, S) if kind in ('dv', 'dv_loop') else (TR, B, S))
    out = torch.empty(shape, **f32)
    if routine == 'wgmma':
        code = KINDS_C[kind]
        ws = torch.empty((fns['wgmma_parts'](code, TR, B, D, S), D, S),
                         **f32)
        a, b = (_pad_rows(x) if (pads_operand(kind, n, TR, B, D, S)
                                 if pad is None else pad) else x
                for n, x in zip(names, (a, b)))
        # the kernel reads 16-byte groups from each operand's base on
        a, b = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))
        _launch('probe_matmul', fns['wgmma_f32'], code, a, b, out, ws, TR,
                B, D, S, a.shape[-1], b.shape[-1])
        _count(kernel_matmul)
        return out
    fn = fns[f'{kind}_f32']
    M = TR * B
    if kind in ('fwd', 'flat'):
        dims = (TR, B, D, S) if kind == 'fwd' else (M, D, S)
        _launch('probe_matmul', fn, a, b, out, *dims)
    elif kind == 'dxr':
        _launch('probe_matmul', fn, a, b, out, M, D, S)
    elif kind == 'dv':
        ws = torch.empty((fns['dv_parts'](M), D, S), **f32)
        _launch('probe_matmul', fn, a, b, out, ws, M, D, S)
    else:
        ws = torch.empty((B, D, S), **f32)
        _launch('probe_matmul', fn, a, b, out, ws, TR, B, D, S)
    _count(kernel_matmul)
    return out


kernel_matmul.launches = 0


def operands(shape, dev, seed: int = 0):
    """{'Z', 'V', 'dP'} of one shape, normal float32 from numpy."""
    _, TR, B, D, S = shape
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev) for k, s in (('Z', (TR, B, D)), ('V', (D, S)),
                          ('dP', (TR, B, S)))}


def matmul_operands(kind, x):
    """The two matrices `torch.matmul` multiplies for contraction `kind`."""
    Z, V, dP = x['Z'], x['V'], x['dP']
    TR, B = Z.shape[:2]
    if kind in ('fwd', 'flat'):
        return Z.reshape(TR * B, -1), V
    if kind == 'dxr':
        return dP.reshape(TR * B, -1), V.t()
    return Z.reshape(TR * B, -1).t(), dP.reshape(TR * B, -1)


def flops(kind, shape) -> float:
    _, TR, B, D, S = shape
    return 2.0 * TR * B * D * S


def check(kind, x, routine: str = 'wgmma'):
    """(max abs error, its share of max |reference|) of the contraction
    on `routine` against float64 einsum of the same inputs."""
    a, b = (x[n] for n in SPEC[kind][0])
    got = kernel_matmul(kind, a, b, routine)
    want = torch.einsum(SPEC[kind][1], a.double(), b.double())
    err = float((got.double() - want).abs().max())
    return err, err / (float(want.abs().max()) or 1.0)


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_kernel_matmul')
    key = _timing.time_key(dev)
    shapes = SHAPES if dev.type == 'cuda' else SHAPES[:1]
    out = []
    for shape in shapes:
        x = operands(shape, dev)
        for kind in KINDS:
            a, b = (x[n] for n in SPEC[kind][0])
            mm = {}
            if dev.type == 'cuda':
                ma, mb = matmul_operands(kind, x)
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    mm[tf32] = _timing.median_ms(lambda: torch.matmul(ma, mb),
                                                 dev, iters=10)
                torch.backends.cuda.matmul.allow_tf32 = False
            for routine in ROUTINES:
                err, rel = check(kind, x, routine)
                ms = _timing.median_ms(
                    lambda: kernel_matmul(kind, a, b, routine), dev,
                    iters=10 if shape[3] > 256 else 20)
                fields = {'shape': shape[0], 'TR': shape[1], 'B': shape[2],
                          'D': shape[3], 'S': shape[4], 'contraction': kind,
                          'routine': routine, 'max_abs_err_vs_f64': err,
                          'max_rel_err_vs_f64': rel, key: ms}
                if dev.type == 'cuda':
                    fields.update(
                        tflops=flops(kind, shape) / (ms * 1e-3) / 1e12,
                        matmul_f32_ms=mm[False], matmul_tf32_ms=mm[True])
                _timing.emit(dev, **fields)
                if not rel <= TOL_REL:
                    raise RuntimeError(
                        f'P1 {kind} ({routine}) at the {shape[0]} shape: '
                        f'{rel:.3e} of the scale from float64, above '
                        f'{TOL_REL}')
                out.append(fields)
        del x
    return out


if __name__ == '__main__':
    main()
