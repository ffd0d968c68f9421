"""Probe P1: K1's three in-kernel contractions, each alone, on K1's own
tensor-core tile routine.

Counterpart of benchmarks/probe_kernel_matmul.py, whose five kernels
(`k_fwd`, `k_dxr`, `k_dv`, `k_dv_loop`, `k_flat`) ask which contractions
lower inside a Pallas kernel:

    fwd      P   = Xr (TR, B, D) . V (D, S)            K1f's projection
    dxr      dXr = dP (TR, B, S) . V^T                 K1b's dZ
    dv       dV  = Xr^T dP, contracting (TR, B)        K1b's dV
    dv_loop  dV as a loop over B of (D, TR)(TR, S)
    flat     fwd on Xr reshaped to (TR B, D)

Here each is an entry of csrc/probe_matmul.cu over `tile_product`
(fsw_rank_common.cuh: 3xTF32 `mma.sync` tiles), the routine K1 runs, so
the times price it alone.  For every contraction and shape it prints the
max abs error against a float64 einsum of the same inputs (and its share
of the result's scale), the ms and TFLOP/s (2 M N K / time), and
`torch.matmul`'s ms on the same operands with TF32 off and on: the library
yardstick, which the port never calls for these.  An error above TOL_REL of
the result's scale raises after its line.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_kernel_matmul [--device cpu]

Shapes: the TPU probe's own (TR 16, B 32, D 64, S 128), K1's at the
headline (TR 8192, B 16, D 64, S 127) and at Cora's layer 0 (the class of
2712 rows of width 8, D 1433, S 2865).  The TPU probe has no knobs; with
`--device cpu` only the probe's own shape runs, on the plain versions.

`kernel_matmul(kind, ...)` runs a contraction's kernel on CUDA tensors
(each call adding one to `kernel_matmul.launches`) and its plain version,
`torch.einsum` in the input dtype (`kernel_matmul_plain`), on CPU tensors.
"""
from __future__ import annotations


import numpy as np
import torch

from ..ops.fsw_rank import _check, _count, _kernel, _launch
from . import _timing

KINDS = ('fwd', 'dxr', 'dv', 'dv_loop', 'flat')
TOL_REL = 1e-5        # max abs error against float64 / max |float64|
# (name, TR, B, D, S)
SHAPES = (('probe', 16, 32, 64, 128), ('headline', 8192, 16, 64, 127),
          ('cora_layer0', 2712, 8, 1433, 2865))
# (operand names, einsum) of each contraction
SPEC = {'fwd': (('Z', 'V'), 'rbd,ds->rbs'),
        'dxr': (('dP', 'V'), 'rbs,ds->rbd'),
        'dv': (('Z', 'dP'), 'rbd,rbs->ds'),
        'dv_loop': (('Z', 'dP'), 'rbd,rbs->ds'),
        'flat': (('Z', 'V'), 'rbd,ds->rbs')}


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


def kernel_matmul(kind: str, a, b):
    """Contraction `kind` of a and b, shaped as `SPEC` names them (Z
    (TR, B, D), V (D, S), dP (TR, B, S)).  CPU tensors: the plain version.
    CUDA tensors: the kernel (float32, contiguous), each call adding one to
    `kernel_matmul.launches`."""
    if kind not in KINDS:
        raise ValueError(f'unknown contraction {kind!r}')
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
    fn = fns[f'{kind}_f32']
    M = TR * B
    if kind in ('fwd', 'flat'):
        out = torch.empty((TR, B, S), **f32)
        dims = (TR, B, D, S) if kind == 'fwd' else (M, D, S)
        _launch('probe_matmul', fn, a, b, out, *dims)
    elif kind == 'dxr':
        out = torch.empty((TR, B, D), **f32)
        _launch('probe_matmul', fn, a, b, out, M, D, S)
    elif kind == 'dv':
        out = torch.empty((D, S), **f32)
        ws = torch.empty((fns['dv_parts'](M), D, S), **f32)
        _launch('probe_matmul', fn, a, b, out, ws, M, D, S)
    else:
        out = torch.empty((D, S), **f32)
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


def check(kind, x):
    """(max abs error, its share of max |reference|) of the contraction
    against float64 einsum of the same inputs."""
    a, b = (x[n] for n in SPEC[kind][0])
    got = kernel_matmul(kind, a, b)
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
            err, rel = check(kind, x)
            a, b = (x[n] for n in SPEC[kind][0])
            ms = _timing.median_ms(lambda: kernel_matmul(kind, a, b), dev,
                                   iters=10 if shape[3] > 256 else 20)
            fields = {'shape': shape[0], 'TR': shape[1], 'B': shape[2],
                      'D': shape[3], 'S': shape[4], 'contraction': kind,
                      'max_abs_err_vs_f64': err, 'max_rel_err_vs_f64': rel,
                      key: ms}
            if dev.type == 'cuda':
                ma, mb = matmul_operands(kind, x)
                mm = {}
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    mm[tf32] = _timing.median_ms(lambda: torch.matmul(ma, mb),
                                                 dev, iters=10)
                torch.backends.cuda.matmul.allow_tf32 = False
                fields.update(tflops=flops(kind, shape) / (ms * 1e-3) / 1e12,
                              matmul_f32_ms=mm[False],
                              matmul_tf32_ms=mm[True])
            _timing.emit(dev, **fields)
            if not rel <= TOL_REL:
                raise RuntimeError(f'P1 {kind} at the {shape[0]} shape: '
                                   f'{rel:.3e} of the scale from float64, '
                                   f'above {TOL_REL}')
            out.append(fields)
        del x
    return out


if __name__ == '__main__':
    main()
