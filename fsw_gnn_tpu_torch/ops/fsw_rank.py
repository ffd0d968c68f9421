"""Fused-projection FSW aggregation by weighted ranks: the CUDA kernel and
its plain PyTorch version.

Replaces `fsw_rank_aggregate_proj` of fsw_gnn_tpu/ops/fsw_rank_pallas.py,
whose forward is the TPU kernel `_fwdp_kernel`.  For table rows r, entries
i, j of width B and slices s, with P = Z @ V:

    c_i     = sum_j wn_j * 1[p_j < p_i or (p_j == p_i and j <= i)]
              + pad * 1[p_i > 0]
    out[r,s] = (1 + f_s) * sum_i p_i * (2 / (pi f_s)) sin(pi f_s wn_i)
                                    * cos(pi f_s (2 c_i - wn_i))

c_i is the inclusive cumsum of the weights in stable-sorted projection
order, so no sort is needed.  The kernel source
(csrc/fsw_rank_fwdp.cu) says what bounds it on an H100 and what its design
does about it.

`fsw_rank_aggregate_proj` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; on the card it never falls back.  The
backward kernel (K1b in ROADMAP.md) is not ported yet, so CUDA inputs that
require grad raise.  On the CPU the plain version is differentiable through
autograd.
"""
from __future__ import annotations

import ctypes
import math

import torch

_KERNEL = 'fsw_rank_fwdp'
_FN = None


def _wrap(u):
    """u - round-to-nearest(u): exact, and keeps the phase of sin/cos(2 pi u)
    accurate at large u (the 'spread' frequencies reach about 2S - 1)."""
    return u - torch.round(u)


def fsw_rank_aggregate_proj_plain(Z, wn, pad_norm, freqs, V,
                                  uniform_w: bool = False):
    """Plain PyTorch version: project with einsum, build c with the B-step
    masked loop in the order j = 0 .. B-1 (as `_rank_c`), then the
    quadrature.  Any float dtype; differentiable in every input."""
    P = torch.einsum('rbd,ds->rbs', Z, V)                   # (R, B, S)
    R, B, S = P.shape
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    pos = torch.arange(B, device=P.device).view(1, B, 1)
    c = torch.zeros_like(P)
    for j in range(B):
        pj = P[:, j:j + 1, :]
        m = (pj < P) | ((pj == P) & (pos >= j))
        c = c + torch.where(m, wn[:, j, None, None], zero)
    c = c + torch.where(P > 0, pad_norm[:, None, None], zero)
    ws = wn[:, :, None]                                      # (R, B, 1)
    two_pi = 2.0 * math.pi
    cos_t = torch.cos(two_pi * _wrap(0.5 * freqs * (2.0 * c - ws)))
    if uniform_w:
        wr = wn.max(dim=1, keepdim=True).values[:, :, None]  # (R, 1, 1)
        sin_r = torch.sin(two_pi * _wrap(0.5 * freqs * wr))
        sin_fw = torch.where(ws == 0, zero, sin_r)
    else:
        sin_fw = torch.sin(two_pi * _wrap(0.5 * freqs * ws))
    fz = freqs == 0
    inv_f = torch.where(fz, zero, 1.0 / torch.where(fz, 1.0, freqs))
    c2f = (2.0 / math.pi) * inv_f
    sd = torch.where(fz, 2.0 * ws, c2f * sin_fw) * cos_t
    return (1.0 + freqs) * torch.sum(P * sd, dim=1)


def _kernel_fn():
    global _FN
    if _FN is None:
        from ..kernels import load
        lib = load(_KERNEL)
        fn = lib.fsw_rank_fwdp_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem = lib.fsw_rank_fwdp_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_size_t
        _FN = (fn, smem)
    return _FN


# shared memory a block may use on Hopper (sm_90)
_MAX_SMEM = 232448


def fsw_rank_aggregate_proj(Z, wn, pad_norm, freqs, V,
                            uniform_w: bool = False):
    """Z (R, B, D) gathered sender rows; wn (R, B) normalized weights;
    pad_norm (R,) phantom-mass shift; freqs (S,); V (D, S) slice matrix.
    Returns (R, S).

    CPU tensors: the plain version.  CUDA tensors: the kernel (float32,
    contiguous), or an error; each launch adds one to
    `fsw_rank_aggregate_proj.launches`."""
    args = (Z, wn, pad_norm, freqs, V)
    if Z.device.type == 'cpu':
        return fsw_rank_aggregate_proj_plain(*args, uniform_w=uniform_w)
    if Z.device.type != 'cuda':
        raise ValueError(f'unsupported device {Z.device}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            'the backward kernel of fsw_rank_aggregate_proj (K1b in '
            'ROADMAP.md) is not ported yet: run the forward under '
            'torch.no_grad() or torch.inference_mode()')
    R, B, D = Z.shape
    S = V.shape[1]
    want = {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,), 'V': (D, S)}
    for name, t in zip(('Z', 'wn', 'pad_norm', 'freqs', 'V'), args):
        if t.device != Z.device:
            raise ValueError(f'{name} is on {t.device}, Z on {Z.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {want[name]}')
    out = torch.empty((R, S), dtype=torch.float32, device=Z.device)
    if R == 0 or S == 0:
        return out
    fn, smem = _kernel_fn()
    if smem(B, D) > _MAX_SMEM:
        raise ValueError(f'bucket width {B} with feature width {D} needs '
                         f'{smem(B, D)} bytes of shared memory '
                         f'(> {_MAX_SMEM})')
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = fn(Z.data_ptr(), wn.data_ptr(), pad_norm.data_ptr(),
                freqs.data_ptr(), V.data_ptr(), out.data_ptr(),
                R, B, D, S, int(bool(uniform_w)), stream)
    if rc != 0:
        raise RuntimeError(f'fsw_rank_fwdp launch failed: CUDA error {rc}')
    fsw_rank_aggregate_proj.launches += 1
    return out


fsw_rank_aggregate_proj.launches = 0
