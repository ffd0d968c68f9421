"""Fused-projection FSW aggregation by weighted ranks: the CUDA kernels
(forward K1f, backward K1b) and their plain PyTorch versions.

Replaces `fsw_rank_aggregate_proj` of fsw_gnn_tpu/ops/fsw_rank_pallas.py,
whose forward is the TPU kernel `_fwdp_kernel` and whose backward is
`_bwdp_kernel`.  For table rows r, entries i, j of width B and slices s,
with P = Z @ V:

    c_i     = sum_j wn_j * 1[p_j < p_i or (p_j == p_i and j <= i)]
              + pad * 1[p_i > 0]
    out[r,s] = (1 + f_s) * sum_i p_i * phi_i,
    phi_i    = (2 / (pi f_s)) sin(pi f_s wn_i) cos(pi f_s (2 c_i - wn_i))

c_i is the inclusive cumsum of the weights in stable-sorted projection
order, so no sort is needed.  The backward (the mask is constant almost
everywhere), with g the output cotangent and A = pi f (2c - w):

    dp_i   = (1 + f) g phi_i
    dZ     = dP V^T,  dV = Z^T dP  (summed over every row and entry)
    df_s   = sum_r g [ q + (1 + f) sum_i p_i phi_f ],   q = sum_i p_i phi_i
    phi_f  = (2/f) [ w cos(pi f w) cos A - sin(pi f w) cos A / (pi f)
                     - (2c - w) sin(pi f w) sin A ]          (0 at f = 0)
    with_dw only:
    dc_i   = (1 + f) g p_i (-4) sin(pi f w) sin A
    dwn_j  = sum_s (1 + f) g p_j 2 cos(A - pi f w) + sum_{i,s} dc_i M_ij
    dpad   = sum_{i,s} dc_i 1[p_i > 0]

The kernel sources (csrc/fsw_rank_fwdp.cu, csrc/fsw_rank_bwdp.cu) say what
bounds them on an H100 and what their design does about it.

`fsw_rank_aggregate_proj` is a `torch.autograd.Function`: on CPU tensors
its forward and backward are the plain versions, on CUDA tensors the
kernels.  On the card it never falls back.  Like the TPU kernel it saves
only its inputs and recomputes P in the backward.
"""
from __future__ import annotations

import ctypes
import math

import torch

_FN = {}

# shared memory a block may use on Hopper (sm_90)
_MAX_SMEM = 232448


def _wrap(u):
    """u - round-to-nearest(u): exact, and keeps the phase of sin/cos(2 pi u)
    accurate at large u (the 'spread' frequencies reach about 2S - 1)."""
    return u - torch.round(u)


def _sincos2pi(u):
    a = 2.0 * math.pi * _wrap(u)
    return torch.sin(a), torch.cos(a)


def _project_and_rank(Z, wn, pad_norm, V):
    """P = Z V (einsum) and the inclusive weighted rank c with the pad
    shift, summed in the order j = 0 .. B-1 as `_rank_c` does."""
    P = torch.einsum('rbd,ds->rbs', Z, V)                   # (R, B, S)
    B = P.shape[1]
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    pos = torch.arange(B, device=P.device).view(1, B, 1)
    c = torch.zeros_like(P)
    for j in range(B):
        pj = P[:, j:j + 1, :]
        m = (pj < P) | ((pj == P) & (pos >= j))
        c = c + torch.where(m, wn[:, j, None, None], zero)
    c = c + torch.where(P > 0, pad_norm[:, None, None], zero)
    return P, c, pos


def _trig(wn, c, freqs, uniform_w):
    """(sin_fw, cos_fw, sin_t, cos_t) of pi f w and A = pi f (2c - w).
    uniform_w: sin/cos(pi f w) once per row from max_j wn, sin forced to
    exactly 0 at the zero-weight entries (cos keeps the row value there,
    harmless only where it is multiplied by w)."""
    ws = wn[:, :, None]
    sin_t, cos_t = _sincos2pi(0.5 * freqs * (2.0 * c - ws))
    if uniform_w:
        wr = wn.max(dim=1, keepdim=True).values[:, :, None]  # (R, 1, 1)
        sin_r, cos_r = _sincos2pi(0.5 * freqs * wr)
        sin_fw = torch.where(ws == 0, torch.zeros_like(sin_r), sin_r)
        cos_fw = cos_r.expand_as(sin_t)
    else:
        sin_fw, cos_fw = _sincos2pi(0.5 * freqs * ws)
    return sin_fw, cos_fw, sin_t, cos_t


def _freq_consts(freqs):
    """(fz, 1/f) with 1/f zeroed at f == 0, so padded slices give exact
    zeros instead of inf * 0."""
    fz = freqs == 0
    inv_f = torch.where(fz, torch.zeros_like(freqs),
                        1.0 / torch.where(fz, torch.ones_like(freqs), freqs))
    return fz, inv_f


def fsw_rank_aggregate_proj_plain(Z, wn, pad_norm, freqs, V,
                                  uniform_w: bool = False):
    """Plain PyTorch forward: project with einsum, build c with the B-step
    masked loop, then the quadrature.  Any float dtype."""
    P, c, _ = _project_and_rank(Z, wn, pad_norm, V)
    ws = wn[:, :, None]
    sin_fw, _, _, cos_t = _trig(wn, c, freqs, uniform_w)
    fz, inv_f = _freq_consts(freqs)
    sd = torch.where(fz, 2.0 * ws, (2.0 / math.pi) * inv_f * sin_fw) * cos_t
    return (1.0 + freqs) * torch.sum(P * sd, dim=1)


def fsw_rank_aggregate_proj_bwd_plain(Z, wn, pad_norm, freqs, V, g,
                                      uniform_w: bool = False,
                                      with_dw: bool = True):
    """Plain PyTorch backward (the formulas of `_bwdp_kernel`): returns
    (dZ, dwn, dpad, df, dV) for the output cotangent g (R, S); dwn and
    dpad are None when with_dw is False.  The uniform_w trig is used only
    without with_dw, as the TPU kernel does."""
    P, c, pos = _project_and_rank(Z, wn, pad_norm, V)
    ws = wn[:, :, None]
    sin_fw, cos_fw, sin_t, cos_t = _trig(wn, c, freqs,
                                         uniform_w and not with_dw)
    fz, inv_f = _freq_consts(freqs)
    sd = torch.where(fz, 2.0 * ws, (2.0 / math.pi) * inv_f * sin_fw) * cos_t
    g1 = ((1.0 + freqs) * g)[:, None, :]                     # (R, 1, S)
    dp = g1 * sd
    dZ = torch.einsum('rbs,ds->rbd', dp, V)
    dV = torch.einsum('rbd,rbs->ds', Z, dp)
    two_c_w = 2.0 * c - ws
    phi_f = 2.0 * inv_f * (ws * cos_fw * cos_t
                           - (inv_f / math.pi) * sin_fw * cos_t
                           - two_c_w * sin_fw * sin_t)
    q = torch.sum(P * sd, dim=1)
    df = torch.sum(g * (q + (1.0 + freqs) * torch.sum(P * phi_f, dim=1)),
                   dim=0)
    if not with_dw:
        return dZ, None, None, df, dV
    dc = g1 * P * (-4.0) * sin_fw * sin_t
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    dpad = torch.sum(torch.where(P > 0, dc, zero), dim=(1, 2))
    dwn = torch.sum(g1 * P * 2.0 * (cos_fw * cos_t + sin_fw * sin_t), dim=2)
    cols = []
    for j in range(P.shape[1]):
        pj = P[:, j:j + 1, :]
        m = (pj < P) | ((pj == P) & (pos >= j))
        cols.append(torch.sum(torch.where(m, dc, zero), dim=(1, 2)))
    return dZ, dwn + torch.stack(cols, dim=1), dpad, df, dV


def _kernel(name):
    """(entry function, helper) of one kernel library, loaded once."""
    if name not in _FN:
        from ..kernels import load
        lib = load(name)
        if name == 'fsw_rank_fwdp':
            fn = lib.fsw_rank_fwdp_f32
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            aux = lib.fsw_rank_fwdp_smem_bytes
            aux.argtypes = [ctypes.c_int, ctypes.c_int]
        else:
            fn = lib.fsw_rank_bwdp_f32
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            aux = lib.fsw_rank_bwdp_workspace_bytes
            aux.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
        aux.restype = ctypes.c_size_t
        _FN[name] = (fn, aux)
    return _FN[name]


def _check(named, R, B, D, S):
    """Device, float32, contiguity and shape of every CUDA argument."""
    want = {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,), 'V': (D, S),
            'g': (R, S)}
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, Z on {dev}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {want[name]}')


def _fwd(Z, wn, pad_norm, freqs, V, uniform_w):
    """The forward on Z's device: plain on the CPU, K1f on the card."""
    args = (Z, wn, pad_norm, freqs, V)
    if Z.device.type == 'cpu':
        return fsw_rank_aggregate_proj_plain(*args, uniform_w=uniform_w)
    if Z.device.type != 'cuda':
        raise ValueError(f'unsupported device {Z.device}')
    R, B, D = Z.shape
    S = V.shape[1]
    _check(list(zip(('Z', 'wn', 'pad_norm', 'freqs', 'V'), args)),
           R, B, D, S)
    out = torch.empty((R, S), dtype=torch.float32, device=Z.device)
    if R == 0 or S == 0:
        return out
    fn, smem = _kernel('fsw_rank_fwdp')
    if smem(B, D) > _MAX_SMEM:
        raise ValueError(f'bucket width {B} with feature width {D} needs '
                         f'{smem(B, D)} bytes of shared memory '
                         f'(> {_MAX_SMEM})')
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(),
                R, B, D, S, int(bool(uniform_w)), stream)
    if rc != 0:
        raise RuntimeError(f'fsw_rank_fwdp launch failed: CUDA error {rc}')
    fsw_rank_aggregate_proj.launches += 1
    return out


def fsw_rank_aggregate_proj_bwd(Z, wn, pad_norm, freqs, V, g,
                                uniform_w: bool = False,
                                with_dw: bool = True):
    """The backward on Z's device: (dZ, dwn, dpad, df, dV), dwn and dpad
    None without with_dw.  CPU tensors: the plain version.  CUDA tensors:
    kernel K1b (float32, contiguous), or an error; each call adds one to
    `fsw_rank_aggregate_proj_bwd.launches`."""
    args = (Z, wn, pad_norm, freqs, V, g)
    if Z.device.type == 'cpu':
        return fsw_rank_aggregate_proj_bwd_plain(
            *args, uniform_w=uniform_w, with_dw=with_dw)
    if Z.device.type != 'cuda':
        raise ValueError(f'unsupported device {Z.device}')
    R, B, D = Z.shape
    S = V.shape[1]
    _check(list(zip(('Z', 'wn', 'pad_norm', 'freqs', 'V', 'g'), args)),
           R, B, D, S)
    f32 = dict(dtype=torch.float32, device=Z.device)
    dZ = torch.empty((R, B, D), **f32)
    df = torch.empty((S,), **f32)
    dV = torch.empty((D, S), **f32)
    dwn = torch.empty((R, B), **f32) if with_dw else None
    dpad = torch.empty((R,), **f32) if with_dw else None
    if R == 0 or B == 0 or S == 0 or D == 0:
        for t in (dZ, df, dV, dwn, dpad):
            if t is not None:
                t.zero_()
        return dZ, dwn, dpad, df, dV
    fn, workspace = _kernel('fsw_rank_bwdp')
    ws = torch.empty((workspace(R, B, D, S, int(with_dw)),),
                     dtype=torch.uint8, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in args), dZ.data_ptr(),
                dwn.data_ptr() if with_dw else None,
                dpad.data_ptr() if with_dw else None,
                df.data_ptr(), dV.data_ptr(), ws.data_ptr(),
                R, B, D, S, int(bool(uniform_w)), int(bool(with_dw)), stream)
    if rc != 0:
        raise RuntimeError(f'fsw_rank_bwdp launch failed: CUDA error {rc}')
    fsw_rank_aggregate_proj_bwd.launches += 1
    return dZ, dwn, dpad, df, dV


class _RankProj(torch.autograd.Function):
    """K1f forward, K1b backward (their plain versions on the CPU).  Saves
    the inputs only; the backward recomputes P, as `_fswp_fwd` does."""

    @staticmethod
    def forward(ctx, Z, wn, pad_norm, freqs, V, uniform_w, with_dw):
        ctx.save_for_backward(Z, wn, pad_norm, freqs, V)
        ctx.uniform_w, ctx.with_dw = uniform_w, with_dw
        return _fwd(Z, wn, pad_norm, freqs, V, uniform_w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        if not any(need[:5]):
            return (None,) * 7
        with_dw = ctx.with_dw and (need[1] or need[2])
        grads = fsw_rank_aggregate_proj_bwd(
            *ctx.saved_tensors, g.contiguous(), uniform_w=ctx.uniform_w,
            with_dw=with_dw)
        return tuple(t if n else None for t, n in zip(grads, need)) + (
            None, None)


def fsw_rank_aggregate_proj(Z, wn, pad_norm, freqs, V,
                            uniform_w: bool = False, with_dw: bool = True):
    """Z (R, B, D) gathered sender rows; wn (R, B) normalized weights;
    pad_norm (R,) phantom-mass shift; freqs (S,); V (D, S) slice matrix.
    Returns (R, S), differentiable in Z, wn, pad_norm, freqs and V.

    CPU tensors: the plain versions.  CUDA tensors: kernels K1f and K1b
    (float32, contiguous), or an error; each forward launch adds one to
    `fsw_rank_aggregate_proj.launches`.  with_dw=False declares wn and
    pad_norm data: their gradient is None and its loop is skipped;
    uniform_w enables the row-constant-weight trig (see the module
    docstring)."""
    return _RankProj.apply(Z, wn, pad_norm, freqs, V, bool(uniform_w),
                           bool(with_dw))


fsw_rank_aggregate_proj.launches = 0
fsw_rank_aggregate_proj_bwd.launches = 0
