"""FSW aggregation by weighted ranks: the CUDA kernels and their plain
PyTorch versions.

Three kernel pairs, replacing the three rank aggregations of
fsw_gnn_tpu/ops/fsw_rank_pallas.py:

  * K2 `fsw_rank_aggregate` on projections P (R, B, S) already computed:
    forward K2f (TPU `_fwd_kernel`), backward K2b (TPU `_bwd_kernel`);
  * K1 `fsw_rank_aggregate_proj` on sender rows Z (R, B, D) and the slice
    matrix V (D, S), projecting P = Z V itself: forward K1f (TPU
    `_fwdp_kernel`), backward K1b (TPU `_bwdp_kernel`);
  * K4 `fsw_rank_aggregate_cart`, cartesian mode: K2 on P with an (S, F)
    frequency matrix, out (R, S, F), the ranks computed once for all F
    frequencies: forward K4f (TPU `_fwdc_kernel`), backward K4b (TPU
    `_bwdc_kernel` and `_mask_consume_kernel`, fused).  K2's plain
    versions are K4's with F = 1.

For table rows r, entries i, j of width B and slices s:

    c_i     = sum_j wn_j * 1[p_j < p_i or (p_j == p_i and j <= i)]
              + pad * 1[p_i > 0]
    out[r,s] = (1 + f_s) * sum_i p_i * phi_i,
    phi_i    = (2 / (pi f_s)) sin(pi f_s wn_i) cos(pi f_s (2 c_i - wn_i))

c_i is the inclusive cumsum of the weights in stable-sorted projection
order, so no sort is needed.  The backward (the mask is constant almost
everywhere), with g the output cotangent and A = pi f (2c - w):

    dp_i   = (1 + f) g phi_i
    df_s   = sum_r g [ q + (1 + f) sum_i p_i phi_f ],   q = sum_i p_i phi_i
    phi_f  = (2/f) [ w cos(pi f w) cos A - sin(pi f w) cos A / (pi f)
                     - (2c - w) sin(pi f w) sin A ]          (0 at f = 0)
    with_dw only:
    dc_i   = (1 + f) g p_i (-4) sin(pi f w) sin A
    dwn_j  = sum_s (1 + f) g p_j 2 cos(A - pi f w) + sum_{i,s} dc_i M_ij
    dpad   = sum_{i,s} dc_i 1[p_i > 0]
    K1 only: dZ = dP V^T, dV = Z^T dP (summed over every row and entry).
    K4: every term for each frequency column k, dp, dc and dwn summed
    over k, df (S, F) per column.

The kernel sources (csrc/fsw_rank_fwd.cu, fsw_rank_bwd.cu,
fsw_rank_fwdp.cu, fsw_rank_bwdp.cu, fsw_rank_cart_fwd.cu,
fsw_rank_cart_bwd.cu, sharing csrc/fsw_rank_common.cuh) say what bounds
them on an H100 and what their design does about it.

Each kernel is a `torch.library` custom op in the namespace
fsw_gnn_tpu_torch (`torch.ops.fsw_gnn_tpu_torch.fsw_rank_aggregate`,
`..._bwd`, `fsw_rank_aggregate_proj`, `..._proj_bwd`,
`fsw_rank_aggregate_cart`, `..._cart_bwd`): on CPU tensors its
implementation is the plain version, on CUDA tensors the kernel, and its
fake implementation gives the shapes, so `torch.export` and CUDA-graph
capture see one op.  On the card they never fall back.  Each forward op's
autograd calls its backward op; like the TPU kernels they save only their
inputs and recompute the ranks (and K1 the projection) in the backward.
The public functions below keep their names, arguments and launch
counters; a counter counts the launches that run, not a capture.  A
width whose row the kernel's shared memory cannot hold raises a
ValueError naming the width and the limit.  `smem_bytes` gives each
kernel's shared-memory need from its shape, as the libraries' own
`*_smem_bytes` exports do but without loading one: the public functions
check it (`_fits`, on shapes) before any op runs, and the embedding's
routing (`_resolve_aggregate`)
sends a width only to kernels that hold it, on the CPU as on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch import Tensor

from ..kernels import KernelError
from ..utils.profiling import first_op

_FN = {}

# shared memory a block may use on Hopper (sm_90)
_MAX_SMEM = 232448
# csrc/fsw_rank_common.cuh: slices a forward block (one thread each), K1's
# staging ring (two stages of two 64 x 36 operands), entries a rank pass,
# the backward entry kernel's threads a slice at most and the frequency
# count besides 1 whose sums it keeps in registers
_TS = 64
_STAGE_FLOATS = 2 * 2 * 64 * 36
_NI = 8
_KMAX = 4
_NF_WIDE = 8

RANK_KERNELS = ('fsw_rank_fwdp', 'fsw_rank_bwdp', 'fsw_rank_fwd',
                'fsw_rank_bwd', 'fsw_rank_cart_fwd', 'fsw_rank_cart_bwd')
# kernel A1 (csrc/fsw_table_sort.cu), which no route takes: the widest
# column its lanes hold in registers
_TABLE_MAX_B = 1024


def table_sort_lanes(B: int) -> int:
    """Lanes of a warp that kernel A1 gives one column at width B
    (`fsw_table_sort_lanes` in csrc/fsw_table_sort.cu): B / min(B, 32) for
    a power of two from 2 to 1024, each lane holding min(B, 32) entries in
    registers; 0 for a width the kernel refuses.  A1 uses no shared
    memory."""
    if B < 2 or B > _TABLE_MAX_B or B & (B - 1):
        return 0
    return B // min(B, 32)


def proj_rows(B: int) -> int:
    """Table rows one K1f block projects (`proj_rows` in
    fsw_rank_common.cuh): at least 64 entries up to B = 64."""
    return 1 if B >= 64 or B <= 0 else 64 // B


def _entry_need(B: int, F: int, dw: bool, K: int, tsb: int) -> int:
    """Bytes of the backward entry kernel's block at width B, F frequencies
    and shape (K, tsb) (`entry_need` in fsw_rank_common.cuh)."""
    col, fc = B * tsb, F * tsb
    if dw:
        return 4 * (2 * col + 5 * fc + B + (tsb // 32) * B + K * tsb) + 2 * col
    return 4 * (col + 7 * fc + B)


def entry_shape(B: int, F: int = 1, with_dw: bool = False):
    """(K, tsb) of the backward entry kernel that K1b, K2b and K4b run
    (`entry_shape` in fsw_rank_common.cuh): K threads a slice, up to 4,
    one for every group of 8 entries, where F is 1 or 8 (the frequency
    counts whose sums it keeps in registers) and with with_dw or above
    B = 32, else 1; tsb slices a block, 64 where K is 1 and that fits,
    else 32."""
    split = F in (1, _NF_WIDE) and (with_dw or B > 32)
    K = min(max(-(-B // _NI), 1), _KMAX) if split else 1
    fit64 = _entry_need(B, F, bool(with_dw), 1, 64) <= _MAX_SMEM
    return K, 64 if K == 1 and fit64 else 32


def smem_bytes(name: str, B: int, F: int = 1, with_dw: bool = False,
               uniform_w: bool = False) -> int:
    """Dynamic shared memory, in bytes, that one block of rank kernel
    `name` (one of RANK_KERNELS) needs at width B, with F frequency columns
    (the cartesian pair), with or without the weights' gradient.  The same
    numbers as each library's `*_smem_bytes` export, without a library:

      K1f  4 max(STAGE, 65 E) for E <= 64, else 4 (STAGE + 65 E)
           (E = proj_rows(B) B; the feature width D does not enter)
      K2f  4 (65 B);   K4f  4 (65 B + 64 F) at F = 8 (its ranks in
           registers), 4 (129 B + 64 F) at other F
      K1b, K2b (F = 1), K4b: the entry kernel's block of `entry_shape`,
           with dw 4 (2 B tsb + 5 F tsb + B (1 + tsb / 32) + K tsb)
           + 2 B tsb (the positions), without 4 (B tsb + 7 F tsb + B)

    (K1b's products use a fixed 36 KB of static memory).  uniform_w does
    not enter: without dw the entry kernel keeps room for the uniform
    trig's row values either way."""
    dw = bool(with_dw)
    if name == 'fsw_rank_fwdp':
        e = proj_rows(B) * B
        own = e * _TS + e
        return 4 * (max(_STAGE_FLOATS, own) if e <= 64
                    else _STAGE_FLOATS + own)
    if name == 'fsw_rank_fwd':
        return 4 * (B * _TS + B)
    if name == 'fsw_rank_cart_fwd':
        return 4 * ((1 if F == _NF_WIDE else 2) * B * _TS + B + _TS * F)
    if name in ('fsw_rank_bwdp', 'fsw_rank_bwd', 'fsw_rank_cart_bwd'):
        F = F if name == 'fsw_rank_cart_bwd' else 1
        return _entry_need(B, F, dw, *entry_shape(B, F, dw))
    raise ValueError(f'unknown rank kernel {name!r}')


def misfit(names, B: int, F: int = 1, with_dw: bool = False,
           uniform_w: bool = False):
    """(name, bytes) of the first kernel of `names` that cannot hold width
    B (see `smem_bytes`), or None when they all can."""
    for name in names:
        need = smem_bytes(name, B, F, with_dw, uniform_w)
        if need > _MAX_SMEM:
            return name, need
    return None


def _wrap(u):
    """u - round-to-nearest(u): exact, and keeps the phase of sin/cos(2 pi u)
    accurate at large u (the 'spread' frequencies reach about 2S - 1)."""
    return u - torch.round(u)


def _sincos2pi(u):
    a = 2.0 * math.pi * _wrap(u)
    return torch.sin(a), torch.cos(a)


def _precedes(P, pos, j):
    """M_ij over every i for one j: p_j < p_i, or p_j == p_i and j <= i."""
    pj = P[:, j:j + 1, :]
    return (pj < P) | ((pj == P) & (pos >= j))


def _rank(P, wn, pad_norm):
    """The inclusive weighted rank c (R, B, S) with the pad shift, summed
    in the order j = 0 .. B-1 as `_rank_c` does."""
    B = P.shape[1]
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    pos = torch.arange(B, device=P.device).view(1, B, 1)
    c = torch.zeros_like(P)
    for j in range(B):
        c = c + torch.where(_precedes(P, pos, j), wn[:, j, None, None], zero)
    return c + torch.where(P > 0, pad_norm[:, None, None], zero)


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


def _acc(total, term):
    return term if total is None else total + term


def fsw_rank_aggregate_cart_plain(P, wn, pad_norm, freqs,
                                  uniform_w: bool = False):
    """Plain PyTorch forward of K4 (the formulas of `_fwdc_kernel`): the
    B-step masked rank loop once, then the quadrature for every column of
    the (S, F) frequency matrix.  Returns (R, S, F).  Any float dtype."""
    c = _rank(P, wn, pad_norm)
    outs = []
    for k in range(freqs.shape[1]):
        f = freqs[:, k]
        sin_fw, _, _, cos_t = _trig(wn, c, f, uniform_w)
        fz, inv_f = _freq_consts(f)
        sd = torch.where(fz, 2.0 * wn[:, :, None],
                         (2.0 / math.pi) * inv_f * sin_fw) * cos_t
        outs.append((1.0 + f) * torch.sum(P * sd, dim=1))
    return torch.stack(outs, dim=-1)


def fsw_rank_aggregate_cart_bwd_plain(P, wn, pad_norm, freqs, g,
                                      uniform_w: bool = False,
                                      with_dw: bool = True):
    """Plain PyTorch backward of K4 (the formulas of `_bwdc_kernel` and
    `_mask_consume_kernel`): returns (dP, dwn, dpad, df) for the output
    cotangent g (R, S, F), df of shape (S, F); dwn and dpad are None when
    with_dw is False.  The uniform_w trig is used only without with_dw,
    as the TPU kernel does."""
    c = _rank(P, wn, pad_norm)
    ws = wn[:, :, None]
    two_c_w = 2.0 * c - ws
    dP = dc = dwn = None
    dfs = []
    for k in range(freqs.shape[1]):
        f, gk = freqs[:, k], g[:, :, k]
        sin_fw, cos_fw, sin_t, cos_t = _trig(wn, c, f,
                                             uniform_w and not with_dw)
        fz, inv_f = _freq_consts(f)
        sd = torch.where(fz, 2.0 * ws,
                         (2.0 / math.pi) * inv_f * sin_fw) * cos_t
        g1 = ((1.0 + f) * gk)[:, None, :]                    # (R, 1, S)
        dP = _acc(dP, g1 * sd)
        phi_f = 2.0 * inv_f * (ws * cos_fw * cos_t
                               - (inv_f / math.pi) * sin_fw * cos_t
                               - two_c_w * sin_fw * sin_t)
        q = torch.sum(P * sd, dim=1)
        dfs.append(torch.sum(gk * (q + (1.0 + f) * torch.sum(P * phi_f,
                                                             dim=1)), dim=0))
        if with_dw:
            dc = _acc(dc, g1 * P * (-4.0) * sin_fw * sin_t)
            dwn = _acc(dwn, torch.sum(
                g1 * P * 2.0 * (cos_fw * cos_t + sin_fw * sin_t), dim=2))
    df = torch.stack(dfs, dim=1)
    if not with_dw:
        return dP, None, None, df
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    dpad = torch.sum(torch.where(P > 0, dc, zero), dim=(1, 2))
    pos = torch.arange(P.shape[1], device=P.device).view(1, -1, 1)
    cols = [torch.sum(torch.where(_precedes(P, pos, j), dc, zero), dim=(1, 2))
            for j in range(P.shape[1])]
    return dP, dwn + torch.stack(cols, dim=1), dpad, df


def fsw_rank_aggregate_plain(P, wn, pad_norm, freqs, uniform_w: bool = False):
    """Plain PyTorch forward of K2 (the formulas of `_fwd_kernel`): K4's
    with the one frequency column f_s per slice.  Any float dtype."""
    return fsw_rank_aggregate_cart_plain(P, wn, pad_norm, freqs[:, None],
                                         uniform_w)[..., 0]


def fsw_rank_aggregate_bwd_plain(P, wn, pad_norm, freqs, g,
                                 uniform_w: bool = False,
                                 with_dw: bool = True):
    """Plain PyTorch backward of K2 (the formulas of `_bwd_kernel`):
    returns (dP, dwn, dpad, df) for the output cotangent g (R, S); dwn and
    dpad are None when with_dw is False.  K4's with one frequency column."""
    dP, dwn, dpad, df = fsw_rank_aggregate_cart_bwd_plain(
        P, wn, pad_norm, freqs[:, None], g[..., None], uniform_w, with_dw)
    return dP, dwn, dpad, df[:, 0]


def fsw_rank_aggregate_proj_plain(Z, wn, pad_norm, freqs, V,
                                  uniform_w: bool = False):
    """Plain PyTorch forward of K1: project with einsum, then K2's plain
    forward.  Any float dtype."""
    P = torch.einsum('rbd,ds->rbs', Z, V)
    return fsw_rank_aggregate_plain(P, wn, pad_norm, freqs, uniform_w)


def fsw_rank_aggregate_proj_bwd_plain(Z, wn, pad_norm, freqs, V, g,
                                      uniform_w: bool = False,
                                      with_dw: bool = True):
    """Plain PyTorch backward of K1 (the formulas of `_bwdp_kernel`):
    returns (dZ, dwn, dpad, df, dV); dwn and dpad are None without
    with_dw."""
    P = torch.einsum('rbd,ds->rbs', Z, V)
    dP, dwn, dpad, df = fsw_rank_aggregate_bwd_plain(
        P, wn, pad_norm, freqs, g, uniform_w=uniform_w, with_dw=with_dw)
    dZ = torch.einsum('rbs,ds->rbd', dP, V)
    dV = torch.einsum('rbd,rbs->ds', Z, dP)
    return dZ, dwn, dpad, df, dV


_SIZE, _INT = ctypes.c_size_t, ctypes.c_int

_PTR = ctypes.c_void_p

# name -> (argtypes of the entry function `{name}_f32` before the stream,
# or None where the library has none; {helper: (argtypes, restype)} of the
# functions `{name}_{helper}`); an entry function returns a CUDA error code
_SIGNATURES = {
    'fsw_rank_fwdp': ([ctypes.c_void_p] * 6 + [_INT] * 5,
                      {'smem_bytes': ([_INT], _SIZE),
                       'project_f32': ([ctypes.c_void_p] * 3 + [_INT] * 4
                                       + [ctypes.c_void_p], _INT)}),
    'fsw_rank_bwdp': ([ctypes.c_void_p] * 12 + [_INT] * 6,
                      {'workspace_bytes': ([_INT] * 5, _SIZE),
                       'smem_bytes': ([_INT] * 2, _SIZE),
                       'project_f32': ([ctypes.c_void_p] * 3 + [_INT] * 4
                                       + [ctypes.c_void_p], _INT)}),
    'fsw_rank_fwd': ([ctypes.c_void_p] * 5 + [_INT] * 4,
                     {'smem_bytes': ([_INT], _SIZE)}),
    'fsw_rank_bwd': ([ctypes.c_void_p] * 10 + [_INT] * 5,
                     {'workspace_bytes': ([_INT] * 4, _SIZE),
                      'smem_bytes': ([_INT] * 2, _SIZE)}),
    'fsw_rank_cart_fwd': ([ctypes.c_void_p] * 5 + [_INT] * 5,
                          {'smem_bytes': ([_INT] * 2, _SIZE)}),
    'fsw_rank_cart_bwd': ([ctypes.c_void_p] * 10 + [_INT] * 6,
                          {'workspace_bytes': ([_INT] * 5, _SIZE),
                           'smem_bytes': ([_INT] * 4, _SIZE)}),
    # the benchmark folder's kernels (fsw_gnn_tpu_torch/benchmarks/)
    'fsw_table_sort': ([_PTR] * 5 + [_INT] * 3,
                       {'lanes': ([_INT], _INT),
                        'gather_f32': ([_PTR] * 6 + [_INT] * 3 + [_PTR],
                                       _INT)}),
    'probe_stage': ([_PTR] * 5 + [_INT] * 4,
                    {'smem_bytes': ([_INT] * 2, _SIZE),
                     'loop': ([_INT] * 2, _INT)}),
    'probe_select': ([_INT] + [_PTR] * 3 + [_INT] * 4,
                     {'smem_bytes': ([_INT], _SIZE),
                      'loop': ([_INT] * 2, _INT)}),
    'probe_matmul': (None, {
        'fwd_f32': ([_PTR] * 3 + [_INT] * 4 + [_PTR], _INT),
        'flat_f32': ([_PTR] * 3 + [_INT] * 3 + [_PTR], _INT),
        'dxr_f32': ([_PTR] * 3 + [_INT] * 3 + [_PTR], _INT),
        'dv_f32': ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
        'dv_loop_f32': ([_PTR] * 4 + [_INT] * 4 + [_PTR], _INT),
        'dv_parts': ([_INT], ctypes.c_longlong),
        'wgmma_f32': ([_INT] + [_PTR] * 4 + [_INT] * 6 + [_PTR], _INT),
        'wgmma_parts': ([_INT] * 5, ctypes.c_longlong)}),
    'probe_segscan': (None, {
        'variant_f32': ([_PTR] * 6 + [ctypes.c_longlong] * 2 + [_INT, _PTR],
                        _INT),
        'stage_f32': ([_PTR] * 6 + [ctypes.c_longlong] * 2 + [_INT] * 2
                      + [_PTR], _INT),
        'blocks': ([ctypes.c_longlong] * 2, ctypes.c_longlong)}),
}


def _kernel(name):
    """(entry function or None, {helper name: function}) of one kernel
    library, loaded once."""
    if name not in _FN:
        from ..kernels import load
        lib = load(name)
        argtypes, helpers = _SIGNATURES[name]
        fn = None
        if argtypes is not None:
            fn = getattr(lib, f'{name}_f32')
            fn.argtypes = argtypes + [_PTR]                 # + the stream
            fn.restype = ctypes.c_int
        aux = {}
        for helper, (types, restype) in helpers.items():
            h = getattr(lib, f'{name}_{helper}')
            h.argtypes = types
            h.restype = restype
            aux[helper] = h
        _FN[name] = (fn, aux)
    return _FN[name]


def _fits(name, B, F=1, with_dw=False, uniform_w=False):
    """Raise a ValueError when one block of kernel `name` at width B needs
    more shared memory than a block has (`smem_bytes`)."""
    need = smem_bytes(name, B, F, with_dw, uniform_w)
    if need > _MAX_SMEM:
        at = f' at {F} frequencies' if name.startswith('fsw_rank_cart') else ''
        raise ValueError(f'{name}: bucket width {B}{at} needs {need} bytes '
                         f'of shared memory, above the {_MAX_SMEM} a block '
                         f'has on this card; use aggregate=\'sort\'')


def _check(named, shapes):
    """Device, float32, contiguity and shape of every CUDA argument."""
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, {named[0][0]} on '
                             f'{dev}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {shapes[name]}')


def _device(t):
    """'cpu' or 'cuda' for the first argument; anything else raises."""
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {t.device}')
    return t.device.type


def _launch(name, fn, *args):
    """Call a kernel library's entry function on the current stream of the
    tensors' card and raise on a CUDA error code."""
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f'{name} launch failed: CUDA error {rc}')


def _count(wrapper, loop=None):
    """One more launch on `wrapper`'s counter, unless the stream is
    capturing a graph: a capture records the kernel and runs nothing, and
    a replay does not pass through Python.  With `loop`, also one more on
    `wrapper.loops[loop]`, the loop the library chose for the launch."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
        if loop is not None:
            wrapper.loops[loop] = wrapper.loops.get(loop, 0) + 1


def _grads_wanted(*ts):
    """Whether autograd will ask for a gradient of any of `ts`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _outs(ts, like):
    """The op's outputs: contiguous, None (no gradient asked) as an empty
    tensor, since an op returns tensors only."""
    return tuple(like.new_empty((0,)) if t is None else t.contiguous()
                 for t in ts)


def _grads(outs, with_dw):
    """The public backward's tuple: dwn and dpad None without with_dw."""
    return tuple(None if i in (1, 2) and not with_dw else t
                 for i, t in enumerate(outs))


# Each kernel pair is one `torch.library` custom op for the forward and one
# for the backward, in the namespace fsw_gnn_tpu_torch: the CPU
# implementation is the plain version, the CUDA implementation the kernel,
# the fake implementation gives the shapes (so torch.export and graph
# capture see one op).  The forward op's autograd calls the backward op;
# the widths are checked against shared memory (`_fits`) in the public
# functions, on shapes, before any op runs.

# ---- K2: the unfused weighted-rank aggregation ----------------------------

@torch.library.custom_op('fsw_gnn_tpu_torch::fsw_rank_aggregate',
                         mutates_args=(), device_types='cpu')
def _rank_op(P: Tensor, wn: Tensor, pad_norm: Tensor, freqs: Tensor,
             uniform_w: bool, with_dw: bool) -> Tensor:
    """K2's forward on the CPU: the plain version.  with_dw is for the
    backward only."""
    return fsw_rank_aggregate_plain(P, wn, pad_norm, freqs,
                                    uniform_w).contiguous()


@_rank_op.register_kernel('cuda')
def _rank_cuda(P, wn, pad_norm, freqs, uniform_w, with_dw):
    """K2f."""
    R, B, S = P.shape
    _check(list(zip(('P', 'wn', 'pad_norm', 'freqs'),
                    (P, wn, pad_norm, freqs))),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,)})
    out = torch.empty((R, S), dtype=torch.float32, device=P.device)
    if R == 0 or S == 0:
        return out
    if B == 0:
        return out.zero_()
    _launch('fsw_rank_fwd', _kernel('fsw_rank_fwd')[0], P, wn, pad_norm,
            freqs, out, R, B, S, int(bool(uniform_w)))
    _count(fsw_rank_aggregate)
    return out


@_rank_op.register_fake
def _rank_fake(P, wn, pad_norm, freqs, uniform_w, with_dw):
    return P.new_empty((P.shape[0], P.shape[2]))


@torch.library.custom_op('fsw_gnn_tpu_torch::fsw_rank_aggregate_bwd',
                         mutates_args=(), device_types='cpu')
def _rank_bwd_op(P: Tensor, wn: Tensor, pad_norm: Tensor, freqs: Tensor,
                 g: Tensor, uniform_w: bool, with_dw: bool
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """K2's backward on the CPU: the plain version; dwn and dpad empty
    without with_dw."""
    return _outs(fsw_rank_aggregate_bwd_plain(
        P, wn, pad_norm, freqs, g, uniform_w=uniform_w, with_dw=with_dw), P)


@_rank_bwd_op.register_kernel('cuda')
def _rank_bwd_cuda(P, wn, pad_norm, freqs, g, uniform_w, with_dw):
    """K2b."""
    R, B, S = P.shape
    _check(list(zip(('P', 'wn', 'pad_norm', 'freqs', 'g'),
                    (P, wn, pad_norm, freqs, g))),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,), 'g': (R, S)})
    f32 = dict(dtype=torch.float32, device=P.device)
    dP = torch.empty((R, B, S), **f32)
    df = torch.empty((S,), **f32)
    dwn = torch.empty((R, B) if with_dw else (0,), **f32)
    dpad = torch.empty((R,) if with_dw else (0,), **f32)
    if R == 0 or B == 0 or S == 0:
        return tuple(t.zero_() for t in (dP, dwn, dpad, df))
    fn, aux = _kernel('fsw_rank_bwd')
    ws = torch.empty((aux['workspace_bytes'](R, B, S, int(with_dw)),),
                     dtype=torch.uint8, device=P.device)
    _launch('fsw_rank_bwd', fn, P, wn, pad_norm, freqs, g, dP,
            dwn if with_dw else None, dpad if with_dw else None, df, ws,
            R, B, S, int(bool(uniform_w)), int(bool(with_dw)))
    _count(fsw_rank_aggregate_bwd)
    return dP, dwn, dpad, df


@_rank_bwd_op.register_fake
def _rank_bwd_fake(P, wn, pad_norm, freqs, g, uniform_w, with_dw):
    R, B, S = P.shape
    return (P.new_empty((R, B, S)), P.new_empty((R, B) if with_dw else (0,)),
            P.new_empty((R,) if with_dw else (0,)), P.new_empty((S,)))


def fsw_rank_aggregate_bwd(P, wn, pad_norm, freqs, g,
                           uniform_w: bool = False, with_dw: bool = True):
    """K2's backward on P's device: (dP, dwn, dpad, df), dwn and dpad None
    without with_dw.  CPU tensors: the plain version.  CUDA tensors:
    kernel K2b (float32, contiguous), or an error; each launch adds one to
    `fsw_rank_aggregate_bwd.launches`."""
    if _device(P) == 'cuda':
        _fits('fsw_rank_bwd', P.shape[1], with_dw=with_dw)
    return _grads(first_op(_rank_bwd_op, P, wn, pad_norm, freqs, g,
                           bool(uniform_w), bool(with_dw)), with_dw)


def _setup(ctx, inputs, output):
    """Saves the tensor inputs only: the backward recomputes the ranks (and
    K1 the projection), as the TPU kernels do."""
    *tensors, uniform_w, with_dw = inputs
    ctx.save_for_backward(*tensors)
    ctx.uniform_w, ctx.with_dw = uniform_w, with_dw


def _backward(bwd):
    """The forward op's backward: `bwd` (a public backward) on the saved
    inputs, with_dw only where wn or pad_norm takes a gradient."""
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        n = len(ctx.saved_tensors)
        if not any(need[:n]):
            return (None,) * (n + 2)
        with_dw = ctx.with_dw and (need[1] or need[2])
        grads = bwd(*ctx.saved_tensors, g.contiguous(),
                    uniform_w=ctx.uniform_w, with_dw=with_dw)
        return tuple(t if w else None for t, w in zip(grads, need)) + (
            None, None)
    return backward


_rank_op.register_autograd(_backward(fsw_rank_aggregate_bwd),
                           setup_context=_setup)


def fsw_rank_aggregate(P, wn, pad_norm, freqs, uniform_w: bool = False,
                       with_dw: bool = True):
    """P (R, B, S) per-entry projections; wn (R, B) normalized weights;
    pad_norm (R,) phantom-mass shift; freqs (S,).  Returns (R, S),
    differentiable in P, wn, pad_norm and freqs.

    CPU tensors: the plain versions.  CUDA tensors: kernels K2f and K2b
    (float32, contiguous), or an error; each forward launch adds one to
    `fsw_rank_aggregate.launches`.  with_dw=False declares wn and pad_norm
    data: their gradient is None and its loop is skipped.  uniform_w
    declares row-constant weights and enables their trig (see the module
    docstring); it is honoured only with with_dw=False, as in the JAX
    package: weights that take a gradient may change after the flag was
    detected."""
    if _device(P) == 'cuda':
        B = P.shape[1]
        _fits('fsw_rank_fwd', B)
        if _grads_wanted(P, wn, pad_norm, freqs):
            # refuse now a width the backward could not take
            _fits('fsw_rank_bwd', B, with_dw=with_dw and (
                wn.requires_grad or pad_norm.requires_grad))
    return first_op(_rank_op, P, wn, pad_norm, freqs,
                    bool(uniform_w) and not with_dw, bool(with_dw))


# ---- K4: the cartesian weighted-rank aggregation ---------------------------

@torch.library.custom_op('fsw_gnn_tpu_torch::fsw_rank_aggregate_cart',
                         mutates_args=(), device_types='cpu')
def _rank_cart_op(P: Tensor, wn: Tensor, pad_norm: Tensor, freqs: Tensor,
                  uniform_w: bool, with_dw: bool) -> Tensor:
    """K4's forward on the CPU: the plain version."""
    return fsw_rank_aggregate_cart_plain(P, wn, pad_norm, freqs,
                                         uniform_w).contiguous()


@_rank_cart_op.register_kernel('cuda')
def _rank_cart_cuda(P, wn, pad_norm, freqs, uniform_w, with_dw):
    """K4f."""
    R, B, S = P.shape
    F = freqs.shape[1]
    _check(list(zip(('P', 'wn', 'pad_norm', 'freqs'),
                    (P, wn, pad_norm, freqs))),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S, F)})
    out = torch.empty((R, S, F), dtype=torch.float32, device=P.device)
    if R == 0 or S == 0 or F == 0:
        return out
    if B == 0:
        return out.zero_()
    _launch('fsw_rank_cart_fwd', _kernel('fsw_rank_cart_fwd')[0], P, wn,
            pad_norm, freqs, out, R, B, S, F, int(bool(uniform_w)))
    _count(fsw_rank_aggregate_cart)
    return out


@_rank_cart_op.register_fake
def _rank_cart_fake(P, wn, pad_norm, freqs, uniform_w, with_dw):
    return P.new_empty((P.shape[0], P.shape[2], freqs.shape[1]))


@torch.library.custom_op('fsw_gnn_tpu_torch::fsw_rank_aggregate_cart_bwd',
                         mutates_args=(), device_types='cpu')
def _rank_cart_bwd_op(P: Tensor, wn: Tensor, pad_norm: Tensor,
                      freqs: Tensor, g: Tensor, uniform_w: bool,
                      with_dw: bool) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """K4's backward on the CPU: the plain version."""
    return _outs(fsw_rank_aggregate_cart_bwd_plain(
        P, wn, pad_norm, freqs, g, uniform_w=uniform_w, with_dw=with_dw), P)


@_rank_cart_bwd_op.register_kernel('cuda')
def _rank_cart_bwd_cuda(P, wn, pad_norm, freqs, g, uniform_w, with_dw):
    """K4b."""
    R, B, S = P.shape
    F = freqs.shape[1]
    _check(list(zip(('P', 'wn', 'pad_norm', 'freqs', 'g'),
                    (P, wn, pad_norm, freqs, g))),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S, F),
            'g': (R, S, F)})
    unif = bool(uniform_w) and not with_dw
    f32 = dict(dtype=torch.float32, device=P.device)
    dP = torch.empty((R, B, S), **f32)
    df = torch.empty((S, F), **f32)
    dwn = torch.empty((R, B) if with_dw else (0,), **f32)
    dpad = torch.empty((R,) if with_dw else (0,), **f32)
    if R == 0 or B == 0 or S == 0 or F == 0:
        return tuple(t.zero_() for t in (dP, dwn, dpad, df))
    fn, aux = _kernel('fsw_rank_cart_bwd')
    ws = torch.empty((aux['workspace_bytes'](R, B, S, F, int(with_dw)),),
                     dtype=torch.uint8, device=P.device)
    _launch('fsw_rank_cart_bwd', fn, P, wn, pad_norm, freqs, g, dP,
            dwn if with_dw else None, dpad if with_dw else None, df, ws,
            R, B, S, F, int(unif), int(bool(with_dw)))
    _count(fsw_rank_aggregate_cart_bwd)
    return dP, dwn, dpad, df


@_rank_cart_bwd_op.register_fake
def _rank_cart_bwd_fake(P, wn, pad_norm, freqs, g, uniform_w, with_dw):
    R, B, S = P.shape
    return (P.new_empty((R, B, S)), P.new_empty((R, B) if with_dw else (0,)),
            P.new_empty((R,) if with_dw else (0,)),
            P.new_empty((S, freqs.shape[1])))


def fsw_rank_aggregate_cart_bwd(P, wn, pad_norm, freqs, g,
                                uniform_w: bool = False,
                                with_dw: bool = True):
    """K4's backward on P's device: (dP, dwn, dpad, df), df (S, F), dwn and
    dpad None without with_dw.  CPU tensors: the plain version.  CUDA
    tensors: kernel K4b (float32, contiguous), or an error; each launch
    adds one to `fsw_rank_aggregate_cart_bwd.launches`."""
    if _device(P) == 'cuda':
        _fits('fsw_rank_cart_bwd', P.shape[1], freqs.shape[1], with_dw,
              bool(uniform_w) and not with_dw)
    return _grads(first_op(_rank_cart_bwd_op, P, wn, pad_norm, freqs, g,
                           bool(uniform_w), bool(with_dw)), with_dw)


_rank_cart_op.register_autograd(_backward(fsw_rank_aggregate_cart_bwd),
                                setup_context=_setup)


def fsw_rank_aggregate_cart(P, wn, pad_norm, freqs, uniform_w: bool = False,
                            with_dw: bool = True):
    """Cartesian mode: P (R, B, S) per-entry projections; wn (R, B)
    normalized weights; pad_norm (R,) phantom-mass shift; freqs (S, F) the
    frequency rows of the slices (usually identical; per-slice rows work
    too).  Returns (R, S, F) including the (1 + f) factor, differentiable
    in P, wn, pad_norm and freqs.  The rank loop runs once and serves all
    F frequencies.

    CPU tensors: the plain versions.  CUDA tensors: kernels K4f and K4b
    (float32, contiguous), or an error; each forward launch adds one to
    `fsw_rank_aggregate_cart.launches`.  with_dw and uniform_w as in
    `fsw_rank_aggregate`."""
    unif = bool(uniform_w) and not with_dw
    if _device(P) == 'cuda':
        B, F = P.shape[1], freqs.shape[1]
        _fits('fsw_rank_cart_fwd', B, F)
        if _grads_wanted(P, wn, pad_norm, freqs):
            # refuse now a width the backward could not take
            _fits('fsw_rank_cart_bwd', B, F, with_dw and (
                wn.requires_grad or pad_norm.requires_grad), unif)
    return first_op(_rank_cart_op, P, wn, pad_norm, freqs, unif,
                    bool(with_dw))


# ---- K1: the fused-projection weighted-rank aggregation --------------------

@torch.library.custom_op('fsw_gnn_tpu_torch::fsw_rank_aggregate_proj',
                         mutates_args=(), device_types='cpu')
def _rank_proj_op(Z: Tensor, wn: Tensor, pad_norm: Tensor, freqs: Tensor,
                  V: Tensor, uniform_w: bool, with_dw: bool) -> Tensor:
    """K1's forward on the CPU: the plain version."""
    return fsw_rank_aggregate_proj_plain(Z, wn, pad_norm, freqs, V,
                                         uniform_w=uniform_w).contiguous()


@_rank_proj_op.register_kernel('cuda')
def _rank_proj_cuda(Z, wn, pad_norm, freqs, V, uniform_w, with_dw):
    """K1f."""
    args = (Z, wn, pad_norm, freqs, V)
    R, B, D = Z.shape
    S = V.shape[1]
    _check(list(zip(('Z', 'wn', 'pad_norm', 'freqs', 'V'), args)),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,), 'V': (D, S)})
    out = torch.empty((R, S), dtype=torch.float32, device=Z.device)
    if R == 0 or S == 0:
        return out
    if B == 0:
        return out.zero_()
    _launch('fsw_rank_fwdp', _kernel('fsw_rank_fwdp')[0], *args, out,
            R, B, D, S, int(bool(uniform_w)))
    _count(fsw_rank_aggregate_proj)
    return out


@_rank_proj_op.register_fake
def _rank_proj_fake(Z, wn, pad_norm, freqs, V, uniform_w, with_dw):
    return Z.new_empty((Z.shape[0], V.shape[1]))


@torch.library.custom_op('fsw_gnn_tpu_torch::fsw_rank_aggregate_proj_bwd',
                         mutates_args=(), device_types='cpu')
def _rank_proj_bwd_op(Z: Tensor, wn: Tensor, pad_norm: Tensor,
                      freqs: Tensor, V: Tensor, g: Tensor, uniform_w: bool,
                      with_dw: bool
                      ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K1's backward on the CPU: the plain version."""
    return _outs(fsw_rank_aggregate_proj_bwd_plain(
        Z, wn, pad_norm, freqs, V, g, uniform_w=uniform_w,
        with_dw=with_dw), Z)


@_rank_proj_bwd_op.register_kernel('cuda')
def _rank_proj_bwd_cuda(Z, wn, pad_norm, freqs, V, g, uniform_w, with_dw):
    """K1b."""
    args = (Z, wn, pad_norm, freqs, V, g)
    R, B, D = Z.shape
    S = V.shape[1]
    _check(list(zip(('Z', 'wn', 'pad_norm', 'freqs', 'V', 'g'), args)),
           {'wn': (R, B), 'pad_norm': (R,), 'freqs': (S,), 'V': (D, S),
            'g': (R, S)})
    f32 = dict(dtype=torch.float32, device=Z.device)
    dZ = torch.empty((R, B, D), **f32)
    df = torch.empty((S,), **f32)
    dV = torch.empty((D, S), **f32)
    dwn = torch.empty((R, B) if with_dw else (0,), **f32)
    dpad = torch.empty((R,) if with_dw else (0,), **f32)
    if R == 0 or B == 0 or S == 0 or D == 0:
        return tuple(t.zero_() for t in (dZ, dwn, dpad, df, dV))
    fn, aux = _kernel('fsw_rank_bwdp')
    ws = torch.empty((aux['workspace_bytes'](R, B, D, S, int(with_dw)),),
                     dtype=torch.uint8, device=Z.device)
    _launch('fsw_rank_bwdp', fn, *args, dZ, dwn if with_dw else None,
            dpad if with_dw else None, df, dV, ws,
            R, B, D, S, int(bool(uniform_w)), int(bool(with_dw)))
    _count(fsw_rank_aggregate_proj_bwd)
    return dZ, dwn, dpad, df, dV


@_rank_proj_bwd_op.register_fake
def _rank_proj_bwd_fake(Z, wn, pad_norm, freqs, V, g, uniform_w, with_dw):
    R, B, D = Z.shape
    return (Z.new_empty((R, B, D)), Z.new_empty((R, B) if with_dw else (0,)),
            Z.new_empty((R,) if with_dw else (0,)),
            Z.new_empty((V.shape[1],)), Z.new_empty(tuple(V.shape)))


def fsw_rank_aggregate_proj_bwd(Z, wn, pad_norm, freqs, V, g,
                                uniform_w: bool = False,
                                with_dw: bool = True):
    """K1's backward on Z's device: (dZ, dwn, dpad, df, dV), dwn and dpad
    None without with_dw.  CPU tensors: the plain version.  CUDA tensors:
    kernel K1b (float32, contiguous), or an error; each launch adds one to
    `fsw_rank_aggregate_proj_bwd.launches`."""
    if _device(Z) == 'cuda':
        _fits('fsw_rank_bwdp', Z.shape[1], with_dw=with_dw)
    return _grads(first_op(_rank_proj_bwd_op, Z, wn, pad_norm, freqs, V, g,
                           bool(uniform_w), bool(with_dw)), with_dw)


_rank_proj_op.register_autograd(_backward(fsw_rank_aggregate_proj_bwd),
                                setup_context=_setup)


def fsw_rank_proj_projections(Z, V, kernel: str = 'fsw_rank_fwdp'):
    """P (R * B, S) = Z V, the projections K1 ranks, for checking the two
    kernels against each other: 'fsw_rank_fwdp' runs K1f's own kernel up
    to its projection and writes it out instead of ranking it,
    'fsw_rank_bwdp' runs K1b's step 1 alone.  CPU tensors: the plain
    product.  Not a path of the model, so no launch is counted."""
    R, B, D = Z.shape
    S = V.shape[1]
    if _device(Z) == 'cpu':
        return torch.einsum('rbd,ds->rbs', Z, V).reshape(R * B, S)
    _check([('Z', Z), ('V', V)], {'V': (D, S)})
    P = torch.empty((R * B, S), dtype=torch.float32, device=Z.device)
    if R and B and S:
        _launch(kernel, _kernel(kernel)[1]['project_f32'], Z, V, P, R, B, D,
                S)
    return P


def fsw_rank_aggregate_proj(Z, wn, pad_norm, freqs, V,
                            uniform_w: bool = False, with_dw: bool = True):
    """Z (R, B, D) gathered sender rows; wn (R, B) normalized weights;
    pad_norm (R,) phantom-mass shift; freqs (S,); V (D, S) slice matrix.
    Returns (R, S), differentiable in Z, wn, pad_norm, freqs and V.

    CPU tensors: the plain versions.  CUDA tensors: kernels K1f and K1b
    (float32, contiguous), or an error; each forward launch adds one to
    `fsw_rank_aggregate_proj.launches`.  with_dw=False declares wn and
    pad_norm data: their gradient is None and its loop is skipped.
    uniform_w declares row-constant weights, honoured only with
    with_dw=False (see `fsw_rank_aggregate`)."""
    if _device(Z) == 'cuda':
        B = Z.shape[1]
        _fits('fsw_rank_fwdp', B)
        if _grads_wanted(Z, wn, pad_norm, freqs, V):
            # refuse now a width the backward could not take
            _fits('fsw_rank_bwdp', B, with_dw=with_dw and (
                wn.requires_grad or pad_norm.requires_grad))
    return first_op(_rank_proj_op, Z, wn, pad_norm, freqs, V,
                    bool(uniform_w) and not with_dw, bool(with_dw))


fsw_rank_aggregate.launches = 0
fsw_rank_aggregate_bwd.launches = 0
fsw_rank_aggregate_proj.launches = 0
fsw_rank_aggregate_proj_bwd.launches = 0
fsw_rank_aggregate_cart.launches = 0
fsw_rank_aggregate_cart_bwd.launches = 0
