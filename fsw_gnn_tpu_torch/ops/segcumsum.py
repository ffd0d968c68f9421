"""The segmented inclusive cumsum (kernel K3) and its plain PyTorch version.

Counterpart of fsw_gnn_tpu/ops/segcumsum_pallas.py.  For a flat array of
values and contiguous segments (sorted ids, or an int8 is_end mask with 1
on the last element of each segment),

    out[i] = sum of values[j] over the j <= i in i's segment,

restarted at every segment start, so the rounding error is about eps times
the segment's prefix, not eps times the global prefix.

`segcumsum` runs the CUDA kernel (csrc/segcumsum.cu, which says what bounds
it and how it is built) on CUDA tensors and `segcumsum_plain` on CPU
tensors; on the card it never falls back.  It is a torch.autograd.Function:
the gradient of an inclusive segmented cumsum is the reversed segmented
cumsum of the cotangent, which the backward computes with the same kernel
on the flipped cotangent (ids flipped and negated, so still sorted, or the
mask of segment starts flipped into one of ends).

The TPU kernel's `method`, `precision`, `rows_per_block`, `nonnegative` and
`interpret` choose its tiling and its MXU precision and are not carried
over.  `max_seg_size` is accepted: the plain version stops its doubling
passes there, which is exact for an honest bound; the kernel ignores it and
is exact for any segment length.  With a bound below the longest segment
the JAX package's result is undefined (it truncates); here it stays exact
on the card and truncates in the plain version, so only honest bounds are
meaningful.
"""
from __future__ import annotations

import ctypes

import torch

_FN = {}


def segment_boundaries(segment_ids):
    """int8 is_end mask from sorted segment ids: 1 iff element i is the
    last of its segment (the final element always is)."""
    n = segment_ids.shape[0]
    mask = torch.ones(n, dtype=torch.int8, device=segment_ids.device)
    if n > 1:
        mask[:-1] = (segment_ids[1:] != segment_ids[:-1]).to(torch.int8)
    return mask


def _ids_from_mask(boundaries):
    """Segment ids 0, 1, ... from an is_end mask: the ends strictly
    before each element."""
    ends = boundaries.to(torch.int64)
    return torch.cumsum(ends, 0) - ends


def segcumsum_plain(values, segment_ids=None, *, boundaries=None,
                    max_seg_size=None):
    """Plain PyTorch K3: a log-depth doubling scan masked by segment
    equality (the numerics of the JAX package's restart scan).  values
    (n,) of any float dtype; exactly one of segment_ids (n,) or
    boundaries (n,)."""
    ids = _ids(values, segment_ids, boundaries)
    n = values.shape[0]
    limit = n if max_seg_size is None else min(int(max_seg_size), n)
    out = values
    stride = 1
    while stride < limit:
        same = ids[stride:] == ids[:-stride]
        out = torch.cat([out[:stride], out[stride:] + torch.where(
            same, out[:-stride], torch.zeros_like(out[stride:]))])
        stride *= 2
    return out


def _segments(values, segment_ids, boundaries):
    """The one segment argument given, after checking the shapes."""
    if (segment_ids is None) == (boundaries is None):
        raise ValueError('give exactly one of segment_ids and boundaries')
    if values.dim() != 1:
        raise ValueError(f'values must be flat, got shape '
                         f'{tuple(values.shape)}')
    given = segment_ids if segment_ids is not None else boundaries
    if given.shape != values.shape:
        raise ValueError(f'{tuple(given.shape)} segment entries for '
                         f'{tuple(values.shape)} values')
    return given


def _ids(values, segment_ids, boundaries):
    _segments(values, segment_ids, boundaries)
    return segment_ids if segment_ids is not None else _ids_from_mask(
        boundaries)


def _kernel(dtype):
    """(entry function, workspace-bytes function) of the K3 library."""
    if not _FN:
        from ..kernels import load
        lib = load('segcumsum')
        for name, dt in (('segcumsum_f32', torch.float32),
                         ('segcumsum_f64', torch.float64)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FN[dt] = fn
        ws = lib.segcumsum_workspace_bytes
        ws.argtypes = [ctypes.c_longlong, ctypes.c_int]
        ws.restype = ctypes.c_size_t
        _FN['ws'] = ws
    return _FN[dtype], _FN['ws']


def _run(values, segment_ids, boundaries, max_seg_size):
    """K3 forward on values' device: plain on the CPU, the kernel on the
    card (float32 or float64, contiguous), or an error."""
    dev = values.device
    if dev.type == 'cpu':
        return segcumsum_plain(values, segment_ids, boundaries=boundaries,
                               max_seg_size=max_seg_size)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    seg = _segments(values, segment_ids, boundaries)
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'values must be float32 or float64, got '
                        f'{values.dtype}')
    if seg.device != dev:
        raise ValueError(f'segments on {seg.device}, values on {dev}')
    if not (values.is_contiguous() and seg.is_contiguous()):
        raise ValueError('values and segments must be contiguous')
    if segment_ids is not None:
        if segment_ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f'segment_ids must be int32 or int64, got '
                            f'{segment_ids.dtype}')
        ids, end = segment_ids.to(torch.int32), None
    else:
        if boundaries.dtype not in (torch.int8, torch.uint8, torch.bool):
            raise TypeError(f'boundaries must be int8, uint8 or bool, got '
                            f'{boundaries.dtype}')
        ids, end = None, boundaries.view(torch.int8)
    n = values.shape[0]
    out = torch.empty_like(values)
    if n == 0:
        return out
    fn, ws_bytes = _kernel(values.dtype)
    ws = torch.empty((ws_bytes(n, values.element_size()),),
                     dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = fn(values.data_ptr(), None if ids is None else ids.data_ptr(),
                None if end is None else end.data_ptr(), out.data_ptr(),
                ws.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'segcumsum launch failed: CUDA error {rc}')
    segcumsum.launches += 1
    return out


class _SegCumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, boundaries, max_seg_size):
        ctx.save_for_backward(segment_ids, boundaries)
        ctx.max_seg_size = max_seg_size
        return _run(values, segment_ids, boundaries, max_seg_size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        segment_ids, boundaries = ctx.saved_tensors
        if segment_ids is not None:
            ids_r, mask_r = -segment_ids.flip(0), None
        else:
            # the flipped array ends where the original starts
            starts = torch.ones_like(boundaries)
            starts[1:] = boundaries[:-1]
            ids_r, mask_r = None, starts.flip(0)
        dv = _run(g.flip(0).contiguous(), ids_r, mask_r, ctx.max_seg_size)
        return dv.flip(0), None, None, None


def segcumsum(values, segment_ids=None, *, boundaries=None,
              max_seg_size=None):
    """Segmented inclusive cumsum of flat `values` (n,), with segments
    given by sorted `segment_ids` (n,) or by an is_end mask `boundaries`
    (n,) (see `segment_boundaries`).  CPU tensors: `segcumsum_plain`.
    CUDA tensors: kernel K3 (float32 or float64), or an error; each launch
    adds one to `segcumsum.launches`.  Differentiable in `values`."""
    return _SegCumsum.apply(values, segment_ids, boundaries, max_seg_size)


segcumsum.launches = 0
