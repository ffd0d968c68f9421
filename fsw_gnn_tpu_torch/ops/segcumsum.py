"""The segmented inclusive cumsum (kernel K3) and its plain PyTorch version.

Counterpart of fsw_gnn_tpu/ops/segcumsum_pallas.py.  For a flat array of
values and contiguous segments (sorted ids, or an int8 is_end mask with 1
on the last element of each segment),

    out[i] = sum of values[j] over the j <= i in i's segment,

restarted at every segment start, so the rounding error is about eps times
the segment's prefix, not eps times the global prefix.  `segcumsum_rows`
scans every row of a (rows, m) array on its own over one is_end mask (m,)
that all rows share: the JAX CSR path's `jax.vmap` of the flat scan over
slices, without a copy of the mask per row.

`segcumsum` and `segcumsum_rows` run the CUDA kernel (csrc/segcumsum.cu,
which says what bounds it and how it is built) on CUDA tensors and the
plain versions on CPU tensors; on the card they never fall back.  Both are
torch.autograd.Functions: the gradient of an inclusive segmented cumsum is
the reverse segmented cumsum of the cotangent (the sum over the j >= i in
i's segment), which the kernel computes in one launch on the cotangent as
it lies.

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
_WS = {}       # (device index, stream) -> [workspace, epoch, capacity]
_EPOCHS = 1 << 30


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


def _scan_plain(values, ids, limit, reverse):
    """The doubling scan along the last axis of values (..., m), masked by
    equality of the ids (m,) that every row shares; `reverse` sums over
    the j >= i instead."""
    out = values
    stride = 1
    while stride < limit:
        same = ids[stride:] == ids[:-stride]
        head, tail = out[..., :-stride], out[..., stride:]
        if reverse:       # out[i] += out[i + stride] within i's segment
            out = torch.cat([head + torch.where(same, tail,
                                                torch.zeros_like(head)),
                             out[..., -stride:]], -1)
        else:             # out[i] += out[i - stride] within i's segment
            out = torch.cat([out[..., :stride],
                             tail + torch.where(same, head,
                                                torch.zeros_like(tail))], -1)
        stride *= 2
    return out


def segcumsum_plain(values, segment_ids=None, *, boundaries=None,
                    max_seg_size=None):
    """Plain PyTorch K3: a log-depth doubling scan masked by segment
    equality (the numerics of the JAX package's restart scan).  values
    (n,) of any float dtype; exactly one of segment_ids (n,) or
    boundaries (n,)."""
    _segments(values, segment_ids, boundaries)
    return _plain(values, segment_ids, boundaries, max_seg_size, False)


def segcumsum_rows_plain(values, boundaries, reverse=False):
    """Plain PyTorch K3 over rows: values (rows, m), each row scanned on
    its own over the is_end mask `boundaries` (m,) they share; `reverse`
    sums each element's segment suffix (the backward's scan)."""
    _rows(values, boundaries)
    return _plain(values, None, boundaries, None, reverse)


def _plain(values, segment_ids, boundaries, max_seg_size, reverse):
    """The doubling scan along the last axis of values (..., m) over the
    ids or the mask (m,), stopped at an honest `max_seg_size`."""
    ids = segment_ids if segment_ids is not None else _ids_from_mask(
        boundaries)
    m = values.shape[-1]
    limit = m if max_seg_size is None else min(int(max_seg_size), m)
    return _scan_plain(values, ids, limit, reverse)


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


def _rows(values, boundaries):
    if values.dim() != 2:
        raise ValueError(f'values must be (rows, m), got shape '
                         f'{tuple(values.shape)}')
    if boundaries.shape != values.shape[1:]:
        raise ValueError(f'{tuple(boundaries.shape)} mask entries for rows '
                         f'of {values.shape[1]}')


def _bind(lib):
    """{float32, float64, 'tiles', 'ws'}: the entry functions and the
    size functions of a K3 library (this source's C interface, also when
    built elsewhere), their C signatures set."""
    fns = {}
    for name, dt in (('segcumsum_f32', torch.float32),
                     ('segcumsum_f64', torch.float64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dt] = fn
    fns['tiles'] = lib.segcumsum_tiles
    fns['tiles'].argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    fns['tiles'].restype = ctypes.c_longlong
    fns['ws'] = lib.segcumsum_workspace_bytes
    fns['ws'].argtypes = [ctypes.c_longlong]
    fns['ws'].restype = ctypes.c_size_t
    return fns


def _kernel():
    """The K3 library's functions (`_bind`), built and loaded at first
    use."""
    if not _FN:
        from ..kernels import load
        _FN.update(_bind(load('segcumsum')))
    return _FN


def _workspace(dev, stream, tiles, ws_bytes):
    """(workspace, capacity in tiles, epoch) of the stream: zeroed once and
    kept, grown (zeroed anew) when a call needs more tiles, with a new
    epoch each call: every value the kernel publishes there carries the
    epoch, so no call has to clear it."""
    key = (dev.index, stream)
    ws = _WS.get(key)
    if ws is None or ws[2] < tiles:
        cap = max(tiles, 2 * ws[2] if ws else 0)
        ws = _WS[key] = [torch.zeros((ws_bytes(cap),), dtype=torch.uint8,
                                     device=dev), 0, cap]
    ws[1] += 1
    if ws[1] == _EPOCHS:
        ws[0].zero_()
        ws[1] = 1
    return ws[0], ws[2], ws[1]


def _run(values, segment_ids, boundaries, reverse):
    """K3 on the card: values (rows, m) float32 or float64, contiguous; the
    ids or the mask (m,) shared by every row.  Raises on what the kernel
    does not take."""
    dev = values.device
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'values must be float32 or float64, got '
                        f'{values.dtype}')
    seg = segment_ids if segment_ids is not None else boundaries
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
    rows, m = values.shape
    out = torch.empty_like(values)
    if rows == 0 or m == 0:
        return out
    fns = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, cap, epoch = _workspace(dev, stream, fns['tiles'](rows, m),
                                    fns['ws'])
        rc = fns[values.dtype](
            values.data_ptr(), None if ids is None else ids.data_ptr(),
            None if end is None else end.data_ptr(), out.data_ptr(),
            ws.data_ptr(), cap, rows, m, int(reverse), epoch, stream)
    if rc != 0:
        raise RuntimeError(f'segcumsum launch failed: CUDA error {rc}')
    segcumsum.launches += 1
    return out


def _apply(values, segment_ids, boundaries, max_seg_size, reverse):
    """values (rows, m) on its device: the plain version on the CPU, the
    kernel on the card."""
    if values.device.type == 'cpu':
        return _plain(values, segment_ids, boundaries, max_seg_size, reverse)
    return _run(values, segment_ids, boundaries, reverse)


class _SegCumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, boundaries, max_seg_size):
        ctx.save_for_backward(segment_ids, boundaries)
        ctx.max_seg_size = max_seg_size
        return _apply(values, segment_ids, boundaries, max_seg_size, False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        segment_ids, boundaries = ctx.saved_tensors
        dv = _apply(g.contiguous(), segment_ids, boundaries,
                    ctx.max_seg_size, True)
        return dv, None, None, None


def segcumsum(values, segment_ids=None, *, boundaries=None,
              max_seg_size=None):
    """Segmented inclusive cumsum of flat `values` (n,), with segments
    given by sorted `segment_ids` (n,) or by an is_end mask `boundaries`
    (n,) (see `segment_boundaries`).  CPU tensors: `segcumsum_plain`.
    CUDA tensors: kernel K3 (float32 or float64), or an error; each launch
    adds one to `segcumsum.launches`.  Differentiable in `values`."""
    _segments(values, segment_ids, boundaries)
    return _SegCumsum.apply(values[None], segment_ids, boundaries,
                            max_seg_size)[0]


def segcumsum_rows(values, boundaries):
    """Segmented inclusive cumsum of every row of `values` (rows, m) on its
    own, over the is_end mask `boundaries` (m,) that the rows share.  CPU
    tensors: `segcumsum_rows_plain`.  CUDA tensors: kernel K3 (float32 or
    float64, one launch for all rows, counted in `segcumsum.launches`), or
    an error.  Differentiable in `values`."""
    _rows(values, boundaries)
    return _SegCumsum.apply(values, None, boundaries, None)


segcumsum.launches = 0
