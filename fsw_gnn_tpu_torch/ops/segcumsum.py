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
plain versions on CPU tensors; on the card they never fall back.  Each is
a `torch.library` custom op (`torch.ops.fsw_gnn_tpu_torch.segcumsum` and
`.segcumsum_rows`, with a `reverse` flag), so `torch.export` and CUDA-graph
capture see one op: its CPU implementation is the plain version, its CUDA
implementation the kernel, its fake implementation gives the shape.  The
gradient of an inclusive segmented cumsum is the reverse segmented cumsum
of the cotangent (the sum over the j >= i in i's segment), the same op
with `reverse` flipped, which the kernel computes in one launch on the
cotangent as it lies.

The kernel keeps its look-back state in a workspace on the device, one per
(device, stream), made and zeroed at the first call on that stream: a call
passes nothing that changes from call to call, so a graph that captured it
replays safely (see the source).  A call captured on a stream that has no
workspace yet, or too small a one, raises: run it once on that stream
before the capture (`utils.cache.CountingGraph` warms up on its capture
stream).

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
from typing import Optional

import torch
from torch import Tensor

from ..kernels import KernelError
from ..utils.profiling import first_op

_FN = {}
# (device index, stream) -> (workspace, capacity in tiles); the workspaces
# a stream outgrew stay alive, since a captured graph may still use them
_WS = {}
_RETIRED = []


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
    ids or the mask (m,), stopped at an honest `max_seg_size`; a new
    tensor, never `values` itself."""
    ids = segment_ids if segment_ids is not None else _ids_from_mask(
        boundaries)
    m = values.shape[-1]
    limit = m if max_seg_size is None else min(int(max_seg_size), m)
    out = _scan_plain(values, ids, limit, reverse)
    return out.clone() if out is values else out


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
            ctypes.c_int, ctypes.c_void_p]
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
    """(workspace, capacity in tiles) of the stream: made and zeroed at its
    first call, made anew (zeroed, twice as large) when a call needs more
    tiles, else kept as it is (the kernel clears what the next call uses
    itself).  Raises while the stream captures a graph, where nothing may
    be made: the graph would keep a pointer to memory made outside it."""
    key = (dev.index, stream)
    ws = _WS.get(key)
    if ws is None or ws[1] < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f'segcumsum: the capturing stream has no workspace for '
                f'{tiles} tiles; run the same call once on that stream '
                f'before the capture')
        if ws is not None:
            _RETIRED.append(ws)
        cap = max(tiles, 2 * ws[1] if ws else 0)
        ws = _WS[key] = (torch.zeros((ws_bytes(cap),), dtype=torch.uint8,
                                     device=dev), cap)
    return ws


def _run(values, segment_ids, boundaries, reverse):
    """K3 on the card: values (rows, m) float32 or float64, contiguous; the
    ids or the mask (m,) shared by every row.  Raises on what the kernel
    does not take.  A launch that runs now (not one a graph captures)
    adds one to `segcumsum.launches`."""
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
        ws, cap = _workspace(dev, stream, fns['tiles'](rows, m), fns['ws'])
        rc = fns[values.dtype](
            values.data_ptr(), None if ids is None else ids.data_ptr(),
            None if end is None else end.data_ptr(), out.data_ptr(),
            ws.data_ptr(), cap, rows, m, int(reverse), stream)
        if rc != 0:
            raise KernelError(f'segcumsum launch failed: CUDA error {rc}')
        if not torch.cuda.is_current_stream_capturing():
            segcumsum.launches += 1
    return out


# ---- the custom ops: plain on the CPU, K3 on the card -----------------------

@torch.library.custom_op('fsw_gnn_tpu_torch::segcumsum', mutates_args=(),
                         device_types='cpu')
def _segcumsum_op(values: Tensor, segment_ids: Optional[Tensor],
                  boundaries: Optional[Tensor], max_seg_size: Optional[int],
                  reverse: bool) -> Tensor:
    """values (n,) over the ids or the mask (n,): the plain version."""
    return _plain(values, segment_ids, boundaries, max_seg_size, reverse)


@_segcumsum_op.register_kernel('cuda')
def _segcumsum_cuda(values, segment_ids, boundaries, max_seg_size, reverse):
    return _run(values[None], segment_ids, boundaries, reverse)[0]


@_segcumsum_op.register_fake
def _segcumsum_fake(values, segment_ids, boundaries, max_seg_size, reverse):
    return values.new_empty(values.shape)


def _setup_flat(ctx, inputs, output):
    _, segment_ids, boundaries, max_seg_size, reverse = inputs
    ctx.save_for_backward(segment_ids, boundaries)
    ctx.max_seg_size, ctx.reverse = max_seg_size, reverse


@torch.autograd.function.once_differentiable
def _backward_flat(ctx, g):
    segment_ids, boundaries = ctx.saved_tensors
    dv = _segcumsum_op(g.contiguous(), segment_ids, boundaries,
                       ctx.max_seg_size, not ctx.reverse)
    return dv, None, None, None, None


_segcumsum_op.register_autograd(_backward_flat, setup_context=_setup_flat)


@torch.library.custom_op('fsw_gnn_tpu_torch::segcumsum_rows',
                         mutates_args=(), device_types='cpu')
def _segcumsum_rows_op(values: Tensor, boundaries: Tensor,
                       reverse: bool) -> Tensor:
    """values (rows, m) over one mask (m,): the plain version."""
    return _plain(values, None, boundaries, None, reverse)


@_segcumsum_rows_op.register_kernel('cuda')
def _segcumsum_rows_cuda(values, boundaries, reverse):
    return _run(values, None, boundaries, reverse)


@_segcumsum_rows_op.register_fake
def _segcumsum_rows_fake(values, boundaries, reverse):
    return values.new_empty(values.shape)


def _setup_rows(ctx, inputs, output):
    _, boundaries, reverse = inputs
    ctx.save_for_backward(boundaries)
    ctx.reverse = reverse


@torch.autograd.function.once_differentiable
def _backward_rows(ctx, g):
    boundaries, = ctx.saved_tensors
    return (_segcumsum_rows_op(g.contiguous(), boundaries, not ctx.reverse),
            None, None)


_segcumsum_rows_op.register_autograd(_backward_rows,
                                     setup_context=_setup_rows)


def segcumsum(values, segment_ids=None, *, boundaries=None,
              max_seg_size=None):
    """Segmented inclusive cumsum of flat `values` (n,), with segments
    given by sorted `segment_ids` (n,) or by an is_end mask `boundaries`
    (n,) (see `segment_boundaries`).  CPU tensors: `segcumsum_plain`.
    CUDA tensors: kernel K3 (float32 or float64), or an error; each launch
    adds one to `segcumsum.launches`.  Differentiable in `values`."""
    _segments(values, segment_ids, boundaries)
    return first_op(_segcumsum_op, values, segment_ids, boundaries,
                    None if max_seg_size is None else int(max_seg_size),
                    False)


def segcumsum_rows(values, boundaries):
    """Segmented inclusive cumsum of every row of `values` (rows, m) on its
    own, over the is_end mask `boundaries` (m,) that the rows share.  CPU
    tensors: `segcumsum_rows_plain`.  CUDA tensors: kernel K3 (float32 or
    float64, one launch for all rows, counted in `segcumsum.launches`), or
    an error.  Differentiable in `values`."""
    _rows(values, boundaries)
    return first_op(_segcumsum_rows_op, values, boundaries, False)


segcumsum.launches = 0
