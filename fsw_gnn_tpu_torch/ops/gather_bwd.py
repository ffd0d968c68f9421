"""The tables' gather backward: a sender order cut into chunks, the CUDA
kernel that sums by it, and its plain PyTorch version.

The gather `src[idx]` of a table's entries has the backward

    dX[s] = sum of dZ[e] over the entries e with idx[e] == s,

where dZ is the cotangent of the gathered rows (one row an entry).  A
table's padding entries all gather sender 0, so one sender can own a
third of a table's entries.  PyTorch's backward (`indexing_backward_kernel`)
adds each run of equal indices with one warp in series; this one cuts
every run into chunks of at most CHUNK entries and sums them in a fixed
order (csrc/gather_bwd.cu says how, and what bounds it).

`gather_order(idx, num_senders)` builds the order: the stable argsort of
`idx.ravel()` (each sender's entries in entry order), the senders' row
pointers, and the chunk list, level by level.  Level 0 has one chunk row
(sender, first, count, slot) for every piece of at most CHUNK entries of
a sender's run, and one empty chunk for a sender with no entry; `first`
indexes the order.  A sender with one chunk has slot -1 and its sum is
written to dX; the chunks of a sender that was cut write partial rows
(slot >= 0), contiguous a sender.  Each later level cuts each such
sender's partials into chunks of at most CHUNK again (`first` then
indexes the partial rows), until every sender has one chunk.  The graph
layouts (`graph.to_neighbor_table`, `to_multi_table`) build it with the
table, on the host; `embedding._gather` builds it in the call, where the
table has none.

`gather_bwd(grad, order)` sums: on CUDA tensors the kernel (float32,
float64, bfloat16; one launch a level, counted in
`gather_bwd.launches`), or an error; on CPU tensors `gather_bwd_plain`,
the same sums in the same order, so the two give the same bits.  It is the
`torch.library` op `torch.ops.fsw_gnn_tpu_torch.gather_bwd`.  `gather(src,
idx, order)` is `src[idx]`, PyTorch's gather, whose backward is
`gather_bwd`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List

import torch
from torch import Tensor

from ..kernels import KernelError
from ..utils.profiling import first_op

# the most rows one warp adds in series (csrc/gather_bwd.cu's CHUNK)
CHUNK = 128

_FN = {}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64',
           torch.bfloat16: 'bf16'}


@dataclasses.dataclass
class GatherOrder:
    """A table's entries by sender, cut into chunks (module docstring).

    perm (M,) int32, the entries sorted stably by sender; ptr (N + 1,)
    int32, sender s's entries are perm[ptr[s]:ptr[s + 1]]; chunks (K, 4)
    int32 rows (sender, first, count, slot), level l's are
    chunks[levels[l]:levels[l + 1]]; partials, the partial rows every
    level writes; split_rows, the senders whose run was cut;
    num_senders, N."""
    perm: Tensor
    ptr: Tensor
    chunks: Tensor
    levels: tuple
    partials: int
    split_rows: int
    num_senders: int

    def to(self, device) -> 'GatherOrder':
        return dataclasses.replace(self, perm=self.perm.to(device),
                                   ptr=self.ptr.to(device),
                                   chunks=self.chunks.to(device))


def gather_order(idx, num_senders: int) -> GatherOrder:
    """The order of a table's entries `idx` (any shape, numpy or a tensor)
    over `num_senders` senders, on idx's device (numpy: the CPU)."""
    flat = torch.as_tensor(idx).reshape(-1)
    perm = torch.sort(flat, stable=True).indices
    N, M = int(num_senders), flat.numel()
    if M >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f'{M} entries over {N} senders: the order holds '
                         f'int32')
    dev = flat.device
    if M and (int(flat.min()) < 0 or int(flat.max()) >= N):
        raise ValueError(f'sender ids must lie in [0, {N})')
    n = torch.bincount(flat.long(), minlength=N)
    ptr = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(n, 0)
    senders = torch.arange(N, device=dev)
    base = ptr[:-1]
    rows, levels, slots = [], [0], 0
    split_rows = int((n > CHUNK).sum())
    while True:
        k = torch.clamp((n + CHUNK - 1) // CHUNK, min=1)   # chunks a sender
        K = int(k.sum())
        owner = torch.repeat_interleave(torch.arange(len(k), device=dev), k,
                                        output_size=K)
        piece = (torch.arange(K, device=dev)
                 - (torch.cumsum(k, 0) - k)[owner])
        count = torch.clamp(n[owner] - piece * CHUNK, max=CHUNK)
        cut = k[owner] > 1
        n_cut = int(cut.sum())
        slot = torch.full((K,), -1, dtype=torch.int64, device=dev)
        slot[cut] = slots + torch.arange(n_cut, device=dev)
        rows.append(torch.stack([senders[owner], base[owner] + piece * CHUNK,
                                 count, slot], 1))
        levels.append(levels[-1] + K)
        if n_cut == 0:
            break
        keep = k > 1          # the cut senders: their partials come next
        senders, n = senders[keep], k[keep]
        base = slots + torch.cumsum(n, 0) - n
        slots += n_cut
    return GatherOrder(perm=perm.to(torch.int32), ptr=ptr.to(torch.int32),
                       chunks=torch.cat(rows).to(torch.int32),
                       levels=tuple(levels), partials=slots,
                       split_rows=split_rows, num_senders=N)


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _chunk_sums(rows_in, first, count, acc_dtype):
    """Each chunk's sum of rows_in[first + j] over j < count, from 0 in
    j's order.  A level's chunks cover one run of rows from first[0] on,
    in order; on the CPU `index_add_` adds rows into their chunk's sum one
    after another in row order (tests hold it to an explicit loop)."""
    K, D = first.shape[0], rows_in.shape[1]
    acc = torch.zeros((K, D), dtype=acc_dtype, device=rows_in.device)
    total = int(count.sum()) if K else 0
    if total:
        start = int(first[0])
        owner = torch.repeat_interleave(
            torch.arange(K, device=rows_in.device), count, output_size=total)
        acc.index_add_(0, owner, rows_in[start:start + total].to(acc_dtype))
    return acc


def gather_bwd_plain(grad, order: GatherOrder):
    """Plain PyTorch `gather_bwd`: grad (M, D) -> dX (N, D), the kernel's
    sums in the kernel's order."""
    _check_shapes(grad, order)
    return _plain(grad, order.perm, order.chunks, list(order.levels),
                  order.partials, order.num_senders)


def _plain(grad, perm, chunks, levels, partials, num_senders):
    acc_dt = _acc_dtype(grad.dtype)
    D = grad.shape[1]
    out = grad.new_empty((num_senders, D))
    part = grad.new_empty((partials, D), dtype=acc_dt)
    by_sender = grad.index_select(0, perm.long())
    for lev in range(len(levels) - 1):
        ch = chunks[levels[lev]:levels[lev + 1]].long()
        sums = _chunk_sums(by_sender if lev == 0 else part, ch[:, 1],
                           ch[:, 2], acc_dt)
        direct = ch[:, 3] < 0
        out[ch[direct, 0]] = sums[direct].to(grad.dtype)
        part[ch[~direct, 3]] = sums[~direct]
    return out


def _check_shapes(grad, order):
    if grad.dim() != 2:
        raise ValueError(f'grad must be (entries, D), got shape '
                         f'{tuple(grad.shape)}')
    if grad.shape[0] != order.perm.shape[0]:
        raise ValueError(f'{grad.shape[0]} gradient rows for an order of '
                         f'{order.perm.shape[0]} entries')


def _kernel():
    """{dtype: entry function} of the library, loaded at first use; its
    CHUNK checked against this module's."""
    if not _FN:
        from ..kernels import load
        lib = load('gather_bwd')
        lib.gather_bwd_chunk.restype = ctypes.c_int
        if lib.gather_bwd_chunk() != CHUNK:
            raise KernelError(f'gather_bwd.cu cuts chunks of '
                              f'{lib.gather_bwd_chunk()}, the order of '
                              f'{CHUNK}')
        for dt, sfx in _SUFFIX.items():
            fn = getattr(lib, f'gather_bwd_{sfx}')
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FN[dt] = fn
    return _FN


def _run(grad, perm, chunks, levels, partials, num_senders):
    """The kernel, one launch a level; raises on what it does not take."""
    dev = grad.device
    if grad.dtype not in _SUFFIX:
        raise TypeError(f'gather_bwd takes float32, float64 or bfloat16, '
                        f'got {grad.dtype}')
    for name, t in (('perm', perm), ('chunks', chunks)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, grad on {dev}')
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f'{name} must be contiguous int32')
    if not grad.is_contiguous():
        raise ValueError('grad must be contiguous')
    D = grad.shape[1]
    out = grad.new_empty((num_senders, D))
    part = grad.new_empty((max(partials, 1), D),
                          dtype=_acc_dtype(grad.dtype))
    if num_senders == 0 or D == 0:
        return out
    fn = _kernel()[grad.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lev in range(len(levels) - 1):
            k = levels[lev + 1] - levels[lev]
            rc = fn(grad.data_ptr() if lev == 0 else part.data_ptr(),
                    perm.data_ptr(), chunks[levels[lev]].data_ptr(), k,
                    out.data_ptr(), part.data_ptr(), D, int(lev > 0), stream)
            if rc != 0:
                raise KernelError(f'gather_bwd launch failed: CUDA error '
                                  f'{rc}')
            if not torch.cuda.is_current_stream_capturing():
                gather_bwd.launches += 1
    return out


@torch.library.custom_op('fsw_gnn_tpu_torch::gather_bwd', mutates_args=(),
                         device_types='cpu')
def _gather_bwd_op(grad: Tensor, perm: Tensor, chunks: Tensor,
                   levels: List[int], partials: int,
                   num_senders: int) -> Tensor:
    """grad (M, D) -> dX (num_senders, D): the plain version."""
    return _plain(grad, perm, chunks, levels, partials, num_senders)


@_gather_bwd_op.register_kernel('cuda')
def _gather_bwd_cuda(grad, perm, chunks, levels, partials, num_senders):
    return _run(grad, perm, chunks, levels, partials, num_senders)


@_gather_bwd_op.register_fake
def _gather_bwd_fake(grad, perm, chunks, levels, partials, num_senders):
    return grad.new_empty((num_senders, grad.shape[1]))


def gather_bwd(grad, order: GatherOrder):
    """dX (N, D) from the gathered rows' cotangent grad (M, D), summed by
    `order`.  CPU tensors: `gather_bwd_plain`.  CUDA tensors: the kernel,
    or an error; each launch adds one to `gather_bwd.launches`."""
    _check_shapes(grad, order)
    return first_op(_gather_bwd_op, grad, order.perm, order.chunks,
                    list(order.levels), order.partials, order.num_senders)


gather_bwd.launches = 0


class _Gather(torch.autograd.Function):
    """src[idx] forward; `gather_bwd` by the order backward."""

    @staticmethod
    def forward(ctx, src, idx, order):
        ctx.order, ctx.shape = order, src.shape
        return src[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        rows = ctx.order.perm.shape[0]
        dx = gather_bwd(g.reshape(rows, -1).contiguous(), ctx.order)
        return dx.reshape(ctx.shape), None, None


def gather(src, idx, order: GatherOrder):
    """src[idx], PyTorch's gather, differentiable in src by `gather_bwd`
    on `order` (`gather_order(idx, src.shape[0])`)."""
    if order.num_senders != src.shape[0]:
        raise ValueError(f'an order over {order.num_senders} senders for '
                         f'{src.shape[0]} source rows')
    return _Gather.apply(src, idx, order)
