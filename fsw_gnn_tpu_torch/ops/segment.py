"""Segmented primitives on the CSR-segment layout.

Counterpart of fsw_gnn_tpu/ops/segment.py.  All graph data lives in a flat
edge array sorted by segment id (the recipient), with `row_ptr` marking
segment starts, so the segmented operations are gathers, sorts and scans
over the edges.

`segment_cumsum(method='restart')` is kernel K3 (ops/segcumsum.py) on CUDA
tensors and its plain version on CPU tensors.  The sorts are torch's
stable sorts (the JAX package sorts with `lax.sort` outside any kernel).

As in the JAX package, the gathers, sorts and sums of the CSR path are
`torch.autograd.Function`s whose backward is a gather or a sorted
segment-sum, never a scatter-add: no float atomics, so the same inputs give
the same gradient bits on every call.
  * `segment_sum` (sorted ids) backs up through a gather by the ids, and
    `segment_expand` (a gather by sorted ids) through `segment_sum`;
  * `rows_gather` backs up through a gather by the host-sorted order of
    its indices and a sorted segment-sum;
  * `permutation_gather` backs up through a gather by the inverse
    permutation;
  * `segment_sort_fused`, `sort_pairs_fused` and `sort_keys_fused` unsort
    their cotangents by a gather through the inverse permutation (the JAX
    package unsorts by a second sort, the faster move on a TPU; it
    computes the same values).
A sorted segment-sum is `torch.segment_reduce(..., 'sum')`, which adds each
segment's values in a fixed order with no atomics (on the card, one thread
a segment along a row, or cub's segmented reduce on a flat array; the JAX
package computes `segment_sum` outside any kernel too).  Its run lengths
(`segment_lengths`) are passed in by a caller that sums by the same ids
more than once, as the CSR path does (from the graph's row_ptr).
"""
from __future__ import annotations

import math

import torch

from .segcumsum import segcumsum, segcumsum_rows, segment_boundaries


def segment_cumsum(values, segment_ids, row_ptr=None,
                   num_segments=None, method: str = 'restart'):
    """Inclusive cumulative sum within each segment along axis 0 of values
    (n, ...); `segment_ids` (n,) sorted.

    method='restart' (default): restarted at every segment start, the
    rounding error about eps times the segment's prefix (K3 on the card;
    any trailing dimensions are laid out as rows of one call of its row
    form over the shared is_end mask).
    method='global': one global cumsum minus each segment's exclusive
    prefix at its start, the error about eps times the global prefix."""
    n = values.shape[0]
    if method == 'restart':
        if values.dim() == 1:
            return segcumsum(values.contiguous(), segment_ids)
        k = math.prod(values.shape[1:])
        cols = values.reshape(n, k).t().contiguous()
        out = segcumsum_rows(cols, segment_boundaries(segment_ids))
        return out.t().reshape(values.shape)
    if method != 'global':
        raise ValueError(f"method must be 'restart' or 'global', "
                         f"got {method!r}")
    incl = torch.cumsum(values, dim=0)
    excl = torch.cat([values.new_zeros((1,) + values.shape[1:]), incl[:-1]])
    if row_ptr is not None:
        base = excl[torch.clamp(row_ptr[:-1].long(), 0, max(n - 1, 0))]
        return incl - base[segment_ids.long()]
    is_start = torch.ones(n, dtype=torch.bool, device=values.device)
    is_start[1:] = segment_ids[1:] != segment_ids[:-1]
    idx = torch.arange(n, device=values.device)
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return incl - excl[start_idx]


def segment_lengths(segment_ids, num_segments: int):
    """Lengths (num_segments,) of the runs of sorted `segment_ids`, found by
    binary search (ids outside [0, num_segments) fall in no segment).  A CSR
    graph's recipients have theirs as torch.diff(row_ptr); a caller that
    sums or gathers by the same ids more than once computes them once and
    passes them in."""
    return torch.diff(_bounds(segment_ids, num_segments))


def _bounds(ids, num_segments: int):
    """The first position of each id 0 .. num_segments in sorted `ids`."""
    ids = ids.contiguous()
    return torch.searchsorted(ids, torch.arange(
        num_segments + 1, dtype=ids.dtype, device=ids.device))


def _sum_runs(values, lengths, dim: int):
    """Sum of consecutive runs of `lengths` elements along `dim`, each run
    added in a fixed order."""
    if dim:
        lengths = lengths.expand(values.shape[:dim]
                                 + lengths.shape).contiguous()
    return torch.segment_reduce(values, 'sum', lengths=lengths, axis=dim,
                                unsafe=True)


# `lead` below says that the first run of `lengths` holds the ids below 0,
# which fall in no segment: the sum drops its entry, and the gather gives 0
# to every id outside [0, num_segments), as JAX's segment_sum and its
# gather-with-fill transpose do.  Ids past the last segment fall after the
# last run, where neither reads.

class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, ids, lengths, dim, lead):
        ctx.save_for_backward(ids, lengths)
        ctx.dim, ctx.lead = dim, lead
        out = _sum_runs(values, lengths, dim)
        if lead:
            out = out.narrow(dim, 1, out.shape[dim] - 1).contiguous()
        return out

    @staticmethod
    def backward(ctx, g):
        ids, lengths = ctx.saved_tensors
        return (_SegmentExpand.apply(g, ids, lengths, ctx.dim, ctx.lead),
                None, None, None, None)


class _SegmentExpand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, lengths, dim, lead):
        ctx.save_for_backward(ids, lengths)
        ctx.dim, ctx.lead = dim, lead
        if not lead:
            return x.index_select(dim, ids)
        n = x.shape[dim]
        shape = [1] * x.dim()
        shape[dim] = ids.shape[0]
        valid = ((ids >= 0) & (ids < n)).view(shape)
        if n == 0:
            return x.new_zeros(x.shape[:dim] + ids.shape + x.shape[dim + 1:])
        got = x.index_select(dim, ids.clamp(0, n - 1))
        return torch.where(valid, got, torch.zeros_like(got))

    @staticmethod
    def backward(ctx, g):
        ids, lengths = ctx.saved_tensors
        return (_SegmentSum.apply(g, ids, lengths, ctx.dim, ctx.lead),
                None, None, None, None)


def _runs(ids, num_segments: int, lengths):
    if lengths is None:
        return segment_lengths(ids, num_segments)
    return lengths.to(device=ids.device, dtype=torch.int64)


def _lead_runs(ids, num_segments: int, lengths):
    """(lengths, lead) for `_SegmentSum` and `_SegmentExpand`: the caller's
    lengths as they are, or, found here, the runs of every segment after a
    first run of the ids below 0."""
    if lengths is not None:
        return _runs(ids, num_segments, lengths), False
    bounds = _bounds(ids, num_segments)
    return torch.diff(bounds, prepend=bounds.new_zeros(1)), True


def segment_sum(values, segment_ids, num_segments: int, dim: int = 0,
                lengths=None):
    """Sum of `values` per segment along `dim`, for sorted `segment_ids`
    (values.shape[dim],): values.shape with num_segments at `dim`.  Ids
    outside [0, num_segments) fall in no segment, as in JAX's
    segment_sum.  `lengths`: the ids' `segment_lengths`, found here when
    not given; a caller that gives them declares every id in
    [0, num_segments) (a CSR graph's recipients).  The backward gathers the
    cotangent by the ids (0 where an id falls in no segment)."""
    ids = segment_ids.to(values.device)
    runs, lead = _lead_runs(ids, num_segments, lengths)
    return _SegmentSum.apply(values, ids, runs, dim % values.dim(), lead)


def segment_expand(x, segment_ids, dim: int = 0, lengths=None):
    """x's entry of each element's segment along `dim`, for sorted
    `segment_ids`: x.index_select(dim, segment_ids), 0 where an id lies
    outside [0, x.shape[dim]).  `lengths`: the ids' `segment_lengths`,
    found here when not given; a caller that gives them declares every id
    in range.  The backward is a sorted segment-sum of the cotangent."""
    dim = dim % x.dim()
    ids = segment_ids.to(x.device)
    runs, lead = _lead_runs(ids, x.shape[dim], lengths)
    return _SegmentExpand.apply(x, ids, runs, dim, lead)


def segment_argsort(keys, segment_ids, stable: bool = True):
    """Permutation that sorts keys ascending within each sorted segment,
    along the last axis of keys (..., n); segment_ids (n,).  The sort is
    stable (ties keep their index order, as in the JAX package's default),
    -0.0 ties with 0.0, and every NaN, whatever its sign, sorts last, as
    `lax.sort` puts them.  stable=False is accepted as in the JAX package
    and returns the stable order, which is one of the orders an unstable
    sort may give.

    float32 keys take one sort of an int64 key (segment id above the
    order-preserving bits of the float, every NaN first mapped to one
    positive quiet NaN, which orders above +inf); other dtypes two stable
    sorts, by key and then by segment id."""
    del stable
    ids = segment_ids.to(keys.device)
    if keys.dtype == torch.float32:
        bits = (keys + 0.0).view(torch.int32)           # -0.0 -> 0.0
        bits = torch.where(torch.isnan(keys), _QNAN_BITS, bits)
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)    # signed order
        key = (ids.long() << 32) + (ordered.long() + 2 ** 31)
        return torch.sort(key, dim=-1, stable=True).indices
    o1 = torch.sort(keys, dim=-1, stable=True).indices
    o2 = torch.sort(ids.long()[o1], dim=-1, stable=True).indices
    return torch.gather(o1, -1, o2)


# the positive quiet NaN's float32 bits (an integer, so that no floating
# tensor holding a NaN is made where the keys hold none)
_QNAN_BITS = 0x7FC00000


def segment_sort(keys, *carried, segment_ids, stable: bool = True):
    """Sort `keys` (n,) ascending within each segment, carrying extra
    arrays (n, ...); returns (sorted_keys, *sorted_carried).  The order is
    `segment_argsort`'s (stable=False returns the stable order too)."""
    perm = segment_argsort(keys, segment_ids, stable=stable)
    return (keys[perm],) + tuple(c[perm] for c in carried)


def invert_permutation(perm):
    """Inverse of permutations along the last axis of perm (..., n)."""
    iota = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm, iota.expand_as(perm))


class _SortGather(torch.autograd.Function):
    """Tensors of perm's shape gathered by perm along the last axis; the
    backward gathers each cotangent by the inverse permutation."""

    @staticmethod
    def forward(ctx, perm, *xs):
        ctx.save_for_backward(perm)
        outs = tuple(x.gather(-1, perm) for x in xs)
        # an output whose input takes no gradient takes none either (the
        # CSR path's sorted weights then need no K3 backward)
        ctx.mark_non_differentiable(*(o for o, need in zip(
            outs, ctx.needs_input_grad[1:]) if not need))
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        perm, = ctx.saved_tensors
        inv = invert_permutation(perm)
        return (None,) + tuple(None if g is None else g.gather(-1, inv)
                               for g in gs)


def segment_sort_fused(keys, carried, segment_ids):
    """Segmented sort of keys (..., n) along the last axis within the
    segments of sorted `segment_ids` (n,), carrying `carried` (keys' shape,
    or broadcast to it); returns (sorted_keys, sorted_carried).  The
    backward unsorts the cotangents by a gather."""
    perm = segment_argsort(keys, segment_ids)
    return _SortGather.apply(perm, keys, carried.expand_as(keys))


def sort_pairs_fused(keys, carried):
    """Stable ascending sort of keys along the last axis, carrying
    `carried` (keys' shape); returns (sorted_keys, sorted_carried).  The
    backward unsorts the cotangents by a gather."""
    perm = torch.sort(keys, dim=-1, stable=True).indices
    return _SortGather.apply(perm, keys, carried)


def sort_keys_fused(keys):
    """Stable ascending sort of keys along the last axis, whose backward
    unsorts the cotangent by a gather."""
    perm = torch.sort(keys, dim=-1, stable=True).indices
    return _SortGather.apply(perm, keys)[0]


class _PermutationGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inv_perm, = ctx.saved_tensors
        return g.index_select(0, inv_perm), None, None


def permutation_gather(x, perm, inv_perm=None):
    """x[perm] along axis 0, whose backward gathers by `inv_perm` (the
    inverse of perm; found here when not given)."""
    perm = perm.to(x.device).long()
    inv_perm = (invert_permutation(perm) if inv_perm is None
                else inv_perm.to(x.device).long())
    return _PermutationGather.apply(x, perm, inv_perm)


class _RowsGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, idx_order, lengths, dim):
        ctx.save_for_backward(idx_order, lengths)
        ctx.dim = dim
        return x.index_select(dim, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx_order, lengths = ctx.saved_tensors
        d = _sum_runs(g.index_select(ctx.dim, idx_order), lengths, ctx.dim)
        return d, None, None, None, None


def rows_gather(num_rows: int, x, idx, idx_order=None, idx_sorted=None, *,
                dim: int = 0, lengths=None):
    """x.index_select(dim, idx), x having num_rows entries along `dim`.
    The backward sums the cotangent per row: a gather by `idx_order` (the
    stable order sorting idx, `idx_sorted` = idx[idx_order], as a graph
    carries them in `src_order`, `src_sorted`; found here when not given)
    and a sorted segment-sum over `lengths`, idx_sorted's
    `segment_lengths` (found here when not given)."""
    dim = dim % x.dim()
    if x.shape[dim] != num_rows:
        raise ValueError(f'x has {x.shape[dim]} rows, num_rows={num_rows}')
    idx = idx.to(x.device)
    if idx_order is None:
        idx_sorted, idx_order = torch.sort(idx, stable=True)
    idx_order, idx_sorted = idx_order.to(x.device), idx_sorted.to(x.device)
    return _RowsGather.apply(x, idx, idx_order,
                             _runs(idx_sorted, num_rows, lengths), dim)


def sort_perm_by_segmented_keys(keys, segment_ids):
    """(perm, inv_perm) ordering keys ascending within sorted segments."""
    perm = segment_argsort(keys, segment_ids)
    return perm, invert_permutation(perm)


def row_ptr_to_segment_ids(row_ptr, num_edges: int):
    """Per-edge segment ids (int32) from CSR row pointers."""
    e = torch.arange(num_edges, dtype=row_ptr.dtype, device=row_ptr.device)
    return torch.searchsorted(row_ptr[1:].contiguous(), e,
                              right=True).to(torch.int32)


def segment_ids_to_row_ptr(segment_ids, num_segments: int):
    """CSR row pointers (int32) from sorted per-edge segment ids."""
    counts = torch.bincount(segment_ids.long(), minlength=num_segments)
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0)]).to(torch.int32)
