"""Segmented primitives on the CSR-segment layout.

Counterpart of fsw_gnn_tpu/ops/segment.py.  All graph data lives in a flat
edge array sorted by segment id (the recipient), with `row_ptr` marking
segment starts, so the segmented operations are gathers, sorts and scans
over the edges.

`segment_cumsum(method='restart')` is kernel K3 (ops/segcumsum.py) on CUDA
tensors and its plain version on CPU tensors.  The sorts are torch's
stable sorts (the JAX package sorts with `lax.sort` outside any kernel).
The JAX package gives its gathers custom backward passes that avoid
scatters on the TPU; here the gathers take autograd's own backward, which
computes the same gradients.
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


def segment_sum(values, segment_ids, num_segments: int):
    """Sum of values (n, ...) per segment: (num_segments, ...)."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add(0, segment_ids.long(), values)


def segment_argsort(keys, segment_ids):
    """Permutation that sorts keys ascending within each sorted segment,
    along the last axis of keys (..., n); segment_ids (n,).  The sort is
    stable (ties keep their index order, as in the JAX package's default),
    and -0.0 ties with 0.0.

    float32 keys take one sort of an int64 key (segment id above the
    order-preserving bits of the float); other dtypes two stable sorts,
    by key and then by segment id."""
    ids = segment_ids.to(keys.device)
    if keys.dtype == torch.float32:
        bits = (keys + 0.0).view(torch.int32)           # -0.0 -> 0.0
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)    # signed order
        key = (ids.long() << 32) + (ordered.long() + 2 ** 31)
        return torch.sort(key, dim=-1, stable=True).indices
    o1 = torch.sort(keys, dim=-1, stable=True).indices
    o2 = torch.sort(ids.long()[o1], dim=-1, stable=True).indices
    return torch.gather(o1, -1, o2)


def segment_sort(keys, *carried, segment_ids):
    """Sort `keys` (n,) ascending within each segment, carrying extra
    arrays (n, ...); returns (sorted_keys, *sorted_carried)."""
    perm = segment_argsort(keys, segment_ids)
    return (keys[perm],) + tuple(c[perm] for c in carried)


def segment_sort_fused(keys, carried, segment_ids):
    """Segmented sort of (keys, carried); returns (sorted_keys,
    sorted_carried).  Differentiable in both through autograd."""
    perm = segment_argsort(keys, segment_ids)
    return keys[perm], carried[perm]


def invert_permutation(perm):
    """Inverse of a permutation (n,)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def permutation_gather(x, perm, inv_perm=None):
    """x[perm] along axis 0.  `inv_perm` is accepted for the JAX
    signature; autograd's backward needs no inverse."""
    return x[perm.long()]


def rows_gather(num_rows: int, x, idx, idx_order=None, idx_sorted=None):
    """x[idx] along axis 0 (x has num_rows rows).  `idx_order` and
    `idx_sorted`, the host-sorted order the JAX package's scatter-free
    backward uses, are accepted for its signature; autograd's index
    backward computes the same per-row sums."""
    if x.shape[0] != num_rows:
        raise ValueError(f'x has {x.shape[0]} rows, num_rows={num_rows}')
    return x.index_select(0, idx.long())


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
