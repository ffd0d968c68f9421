"""Input validation: host-side checks at ingestion, and `checkify_embed`.

Counterpart of `fsw_gnn_tpu/utils/validate.py`, with its assertions and
messages.  The validators take numpy arrays or tensors on any device and
read tensors on the host: a check at data ingestion, not on the hot path.

`checkify_embed(fn)` is the counterpart of the JAX package's
`checkify.float_checks` wrapper: every op `fn` runs (the port's kernel
ops, K1f ... K3, included) passes through a `TorchDispatchMode` that
raises `FloatCheckError` at the first op whose floating output holds a
NaN, or whose divisor holds a zero (JAX's `div_checks` flag every
division, integer or floating), naming the op.  It is a debugging
wrapper: on the card it waits for each op, and it refuses to run while a
CUDA graph is being captured.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _host(a):
    """numpy view of an array or a tensor (copied to the host; 2-byte
    floats widened to float32, which numpy can hold)."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.is_floating_point() and t.element_size() == 2:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(a)


def _check(ok, msg):
    """The JAX package's `assert`, kept under `python -O`."""
    if not ok:
        raise AssertionError(msg)


def validate_multiset_inputs(X, W=None):
    X = _host(X)
    _check(X.ndim >= 2, 'X must have rank >= 2 (..., n, d_in)')
    _check(np.isfinite(X).all(), 'X must be finite (no NaN/inf)')
    if W is not None:
        W = _host(W)
        _check(W.shape == X.shape[:-1],
               f'W shape {W.shape} must equal X.shape[:-1] {X.shape[:-1]}')
        _check(np.isfinite(W).all(), 'W must be finite')
        _check((W >= 0).all(), 'all weights must be nonnegative')


def validate_edge_index(edge_index, num_nodes: int):
    ei = _host(edge_index)
    _check(ei.ndim == 2 and ei.shape[0] == 2, 'edge_index must be (2, E)')
    _check(ei.min(initial=0) >= 0, 'negative node ids')
    _check(ei.max(initial=-1) < num_nodes, 'node id out of range')


def validate_graph(graph):
    """Invariants of the CSR layout (`graph.Graph`)."""
    dst = _host(graph.dst)
    row_ptr = _host(graph.row_ptr)
    w = _host(graph.weight)
    _check((np.diff(dst) >= 0).all(), 'dst must be sorted non-decreasing')
    _check(row_ptr[0] == 0 and row_ptr[-1] == dst.shape[0], 'bad row_ptr')
    _check((np.diff(row_ptr) >= 0).all(), 'row_ptr must be non-decreasing')
    counts = np.bincount(dst, minlength=graph.num_recipients)
    np.testing.assert_array_equal(counts, np.diff(row_ptr))
    _check(np.isfinite(w).all(), 'weights must be finite')
    _check((w >= 0).all(), 'weights must be nonnegative')
    _check((w[graph.num_edges:] == 0).all(), 'padding must carry zero weight')


class FloatCheckError(RuntimeError):
    """A NaN or a division by zero found by `checkify_embed`."""


_aten = torch.ops.aten
# the divisions JAX's div_checks see (its div primitive; a remainder is
# checked for the NaN it makes, as JAX does); the divisor is argument 1
_DIVISIONS = frozenset((
    _aten.div.Tensor, _aten.div.Scalar, _aten.div.Tensor_mode,
    _aten.div.Scalar_mode, _aten.div_.Tensor, _aten.div_.Scalar,
    _aten.div_.Tensor_mode, _aten.div_.Scalar_mode,
    _aten.floor_divide.default, _aten.floor_divide.Scalar,
    _aten.floor_divide_.Tensor, _aten.floor_divide_.Scalar))


def _any(flags) -> bool:
    """Whether any of the 0-dim boolean tensors is true (one wait on the
    card)."""
    if not flags:
        return False
    return bool(torch.stack([f.to(flags[0].device) for f in flags]).any())


class _FloatChecks(TorchDispatchMode):
    """Raises at the first op that outputs a NaN or divides by zero."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _DIVISIONS:
            div = args[1] if len(args) > 1 else kwargs['other']
            zero = (bool((div == 0).any()) if isinstance(div, torch.Tensor)
                    else div == 0)
            if zero:
                raise FloatCheckError(f'division by zero in {func}')
        out = func(*args, **kwargs)
        flags = [torch.isnan(t).any() for t in tree_leaves(out)
                 if isinstance(t, torch.Tensor) and t.is_floating_point()
                 and t.numel() > 0]
        if _any(flags):
            raise FloatCheckError(f'NaN generated by {func}')
        return out


def checkify_embed(fn):
    """Wrap an embed call (or any function of tensors) so that a NaN
    produced inside it, or a division by zero, raises `FloatCheckError`
    naming the op, instead of propagating.  Only the call itself is
    checked (a later backward is not).  Raises a RuntimeError when called
    while the current CUDA stream captures a graph."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError('checkify_embed waits for every op and '
                               'cannot run inside a CUDA graph capture')
        with _FloatChecks():
            return fn(*args, **kwargs)
    return wrapped
