"""Host-side neighbor sampler for minibatch training (GraphSAGE-style).

Counterpart of `fsw_gnn_tpu/data/sampler.py`.  The sampler runs on the
host in numpy and emits fixed-shape subgraph batches: for a seed-node batch
it samples up to `fanout` in-neighbors per hop and returns the subgraph's
nodes (seeds first, then the rest, padded to `max_nodes` with node 0), its
edges in local ids, and the seeds' labels.

One-hop sampling runs in the port's native library (`csrc/fswgraph.cpp`,
built with the host compiler at first use by `kernels.load_host`; a failed
build raises).  The numpy loop beside it is the same sampler on numpy's
generator; it runs only where `_LIB` is set to None with `_LIB_TRIED` True.
Both take values from the `np.random.Generator` in the JAX package's order,
so a seed gives the JAX package's batches bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import kernels

_LIB = None
_LIB_TRIED = False

_LL = ctypes.POINTER(ctypes.c_longlong)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of `csrc/fswgraph.cpp`."""
    lib.fsw_sample_neighbors.restype = ctypes.c_longlong
    lib.fsw_sample_neighbors.argtypes = [
        _LL,                  # row_ptr (CSC by dst)
        _LL,                  # col_idx (senders)
        _LL,                  # seeds
        ctypes.c_longlong,    # num_seeds
        ctypes.c_longlong,    # fanout
        ctypes.c_ulonglong,   # rng seed
        _LL,                  # out_src (num_seeds * fanout)
        _LL,                  # out_dst
    ]
    dd = ctypes.POINTER(ctypes.c_double)
    lib.fsw_build_csr.restype = ctypes.c_longlong
    lib.fsw_build_csr.argtypes = [
        _LL, _LL, dd,                                   # src, dst, weight
        ctypes.c_longlong, ctypes.c_longlong,           # edges, nodes
        ctypes.c_longlong,                              # recipients
        _LL, _LL, dd, _LL,                              # outputs, row_ptr
    ]
    return lib


def _load_native():
    """The bound native library, built on first use (raises when the build
    fails); None only where a caller set `_LIB` None and `_LIB_TRIED`."""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _bind(kernels.load_host('fswgraph'))
        _LIB_TRIED = True
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_LL)


@dataclasses.dataclass
class CSCGraph:
    """In-edge adjacency (CSC by destination) for host-side sampling."""
    row_ptr: np.ndarray   # (N+1,) int64: node i's in-edges at ptr[i]:ptr[i+1]
    col_idx: np.ndarray   # (E,) int64 sender of each in-edge
    num_nodes: int

    @staticmethod
    def from_edge_index(edge_index, num_nodes: int) -> 'CSCGraph':
        src = np.asarray(edge_index[0], np.int64)
        dst = np.asarray(edge_index[1], np.int64)
        order = np.argsort(dst, kind='stable')
        src, dst = src[order], dst[order]
        counts = np.bincount(dst, minlength=num_nodes)
        row_ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return CSCGraph(row_ptr=row_ptr, col_idx=src, num_nodes=num_nodes)


def _sample_one_hop(csc: CSCGraph, seeds: np.ndarray, fanout: int,
                    rng: np.random.Generator):
    """Sample up to `fanout` in-neighbors per seed.  Returns (src, dst) edge
    lists in *global* node ids; missing neighbors are dropped (not padded)
    -- padding happens at batch assembly.  The native path draws one
    integer from `rng` a call; the numpy path one `choice` per seed with
    more than `fanout` in-neighbors."""
    lib = _load_native()
    if lib is not None:
        n_seeds = len(seeds)
        out_src = np.full(n_seeds * fanout, -1, np.int64)
        out_dst = np.full(n_seeds * fanout, -1, np.int64)
        seeds64 = np.ascontiguousarray(seeds, np.int64)
        n = lib.fsw_sample_neighbors(
            _ptr(csc.row_ptr), _ptr(csc.col_idx), _ptr(seeds64), n_seeds,
            fanout, int(rng.integers(0, 2**63 - 1)), _ptr(out_src),
            _ptr(out_dst))
        return out_src[:n], out_dst[:n]
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    for s in seeds:
        lo, hi = csc.row_ptr[s], csc.row_ptr[s + 1]
        neigh = csc.col_idx[lo:hi]
        if len(neigh) > fanout:
            neigh = rng.choice(neigh, size=fanout, replace=False)
        srcs.append(neigh)
        dsts.append(np.full(len(neigh), s, np.int64))
    if not srcs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(srcs), np.concatenate(dsts)


@dataclasses.dataclass
class SampledBatch:
    """Fixed-shape minibatch subgraph.

    node_ids: (max_nodes,) global ids of the subgraph nodes (padded with 0);
    the first `num_seeds` entries are the seed nodes.
    edge_index_local: (2, E_real) edges in local ids, for
    `graph.from_edge_index`.
    """
    node_ids: np.ndarray
    num_real_nodes: int
    num_seeds: int
    edge_index_local: np.ndarray   # (2, E_real) local ids
    seed_labels: np.ndarray        # (num_seeds,)


class NeighborSampler:
    """Layered uniform neighbor sampler producing fixed-shape batches."""

    def __init__(self, edge_index, num_nodes: int,
                 fanouts: Sequence[int] = (10, 10), seed: int = 0):
        self.csc = CSCGraph.from_edge_index(edge_index, num_nodes)
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, labels: Optional[np.ndarray] = None,
               max_nodes: Optional[int] = None) -> SampledBatch:
        seeds = np.asarray(seeds, np.int64)
        if len(np.unique(seeds)) != len(seeds):
            raise ValueError('seeds must be unique')
        frontier = seeds
        all_src, all_dst = [], []
        for fanout in self.fanouts:
            s, d = _sample_one_hop(self.csc, np.unique(frontier), fanout,
                                   self.rng)
            all_src.append(s)
            all_dst.append(d)
            frontier = s
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)

        # local id space: seeds first, then the rest in id order
        uniq = np.concatenate([seeds, src, dst])
        node_ids, inv = np.unique(uniq, return_inverse=True)
        seed_pos = inv[:len(seeds)]
        rest = np.setdiff1d(np.arange(len(node_ids)), seed_pos)
        order = np.concatenate([seed_pos, rest])
        remap = np.empty(len(node_ids), np.int64)
        remap[order] = np.arange(len(node_ids))
        node_ids = node_ids[order]
        src_l = remap[inv[len(seeds):len(seeds) + len(src)]]
        dst_l = remap[inv[len(seeds) + len(src):]]

        n_real = len(node_ids)
        if max_nodes is not None:
            if n_real > max_nodes:
                raise ValueError(f'{n_real} sampled nodes exceed '
                                 f'max_nodes={max_nodes}')
            node_ids = np.concatenate(
                [node_ids, np.zeros(max_nodes - n_real, np.int64)])

        return SampledBatch(
            node_ids=node_ids, num_real_nodes=n_real, num_seeds=len(seeds),
            edge_index_local=np.stack([src_l, dst_l]),
            seed_labels=(labels[seeds] if labels is not None
                         else np.zeros(len(seeds), np.int64)))
