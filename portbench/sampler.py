"""A frozen copy of the program's neighbour sampler, in numpy and plain
Python, so that the reference can rebuild the batches a minibatch cell
trains on from the seed alone.

It draws what the program draws (fsw_gnn_tpu_torch/data/sampler.py with
its native library, csrc/fswgraph.cpp; train/minibatch.py), in the same
order:
  * an epoch's seeds: a permutation of the train nodes drawn from
    `np.random.default_rng(seed)`, cut into batches, the last one wrapped
    round to the epoch's first seeds;
  * a batch, hop by hop: the frontier's unique nodes (the seeds first),
    one integer from a second `np.random.default_rng(seed)` a hop, which
    seeds SplitMix64; each node with more in-edges than the fanout takes
    `fanout` distinct offsets into its in-edges by Floyd's algorithm on
    rejection-bounded draws, the others all of them (the in-edges in the
    order of a stable sort by recipient, duplicates kept);
  * the local ids: the seeds first, then the other nodes in id order.
The program's numpy fallback (`rng.choice`) draws other batches; a cell
that uses this copy runs only where the native library loads.
"""
from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


class SplitMix64:
    """csrc/fswgraph.cpp's generator, on Python integers."""

    def __init__(self, seed: int):
        self.state = seed & MASK64

    def next(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & MASK64
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        return z ^ (z >> 31)

    def bounded(self, n: int) -> int:
        """Uniform in [0, n) by rejection of the draws below 2^64 mod n."""
        threshold = ((1 << 64) - n) % n
        while True:
            r = self.next()
            if r >= threshold:
                return r % n


class Sampler:
    """Uniform in-neighbour sampling of `fanouts` a hop over a (2, E) edge
    list, from `seed`."""

    def __init__(self, edge_index, num_nodes: int, fanouts, seed: int):
        src = np.asarray(edge_index[0], np.int64)
        dst = np.asarray(edge_index[1], np.int64)
        order = np.argsort(dst, kind='stable')
        self.col_idx = src[order]
        self.row_ptr = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=num_nodes),
                  out=self.row_ptr[1:])
        self.fanouts = tuple(int(f) for f in fanouts)
        self.rng = np.random.default_rng(seed)

    def one_hop(self, seeds: np.ndarray, fanout: int, rng_seed: int):
        """(src, dst) of up to `fanout` in-neighbours of each seed, in
        global ids."""
        rng = SplitMix64(rng_seed)
        ptr = self.row_ptr
        pos, dst = [], []
        for s in seeds.tolist():
            lo, hi = int(ptr[s]), int(ptr[s + 1])
            deg = hi - lo
            if deg <= fanout:
                pos.extend(range(lo, hi))
                dst.extend([s] * deg)
                continue
            chosen = []
            for j in range(deg - fanout, deg):
                t = rng.bounded(j + 1)
                chosen.append(j if t in chosen else t)
            pos.extend(lo + c for c in chosen)
            dst.extend([s] * fanout)
        return (self.col_idx[np.asarray(pos, np.int64)],
                np.asarray(dst, np.int64))

    def sample(self, seeds) -> dict:
        """One batch around `seeds`: `node_ids` (seeds first, unpadded),
        `num_seeds`, `edge_index` in local ids."""
        seeds = np.asarray(seeds, np.int64)
        frontier = seeds
        all_src, all_dst = [], []
        for fanout in self.fanouts:
            s, d = self.one_hop(np.unique(frontier), fanout,
                                int(self.rng.integers(0, 2**63 - 1)))
            all_src.append(s)
            all_dst.append(d)
            frontier = s
        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)
        uniq = np.concatenate([seeds, src, dst])
        node_ids, inv = np.unique(uniq, return_inverse=True)
        seed_pos = inv[:len(seeds)]
        rest = np.setdiff1d(np.arange(len(node_ids)), seed_pos)
        order = np.concatenate([seed_pos, rest])
        remap = np.empty(len(node_ids), np.int64)
        remap[order] = np.arange(len(node_ids))
        return {'node_ids': node_ids[order], 'num_seeds': len(seeds),
                'edge_index': np.stack([
                    remap[inv[len(seeds):len(seeds) + len(src)]],
                    remap[inv[len(seeds) + len(src):]]])}


def epoch_batches(sampler: Sampler, train_nodes, batch_size: int, seed: int):
    """The batches of the epochs from `seed` in the program's order, one
    a step, without end (a train set smaller than one batch gives none)."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(train_nodes)
        if len(order) < batch_size:
            return
        for i in range(0, len(order), batch_size):
            seeds = order[i:i + batch_size]
            if len(seeds) < batch_size:
                seeds = np.concatenate(
                    [seeds, order[:batch_size - len(seeds)]])
            yield sampler.sample(seeds)
