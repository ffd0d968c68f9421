"""Kernel A1's register network (csrc/fsw_table_sort.cu) modelled lane by
lane in numpy, against the plain version's network `sort_pairs_plain`.

A column of width B belongs to G = B / E lanes, lane q holding entries
q E .. q E + E - 1, E = min(B, 32).  A stage of distance j < E compares
the lane's own entries e and e + j; a stage of distance j >= E gives every
lane its partner's entry e (lane q ^ (j / E), as `__shfl_xor_sync` does,
all lanes at once), and each lane keeps its own value or takes the
partner's by the predicate both evaluate on the same pair, (lo > hi) ==
asc.  The model must give the plain network's (p, w) pairs bit for bit,
ties included, at every width the kernel takes; `table_sort_lanes` is the
lane count the kernel's `fsw_table_sort_lanes` reports.
"""
import numpy as np
import pytest
import torch

from fsw_gnn_tpu_torch.benchmarks.attic.fsw_table import sort_pairs_plain
from fsw_gnn_tpu_torch.ops.fsw_rank import table_sort_lanes

WIDTHS = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]


def lane_network(p, w):
    """The kernel's network on p, w (cols, B) float32, lane by lane."""
    cols, B = p.shape
    E = min(B, 32)
    G = B // E
    p = p.reshape(cols, G, E).copy()
    w = w.reshape(cols, G, E).copy()
    q = np.arange(G)
    k = 2
    while k <= B:
        j = k // 2
        while j >= 1:
            if j >= E:
                m = j // E
                po, wo = p[:, q ^ m, :], w[:, q ^ m, :]
                lower = ((q & m) == 0)[None, :, None]
                asc = (((q * E) & k) == 0)[None, :, None]
                lo = np.where(lower, p, po)
                hi = np.where(lower, po, p)
                sw = (lo > hi) == asc
                p, w = np.where(sw, po, p), np.where(sw, wo, w)
            else:
                for e in range(E):
                    if e & j:
                        continue
                    asc = ((((q * E) | e) & k) == 0)[None, :]
                    lo, hi = p[:, :, e].copy(), p[:, :, e + j].copy()
                    wl, wh = w[:, :, e].copy(), w[:, :, e + j].copy()
                    sw = (lo > hi) == asc
                    p[:, :, e], p[:, :, e + j] = (np.where(sw, hi, lo),
                                                  np.where(sw, lo, hi))
                    w[:, :, e], w[:, :, e + j] = (np.where(sw, wh, wl),
                                                  np.where(sw, wl, wh))
            j //= 2
        k *= 2
    return p.reshape(cols, B), w.reshape(cols, B)


@pytest.mark.parametrize('B', WIDTHS)
def test_lane_network_is_the_plain_network_bit_for_bit(B):
    """24 columns with ties (every fourth value repeats the one before, a
    few values repeat across the column) and distinct weights."""
    rng = np.random.default_rng(B)
    p = rng.standard_normal((24, B)).astype(np.float32)
    p[:, 1::4] = p[:, 0:B - 1:4]
    p[:, -1] = p[:, 0]
    w = rng.random((24, B)).astype(np.float32)
    mp, mw = lane_network(p, w)
    # sort_pairs_plain sorts along axis 1 of (R, B, S): one column a slice
    tp, tw = sort_pairs_plain(torch.from_numpy(p.T.copy())[None],
                              torch.from_numpy(w.T.copy())[None])
    assert np.array_equal(mp, tp[0].numpy().T)
    assert np.array_equal(mw, tw[0].numpy().T)
    assert np.all(np.diff(mp, axis=1) >= 0)
    assert table_sort_lanes(B) == B // min(B, 32)


def test_lane_counts_refuse_the_widths_the_kernel_refuses():
    for B in (0, 1, 3, 12, 48, 2048, 4096):
        assert table_sort_lanes(B) == 0
