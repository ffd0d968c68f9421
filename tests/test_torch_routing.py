"""The rank route's shared-memory rule: `_resolve_aggregate` sends a width
only to rank kernels whose blocks hold it, by `ops.fsw_rank.smem_bytes`
(the kernels' own needs, which tests/test_torch_cuda.py holds equal to
every library's export on the card), the same on the CPU as on the card.

Before this rule the table path sent every layer with d_in + d_edge below
the slice width to the fused kernel K1f, whose shared memory grew with the
feature width D: a layer of Citeseer's 3703 features needed 239072 bytes
at bucket width 8, above the 232448 a block has, and crashed on the card.

Tolerance of the parity test: test_torch_conv.py's float32 one,
|port - jax| <= 2e-5 * max|jax| + 1e-4 * |jax|, against JAX in float64
(see the test).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch import embedding as TE
from fsw_gnn_tpu_torch.ops.fsw_rank import smem_bytes

LIMIT = 232448
KERNELS = {'rank_proj': ('fsw_rank_fwdp', 'fsw_rank_bwdp'),
           'rank': ('fsw_rank_fwd', 'fsw_rank_bwd')}
CART_KERNELS = ('fsw_rank_cart_fwd', 'fsw_rank_cart_bwd')


def _fits(route, cfg, B, weights_grad):
    """Whether every kernel of `route` holds width B (K4b with its larger
    uniform-weight need)."""
    if route == 'sort':
        return True
    names = CART_KERNELS if cfg.cartesian_mode else KERNELS[route]
    return all(smem_bytes(n, B, cfg.nFreqs if cfg.cartesian_mode else 1,
                          weights_grad, uniform_w=True) <= LIMIT
               for n in names)


def test_citeseer_routes_fit(monkeypatch):
    """FSWConv(3703, 64), the Trainer's first layer on the Citeseer
    stand-in: at each class width of its MultiTable (8 and 16) and at 128,
    with and without weight gradients and at the classes' own entries per
    node, every route 'auto' and 'rank' pick fits by the need function,
    and the routes the table path really takes are those."""
    from fsw_gnn_tpu_torch.data import load
    data = load('citeseer')
    assert data.features.shape[1] == 3703
    mt = T.auto_layout(T.from_edge_index(data.edge_index,
                                         data.num_nodes)).to('cpu')
    assert sorted(t.bucket_size for t in mt.tables) == [8, 16]
    cfg = T.FSWConv(3703, 64, minimize_slice_coherence=False,
                    device='cpu').embed_cfg
    assert cfg.proj_dim < cfg.nSlices
    # K1f's need is its 36864-byte staging ring up to 64 entries a block,
    # whatever the feature width (the old design's 4 (64 B + 16 D + B)
    # bytes reached 239072 here at B = 8)
    for B in (8, 16, 24, 32, 64):
        assert smem_bytes('fsw_rank_fwdp', B) == 36864
    rhos = [t.idx.numel() / data.num_nodes for t in mt.tables]
    for B in (8, 16, 128):
        for wg in (False, True):
            for rho in rhos + [None, 0.01, 100.0]:
                for agg in ('auto', 'rank'):
                    route = TE._resolve_aggregate(agg, cfg, B, cfg.nSlices,
                                                  wg, rho)
                    assert route in ('rank', 'rank_proj')
                    assert _fits(route, cfg, B, wg), (agg, B, wg, rho)
    # the table path asks the rule with its own entries per node
    seen = []
    real = TE._resolve_aggregate

    def spy(*args, **kwargs):
        seen.append((args[2], real(*args, **kwargs)))
        return seen[-1][1]
    monkeypatch.setattr(TE, '_resolve_aggregate', spy)
    for tbl in mt.tables:
        with pytest.raises(_Stop):
            TE.fsw_embed_table(_StopX(data.num_nodes, 3703), tbl,
                               torch.zeros(cfg.nSlices, 3703),
                               torch.zeros(cfg.nSlices), cfg,
                               weights_grad=False)
    assert [b for b, _ in seen] == [t.bucket_size for t in mt.tables]
    for (B, route), rho in zip(seen, rhos):
        assert route == real('auto', cfg, B, cfg.nSlices, False, rho)
        assert _fits(route, cfg, B, False)


class _Stop(Exception):
    pass


class _StopX:
    """Stands in for X: its shape is read for the entries per node, and
    the first use past the routing stops the call."""

    def __init__(self, n, d):
        self.shape = (n, d)
        self.dtype = torch.float32

    def __getitem__(self, idx):
        raise _Stop

    def __matmul__(self, other):
        raise _Stop


def test_wide_cartesian_routes_by_need():
    """Cartesian mode at F = 300 frequencies and width 128 with weight
    gradients: K4b would need more than a block has, so 'auto' sorts and
    an explicit 'rank' raises naming the width, F and the need; without
    weight gradients K4 holds it.  (Up to the entry kernel's redesign F =
    130 was enough; its block now holds 128 entries at 130 frequencies.)"""
    cart = TE.FSWConfig(d_in=3, n_slices=8, n_freqs=300)
    assert smem_bytes('fsw_rank_cart_bwd', 128, 130, True) <= LIMIT
    assert smem_bytes('fsw_rank_cart_bwd', 128, 300, True) > LIMIT
    assert TE._resolve_aggregate('auto', cart, 128, weights_grad=True) == \
        'sort'
    with pytest.raises(ValueError, match=r'bucket width 128 at 300 '
                                         r'frequencies.* \d+ bytes'):
        TE._resolve_aggregate('rank', cart, 128, weights_grad=True)
    assert TE._resolve_aggregate('rank', cart, 64, weights_grad=True) == \
        'rank'
    no_dw = TE._resolve_aggregate('auto', cart, 128, weights_grad=False)
    assert no_dw == ('rank' if _fits('rank', cart, 128, False) else 'sort')


# The backward entry kernel's need (K1b, K2b; K4b at eight frequencies) at
# B = 8, 100 and 128, with and without weight gradients: 4 threads a slice
# and 32 slices a block from B = 25 on (10 bytes an entry-slice with weight
# gradients, 4 without), one thread a slice and 64 slices at B = 8.  The
# previous design needed 4 (128 B + 3 B + 64) bytes with weight gradients
# (52656 at B = 100, 67328 at 128).
ENTRY_NEED = {('fsw_rank_bwd', 1): {8: (6752, 3872), 100: (33952, 14096),
                                    128: (43136, 17792)},
              ('fsw_rank_cart_bwd', 8): {8: (15712, 16416),
                                         100: (38432, 20368),
                                         128: (47616, 24064)}}


@pytest.mark.parametrize('B', [8, 100, 128])
def test_backward_entry_smem_pinned(B):
    """The entry kernel's shared memory a block at the widths the paths
    use, pinned so that a layout whose need grows shows on the CPU; K1b
    runs K2b's entry kernel.  The shape behind it: K threads a slice (one
    for each group of 8 entries, at most 4) and 32 or 64 slices a block."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import entry_shape
    for (name, F), need in ENTRY_NEED.items():
        for dw, want in zip((True, False), need[B]):
            assert smem_bytes(name, B, F, dw) == want, (name, B, dw)
            assert smem_bytes(name, B, F, dw, uniform_w=True) == want
            if name == 'fsw_rank_bwd':
                assert smem_bytes('fsw_rank_bwdp', B, 1, dw) == want
            assert entry_shape(B, F, dw) == ((1, 64) if B == 8 else (4, 32))


@pytest.mark.parametrize('B,weights_grad', [(443, True), (444, True),
                                            (705, True), (706, True),
                                            (752, False), (753, False),
                                            (893, False), (894, False)])
def test_explicit_rank_routes_by_need(B, weights_grad):
    """An explicit 'rank' at widths around each kernel's limit: K1 while
    K1f (shared memory independent of D) and K1b hold the width, then K2
    while K2f and K2b do, then a ValueError naming the width; 'auto' never
    takes a rank kernel above 128."""
    cfg = TE.FSWConfig(d_in=16, d_out=64)
    got = [TE._resolve_aggregate(a, cfg, B, cfg.nSlices, weights_grad, 0.5)
           if _fits('rank', cfg, B, weights_grad) or a == 'auto' else None
           for a in ('rank', 'auto')]
    assert got[1] == 'sort'
    if _fits('rank_proj', cfg, B, weights_grad):
        assert got[0] == 'rank_proj'
    elif _fits('rank', cfg, B, weights_grad):
        assert got[0] == 'rank'
    else:
        with pytest.raises(ValueError, match=f'bucket width {B}'):
            TE._resolve_aggregate('rank', cfg, B, cfg.nSlices,
                                  weights_grad, 0.5)


def test_k1_crossover_rule():
    """`_k1_faster`: K1 at the bench width (D = 64) for any entries per
    node, never above the rule's D0 at many entries a node, always where a
    class has fewer entries than K1_RHO0 a node; one inequality."""
    for rho in (0.1, 1.0, 8.0, 20.0, 1e6):
        assert TE._k1_faster(64, rho)
    assert not TE._k1_faster(int(TE.K1_D0) + 1, 1e9)
    assert TE._k1_faster(10 ** 6, TE.K1_RHO0)
    for D in (100, 300, 1000, 3000):
        for rho in (2.0, 8.0, 20.0):
            want = (rho <= TE.K1_RHO0
                    or D * (rho - TE.K1_RHO0) < rho * TE.K1_D0)
            assert TE._k1_faster(D, rho) == want


def test_wide_fswconv_auto_matches_jax():
    """FSWConv(3600, 8) on a 64-node graph whose in-degrees are all 8 (the
    smallest input that crashed K1f on the card): the port's float32 'auto'
    (on the CPU the rank route's plain versions) against JAX's 'auto' on
    the same float32 inputs and parameters, computed in float64.  JAX's
    float32 'auto' (its sort route) is itself off by 3.3e-5 of the output
    scale here: its cos of phases up to pi * 14397 rad keeps about four
    digits, where the rank route reduces the phase exactly (the port is
    4.7e-6 from float64).  Every normalized weight is 1/8, so every
    cumulative weight is exact in either summation order."""
    from chip_smoke import regular_graph
    n, d = 64, 3600
    ei = regular_graph(0, n, 8)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    jl = J.to_multi_table(J.from_edge_index(ei, n, dtype=jnp.float32))
    tl = T.to_multi_table(T.from_edge_index(ei, n, dtype=np.float32))
    assert [t.bucket_size for t in tl.tables] == [8]
    kw = dict(in_channels=d, out_channels=8)
    jm = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float32, **kw)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(X), jl))
    tm = T.fswconv_from_jax(variables, device='cpu', **kw).eval()
    cfg = tm.embed_cfg
    route = TE._resolve_aggregate('auto', cfg, 8, cfg.nSlices, False,
                                  tl.tables[0].idx.size / n)
    assert route in ('rank', 'rank_proj') and _fits(route, cfg, 8, False)
    v64 = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a,
        variables)
    jm64 = J.FSWConv(minimize_slice_coherence=False, dtype=jnp.float64,
                     **kw)
    jl64 = J.to_multi_table(J.from_edge_index(ei, n, dtype=jnp.float64))
    want = np.asarray(jm64.apply(v64, jnp.asarray(X, jnp.float64), jl64))
    with torch.no_grad():
        got = tm(torch.from_numpy(X), tl).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=2e-5 * np.abs(want).max())
