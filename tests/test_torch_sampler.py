"""The port's neighbor sampler and its native library against the JAX
package's: the CSC build, one-hop sampling on the numpy path and the native
path, whole batches from one seed, and the native CSR builder.  Every
comparison is exact: the same seed draws the same values in the same
order on both sides."""
import ctypes

import numpy as np
import pytest

import jax.numpy as jnp

from fsw_gnn_tpu import from_edge_index as jax_from_edge_index
from fsw_gnn_tpu.data import sampler as jsampler
from fsw_gnn_tpu_torch import kernels
from fsw_gnn_tpu_torch.data import CSCGraph, NeighborSampler, SampledBatch
from fsw_gnn_tpu_torch.data import sampler as tsampler

LL = ctypes.POINTER(ctypes.c_longlong)
DD = ctypes.POINTER(ctypes.c_double)


def _graph(seed, n, p, dup=0):
    """A random directed graph with `dup` duplicated edges and some nodes
    of no in-edge."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < p
    np.fill_diagonal(A, False)
    A[:, :3] = False
    src, dst = np.nonzero(A)
    ei = np.stack([src, dst]).astype(np.int64)
    if dup:
        ei = np.concatenate([ei, ei[:, rng.integers(0, ei.shape[1], dup)]],
                            axis=1)
        ei = ei[:, rng.permutation(ei.shape[1])]
    return ei


@pytest.fixture(params=['numpy', 'native'])
def path(request, monkeypatch):
    """Both packages on the numpy path, or both on their native library
    (the port's build and the JAX package's committed one; skips where
    the latter does not load)."""
    if request.param == 'numpy':
        for mod in (jsampler, tsampler):
            monkeypatch.setattr(mod, '_LIB', None)
            monkeypatch.setattr(mod, '_LIB_TRIED', True)
    else:
        if jsampler._load_native() is None:
            pytest.skip("the JAX package's native library does not load")
        assert tsampler._load_native() is not None
    return request.param


@pytest.mark.parametrize('seed,n,p,dup', [(0, 50, 0.1, 0), (1, 80, 0.3, 40)])
def test_csc_matches_jax(seed, n, p, dup):
    ei = _graph(seed, n, p, dup)
    want = jsampler.CSCGraph.from_edge_index(ei, n)
    got = CSCGraph.from_edge_index(ei, n)
    assert got.num_nodes == want.num_nodes == n
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert got.row_ptr.dtype == got.col_idx.dtype == np.int64


def test_one_hop_matches_jax(path):
    ei = _graph(1, 40, 0.3, dup=30)
    csc_j = jsampler.CSCGraph.from_edge_index(ei, 40)
    csc_t = CSCGraph.from_edge_index(ei, 40)
    seeds = np.array([0, 5, 10, 17, 33], np.int64)
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    for fanout in (4, 2, 50):
        want = jsampler._sample_one_hop(csc_j, seeds, fanout, rng_j)
        got = tsampler._sample_one_hop(csc_t, seeds, fanout, rng_t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # every seed of in-degree above the fanout was sampled
        deg = np.diff(csc_t.row_ptr)[seeds]
        assert (deg > 2).any()
    # both drew the same count of values from their generators
    assert rng_t.integers(0, 2**62) == rng_j.integers(0, 2**62)


def test_sampler_batches_match_jax(path):
    n = 120
    ei = _graph(2, n, 0.12, dup=20)
    labels = np.random.default_rng(3).integers(0, 5, n)
    js = jsampler.NeighborSampler(ei, n, fanouts=(5, 3), seed=0)
    ts = NeighborSampler(ei, n, fanouts=(5, 3), seed=0)
    order = np.random.default_rng(4).permutation(n)
    for k in range(3):
        seeds = order[16 * k:16 * (k + 1)]
        want = js.sample(seeds, labels=labels, max_nodes=16 * 19)
        got = ts.sample(seeds, labels=labels, max_nodes=16 * 19)
        assert isinstance(got, SampledBatch)
        assert got.num_real_nodes == want.num_real_nodes
        assert got.num_seeds == want.num_seeds == 16
        np.testing.assert_array_equal(got.node_ids, want.node_ids)
        np.testing.assert_array_equal(got.edge_index_local,
                                      want.edge_index_local)
        np.testing.assert_array_equal(got.seed_labels, want.seed_labels)
        np.testing.assert_array_equal(got.node_ids[:16], seeds)


def test_sampler_rejects_repeated_seeds():
    ts = NeighborSampler(_graph(0, 30, 0.2), 30, fanouts=(2,), seed=0)
    with pytest.raises(ValueError, match='unique'):
        ts.sample(np.array([1, 2, 1]))
    with pytest.raises(ValueError, match='max_nodes'):
        ts.sample(np.arange(10), max_nodes=5)


def _build_csr(lib, src, dst, w, n):
    E = src.shape[0]
    out_src = np.zeros(E, np.int64)
    out_dst = np.zeros(E, np.int64)
    out_w = np.zeros(E, np.float64)
    row_ptr = np.zeros(n + 1, np.int64)
    n_uniq = lib.fsw_build_csr(
        src.ctypes.data_as(LL), dst.ctypes.data_as(LL),
        w.ctypes.data_as(DD), E, n, n, out_src.ctypes.data_as(LL),
        out_dst.ctypes.data_as(LL), out_w.ctypes.data_as(DD),
        row_ptr.ctypes.data_as(LL))
    return n_uniq, out_src, out_dst, out_w, row_ptr


def test_build_csr_matches_jax():
    """The port's `fsw_build_csr` against the JAX package's coalescing in
    `from_edge_index` (float64), and bit for bit against the JAX package's
    library where that loads."""
    rng = np.random.default_rng(7)
    n, E = 30, 200
    src = rng.integers(0, n, E).astype(np.int64)
    dst = rng.integers(0, n, E).astype(np.int64)
    w = rng.random(E)
    n_uniq, out_src, out_dst, out_w, row_ptr = _build_csr(
        tsampler._load_native(), src, dst, w, n)
    g = jax_from_edge_index(np.stack([src, dst]), n, edge_weight=w,
                            dtype=jnp.float64)
    Er = g.num_edges
    assert n_uniq == Er
    np.testing.assert_array_equal(out_src[:Er], np.asarray(g.src)[:Er])
    np.testing.assert_array_equal(out_dst[:Er], np.asarray(g.dst)[:Er])
    np.testing.assert_allclose(out_w[:Er], np.asarray(g.weight)[:Er],
                               rtol=1e-12)
    np.testing.assert_array_equal(row_ptr[:-1], np.asarray(g.row_ptr)[:-1])
    assert row_ptr[-1] == Er
    jlib = jsampler._load_native()
    if jlib is not None:
        jlib.fsw_build_csr.restype = ctypes.c_longlong
        want = _build_csr(jlib, src, dst, w, n)
        assert want[0] == n_uniq
        for a, b in zip(want[1:], (out_src, out_dst, out_w, row_ptr)):
            np.testing.assert_array_equal(b, a)


def test_host_library_is_the_ports_own_build():
    """The sampler's library is built from the port's csrc/fswgraph.cpp
    into the port's _build/, named by a hash of the source and flags; the
    CUDA build list leaves the .cpp out."""
    lib = tsampler._load_native()
    target = kernels._host_target('fswgraph')
    assert target.exists() and target.parent == kernels.BUILD_DIR
    assert lib is kernels.load_host('fswgraph')
    assert 'fswgraph' not in kernels.sources()
    assert (kernels.CSRC / 'fswgraph.cpp').exists()


def test_failed_host_build_raises_with_the_log(tmp_path, monkeypatch):
    (tmp_path / 'broken.cpp').write_text('int f( { return 0; }\n')
    monkeypatch.setattr(kernels, 'CSRC', tmp_path)
    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path / '_build')
    with pytest.raises(RuntimeError, match=r'c\+\+ failed for broken.cpp'
                                           r'(.|\n)*error'):
        kernels.load_host('broken')
    assert not list((tmp_path / '_build').glob('*.so'))
