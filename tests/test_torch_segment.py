"""The port's segmented primitives (fsw_gnn_tpu_torch/ops/segment.py) and
the plain version of kernel K3 (ops/segcumsum.py) against the JAX package
on the same numpy inputs.

Tolerances:
  * the segmented cumsum against `segcumsum_pallas` (interpret mode) and
    the numpy oracle: 2e-5 (rtol and atol) in float32, as the JAX
    package's own kernel tests; 1e-12 in float64.  Both restart at every
    segment and differ only in summation order.
  * `segment_cumsum` against JAX's, float64: 1e-12.
  * sorts, permutations and integer helpers: exact.
  * gradients through the gathers, float64: 1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fsw_gnn_tpu.ops import segment as JS
from fsw_gnn_tpu.ops.segcumsum_pallas import (segcumsum_pallas,
                                              segment_boundaries as jsb)
from fsw_gnn_tpu_torch.ops import segment as TS
from fsw_gnn_tpu_torch.ops.segcumsum import (segcumsum, segcumsum_plain,
                                             segment_boundaries)


# jitted: the restart scan runs op by op for many seconds otherwise
_jcs = jax.jit(JS.segment_cumsum, static_argnames=('num_segments', 'method'))


def _oracle(values, ids):
    out = np.zeros_like(values)
    acc = {}
    for i, (v, s) in enumerate(zip(values, ids)):
        acc[s] = acc.get(s, 0.0) + v
        out[i] = acc[s]
    return out


def _ids(rng, n, nseg):
    return np.sort(rng.integers(0, nseg, n)).astype(np.int32)


SHAPES = [(128, 1), (1000, 37), (8192, 100), (4096, 4096), (3000, 2)]


@pytest.mark.parametrize('n,nseg', SHAPES)
@pytest.mark.parametrize('by', ['ids', 'mask'])
def test_segcumsum_plain_matches_pallas_f32(n, nseg, by):
    """ids: any sign; mask: nonnegative values (the JAX mask kernel's
    contract), the mask built by each package's segment_boundaries."""
    rng = np.random.default_rng(n + nseg)
    ids = _ids(rng, n, nseg)
    v = rng.standard_normal(n).astype(np.float32)
    if by == 'ids':
        want = segcumsum_pallas(jnp.asarray(v), jnp.asarray(ids),
                                interpret=True)
        got = segcumsum_plain(torch.from_numpy(v), torch.from_numpy(ids))
    else:
        v = np.abs(v)
        mask = np.asarray(jsb(jnp.asarray(ids)))
        tmask = segment_boundaries(torch.from_numpy(ids))
        np.testing.assert_array_equal(tmask.numpy(), mask)
        want = segcumsum_pallas(jnp.asarray(v), None, interpret=True,
                                nonnegative=True,
                                boundaries=jnp.asarray(mask))
        got = segcumsum(torch.from_numpy(v), boundaries=tmask)
    oracle = _oracle(v.astype(np.float64), ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('n,nseg', [(1000, 37), (4096, 4096), (2500, 1)])
def test_segcumsum_plain_f64_and_honest_bound(n, nseg):
    """float64 against the oracle and JAX's restart scan at 1e-12, with
    and without an honest max_seg_size."""
    rng = np.random.default_rng(n)
    ids = _ids(rng, n, nseg)
    v = rng.standard_normal(n)
    oracle = _oracle(v, ids)
    want = np.asarray(_jcs(jnp.asarray(v), jnp.asarray(ids)))
    bound = int(np.bincount(ids).max())
    for kw in ({}, dict(max_seg_size=bound)):
        got = segcumsum(torch.from_numpy(v), torch.from_numpy(ids),
                        **kw).numpy()
        np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_restart_precision():
    """A segment of 1e6 values before one of 1e-3 values: the restart scan
    keeps the small segment exact to its own scale, the global method
    shows the big prefix's rounding (float32)."""
    n = 2048
    ids = np.repeat(np.arange(2, dtype=np.int32), n // 2)
    v = np.concatenate([np.full(n // 2, 1e6, np.float32),
                        np.full(n // 2, 1e-3, np.float32)])
    want = _oracle(v.astype(np.float64), ids)
    tv, tid = torch.from_numpy(v), torch.from_numpy(ids)
    small = slice(n // 2, None)
    restart = TS.segment_cumsum(tv, tid).numpy()
    glob = TS.segment_cumsum(tv, tid, method='global').numpy()
    jglob = np.asarray(_jcs(jnp.asarray(v), jnp.asarray(ids),
                            method='global'))
    np.testing.assert_allclose(restart[small], want[small], rtol=1e-5)
    assert np.abs(glob[small] - want[small]).max() > 1e-2
    np.testing.assert_array_equal(glob, jglob)
    pallas = np.asarray(segcumsum_pallas(jnp.asarray(v), jnp.asarray(ids),
                                         interpret=True))
    np.testing.assert_allclose(restart, pallas, rtol=1e-6)


@pytest.mark.parametrize('method', ['restart', 'global'])
@pytest.mark.parametrize('shape', [(500,), (300, 7), (200, 2, 3)])
@pytest.mark.parametrize('with_row_ptr', [False, True])
def test_segment_cumsum_matches_jax(method, shape, with_row_ptr):
    rng = np.random.default_rng(len(shape))
    n = shape[0]
    ids = _ids(rng, n, 20)
    v = rng.standard_normal(shape)
    rp = np.asarray(JS.segment_ids_to_row_ptr(jnp.asarray(ids), 20))
    np.testing.assert_array_equal(
        TS.segment_ids_to_row_ptr(torch.from_numpy(ids), 20).numpy(), rp)
    kw_j = dict(row_ptr=jnp.asarray(rp)) if with_row_ptr else {}
    kw_t = dict(row_ptr=torch.from_numpy(rp.copy())) if with_row_ptr else {}
    want = np.asarray(_jcs(jnp.asarray(v), jnp.asarray(ids),
                           method=method, **kw_j))
    got = TS.segment_cumsum(torch.from_numpy(v), torch.from_numpy(ids),
                            method=method, **kw_t).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_segment_sorts_and_permutations_match_jax():
    """Ties (keys on a coarse grid, -0.0 beside 0.0) keep their index
    order within a segment, as JAX's stable lexicographic sort; the
    float32 single-key sort and the two-sort route agree."""
    rng = np.random.default_rng(3)
    n, nseg = 777, 13
    ids = _ids(rng, n, nseg)
    keys = np.round(rng.standard_normal(n) * 2) / 2
    keys[::7] = -0.0
    keys[3::7] = 0.0
    carry = rng.standard_normal(n)
    jk, jc = JS.segment_sort(jnp.asarray(keys), jnp.asarray(carry),
                             segment_ids=jnp.asarray(ids))
    tk, tc = TS.segment_sort(torch.from_numpy(keys), torch.from_numpy(carry),
                             segment_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jperm = np.asarray(JS.segment_argsort(jnp.asarray(keys),
                                          jnp.asarray(ids)))
    for k in (keys, keys.astype(np.float32)):
        tperm = TS.segment_argsort(torch.from_numpy(k), torch.from_numpy(ids))
        np.testing.assert_array_equal(tperm.numpy(), jperm)
    # rows of a 2-D key array are sorted on their own, as in the embedding
    rows = np.stack([keys, -keys]).astype(np.float32)
    trows = TS.segment_argsort(torch.from_numpy(rows), torch.from_numpy(ids))
    for r in range(2):
        np.testing.assert_array_equal(
            trows[r].numpy(), np.asarray(JS.segment_argsort(
                jnp.asarray(rows[r]), jnp.asarray(ids))))
    perm, inv = TS.sort_perm_by_segmented_keys(torch.from_numpy(keys),
                                               torch.from_numpy(ids))
    jp, ji = JS.sort_perm_by_segmented_keys(jnp.asarray(keys),
                                            jnp.asarray(ids))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        TS.invert_permutation(perm).numpy(),
        np.asarray(JS.invert_permutation(jnp.asarray(np.asarray(jp)))))
    x = rng.standard_normal((n, 3))
    np.testing.assert_array_equal(
        TS.permutation_gather(torch.from_numpy(x), perm, inv).numpy(),
        np.asarray(JS.permutation_gather(jnp.asarray(x), jp, ji)))
    rp = np.asarray(JS.segment_ids_to_row_ptr(jnp.asarray(ids), nseg))
    np.testing.assert_array_equal(
        TS.row_ptr_to_segment_ids(torch.from_numpy(rp), n).numpy(),
        np.asarray(JS.row_ptr_to_segment_ids(jnp.asarray(rp), n)))
    np.testing.assert_allclose(
        TS.segment_sum(torch.from_numpy(x), torch.from_numpy(ids),
                       nseg).numpy(),
        np.asarray(JS.segment_sum(jnp.asarray(x), jnp.asarray(ids), nseg)),
        rtol=1e-12, atol=1e-12)


# F2: ids below 0 (and at or above num_segments) fall in no segment
OUT_OF_RANGE_IDS = {
    'leading': [-1, 0, 0, 1, 1, 2],
    'trailing': [0, 0, 1, 2, 3, 3],
    'both': [-5, -1, -1, 0, 2, 2, 3, 7],
    'none': [0, 1, 1, 2],
    'all out': [-2, -1, 3, 4],
}


@pytest.mark.parametrize('case', sorted(OUT_OF_RANGE_IDS))
def test_segment_sum_drops_out_of_range_ids_as_jax(case):
    """segment_sum, its backward and segment_expand's forward and backward
    against JAX's segment_sum and its transpose (a gather that gives 0
    where an id falls in no segment), float64, along axis 0 and 1."""
    ids = np.asarray(OUT_OF_RANGE_IDS[case], np.int32)
    nseg = 3
    rng = np.random.default_rng(len(ids))
    x = rng.standard_normal((len(ids), 2))
    g = rng.standard_normal((nseg, 2))
    if case == 'leading':
        got = TS.segment_sum(torch.arange(1.0, 7.0), torch.from_numpy(ids),
                             nseg)
        np.testing.assert_array_equal(got.numpy(), [5.0, 9.0, 6.0])

    def jsum(v):
        return JS.segment_sum(v, jnp.asarray(ids), nseg)

    want, vjp = jax.vjp(jsum, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TS.segment_sum(xt, torch.from_numpy(ids), nseg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=1e-12, atol=1e-12)
    # along axis 1 of a (2, n) array
    got1 = TS.segment_sum(torch.from_numpy(x.T.copy()), torch.from_numpy(ids),
                          nseg, dim=1)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want).T,
                               rtol=1e-12, atol=1e-12)
    # segment_expand is segment_sum's transpose: JAX's vjp of segment_sum
    # is the gather with fill, and its own transpose the sum again
    gt = torch.from_numpy(g).requires_grad_(True)
    ex = TS.segment_expand(gt, torch.from_numpy(ids))
    np.testing.assert_allclose(ex.detach().numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=1e-12, atol=1e-12)
    ex.backward(torch.from_numpy(x))
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_segment_argsort_puts_every_nan_last_as_jax(dtype):
    """F3: keys with NaNs of either sign, infinities and signed zeros in
    sorted segments (a leading negative id too): the permutation and the
    carried arrays of segment_sort are JAX's, with stable=True and False
    (the stable order is an allowed unstable one)."""
    nan = np.float32(np.nan)
    neg_nan = -nan
    assert np.signbit(neg_nan)
    keys = np.asarray([neg_nan, 1.0, nan, -np.inf, 0.0, -0.0, neg_nan, 2.0,
                       np.inf, -1.0, nan, 0.5], dtype)
    ids = np.asarray([-1, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2], np.int32)
    jperm = np.asarray(JS.segment_argsort(jnp.asarray(keys),
                                          jnp.asarray(ids)))
    for stable in (True, False):
        tperm = TS.segment_argsort(torch.from_numpy(keys),
                                   torch.from_numpy(ids), stable=stable)
        np.testing.assert_array_equal(tperm.numpy(), jperm)
    np.testing.assert_array_equal(
        TS.segment_argsort(torch.tensor([neg_nan, 1.0]),
                           torch.zeros(2, dtype=torch.int32)).numpy(),
        [1, 0])
    carry = np.arange(len(keys), dtype=np.float64)
    jk, jc = JS.segment_sort(jnp.asarray(keys), jnp.asarray(carry),
                             segment_ids=jnp.asarray(ids))
    tk, tc = TS.segment_sort(torch.from_numpy(keys), torch.from_numpy(carry),
                             segment_ids=torch.from_numpy(ids), stable=False)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_segment_primitives_are_exported_at_the_top():
    """The four primitives the JAX package exports at its top are the
    port's too, with JAX's keywords."""
    import fsw_gnn_tpu as J
    import fsw_gnn_tpu_torch as T
    rng = np.random.default_rng(5)
    ids = _ids(rng, 40, 6)
    v = rng.standard_normal(40)
    ti, tv = torch.from_numpy(ids), torch.from_numpy(v)
    np.testing.assert_allclose(
        T.segment_cumsum(tv, ti).numpy(),
        np.asarray(_jcs(jnp.asarray(v), jnp.asarray(ids))), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        T.segment_sum(tv, ti, 6).numpy(),
        np.asarray(J.segment_sum(jnp.asarray(v), jnp.asarray(ids), 6)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        T.segment_argsort(tv, ti, stable=True).numpy(),
        np.asarray(J.segment_argsort(jnp.asarray(v), jnp.asarray(ids),
                                     stable=True)))
    np.testing.assert_array_equal(
        T.segment_sort(tv, segment_ids=ti, stable=True)[0].numpy(),
        np.asarray(J.segment_sort(jnp.asarray(v), segment_ids=jnp.asarray(
            ids), stable=True)[0]))


def test_gather_and_sort_gradients_match_jax():
    """rows_gather (JAX: a sorted segment-sum backward) and
    segment_sort_fused (JAX: unsort by sorting) against autograd."""
    rng = np.random.default_rng(4)
    N, E, nseg = 30, 200, 17
    x = rng.standard_normal((N, 4))
    idx = rng.integers(0, N, E)
    order = np.argsort(idx, kind='stable')
    ct = rng.standard_normal((E, 4))

    def jloss(x_):
        y = JS.rows_gather(N, x_, jnp.asarray(idx, jnp.int32),
                           jnp.asarray(order, jnp.int32),
                           jnp.asarray(idx[order], jnp.int32))
        return jnp.sum(y * ct)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (TS.rows_gather(N, xt, torch.from_numpy(idx)) * torch.from_numpy(ct)
     ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-12,
                               atol=1e-12)

    ids = _ids(rng, E, nseg)
    keys, carried = rng.standard_normal(E), rng.standard_normal(E)
    gk, gc = rng.standard_normal(E), rng.standard_normal(E)

    def jl(k, c):
        a, b = JS.segment_sort_fused(k, c, jnp.asarray(ids))
        return jnp.sum(a * gk) + jnp.sum(b * b * gc)
    wk, wc = jax.grad(jl, argnums=(0, 1))(jnp.asarray(keys),
                                          jnp.asarray(carried))
    kt = torch.from_numpy(keys).requires_grad_(True)
    ctt = torch.from_numpy(carried).requires_grad_(True)
    a, b = TS.segment_sort_fused(kt, ctt, torch.from_numpy(ids))
    ((a * torch.from_numpy(gk)).sum()
     + (b * b * torch.from_numpy(gc)).sum()).backward()
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(wk), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ctt.grad.numpy(), np.asarray(wc), rtol=1e-12,
                               atol=1e-12)


def test_segcumsum_gradient_matches_jax():
    """The custom op's backward (the reversed segmented cumsum,
    ids and mask) against jax.grad of the restart scan."""
    rng = np.random.default_rng(5)
    n = 600
    ids = _ids(rng, n, 40)
    v, g = rng.standard_normal(n), rng.standard_normal(n)
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(
        JS.segment_cumsum(x, jnp.asarray(ids)) * g)))(jnp.asarray(v)))
    tid = torch.from_numpy(ids)
    for kw in (dict(segment_ids=tid),
               dict(boundaries=segment_boundaries(tid))):
        vt = torch.from_numpy(v).requires_grad_(True)
        (segcumsum(vt, **kw) * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(vt.grad.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


def test_segcumsum_refuses_bad_arguments():
    v = torch.zeros(5)
    with pytest.raises(ValueError, match='exactly one'):
        segcumsum_plain(v)
    with pytest.raises(ValueError, match='flat'):
        segcumsum_plain(torch.zeros(2, 2), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match='segment entries'):
        segcumsum_plain(v, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="'restart' or 'global'"):
        TS.segment_cumsum(v, torch.zeros(5, dtype=torch.int32),
                          method='scan')
