"""The tables' gather backward (`ops.gather_bwd`): the sender order the
layouts build, the plain version against float64 sums and JAX's gradient
of the JAX package's gather, the embedding's gradient against PyTorch's
index backward, and, on the card (-m cuda), the kernel against the plain
version.  The module imports no JAX (the JAX test imports it inside), so
on the GPU machine it runs on its own:

    python -m pytest tests/test_torch_gather_bwd.py -o addopts= --noconftest -m cuda
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.embedding as TE
from fsw_gnn_tpu_torch import ops
from fsw_gnn_tpu_torch.ops.gather_bwd import (CHUNK, gather, gather_bwd,
                                              gather_bwd_plain, gather_order)
from fsw_gnn_tpu_torch.utils import profiling as P


def _graph(n=300, seed=0, wide=0):
    """Random in-degrees 0 .. 20 and recipient 0 fed by senders 0 .. wide-1:
    a table as wide as that, whose padding gathers sender 0, several
    degree classes, and no edge from the top 20 senders."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 21, n)
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n - 20, dst.size)
    src = np.concatenate([src, np.arange(wide)])
    dst = np.concatenate([dst, np.zeros(wide, np.int64)])
    return T.from_edge_index(np.stack([src, dst]), n, dtype=np.float32)


def _index_add(grad, idx, n):
    return torch.zeros(n, grad.shape[1], dtype=torch.float64).index_add_(
        0, torch.as_tensor(idx).reshape(-1).long(), grad.double())


# unit roundoff of the accumulation (float32 for float32 and bfloat16;
# float64) and of the output's one rounding
_U = {torch.float32: (2.0 ** -24, 0.0), torch.float64: (2.0 ** -53, 0.0),
      torch.bfloat16: (2.0 ** -24, 2.0 ** -8)}


def _assert_near_float64(got, grad, idx, n, levels):
    """|got - sum| within the rounding a sum tree of depth CHUNK a level
    may add, gamma = depth u times the sum of |terms| (Higham), plus the
    output's one rounding."""
    acc_u, out_u = _U[grad.dtype]
    want = _index_add(grad, idx, n)
    absum = _index_add(grad.abs(), idx, n)
    depth = CHUNK * (len(levels) - 1)
    bound = depth * acc_u * absum + out_u * want.abs() + 1e-300
    assert torch.all((got.double() - want).abs() <= bound)


def _sequential(grad, order):
    """The order's sums written out: each chunk from 0 in entry order, each
    level's partials in chunk order; one row at a time."""
    acc_dt = torch.float64 if grad.dtype == torch.float64 else torch.float32
    rows = grad.to(acc_dt)[order.perm.long()]
    part = torch.zeros(order.partials, grad.shape[1], dtype=acc_dt)
    out = torch.zeros(order.num_senders, grad.shape[1], dtype=grad.dtype)
    lv = order.levels
    for lev in range(len(lv) - 1):
        src = rows if lev == 0 else part.clone()
        for s, first, count, slot in order.chunks[lv[lev]:lv[lev + 1]].tolist():
            acc = torch.zeros(grad.shape[1], dtype=acc_dt)
            for j in range(count):
                acc = acc + src[first + j]
            if slot < 0:
                out[s] = acc.to(grad.dtype)
            else:
                part[slot] = acc
    return out


def _check_order(order, idx, n):
    flat = np.asarray(idx).reshape(-1)
    perm = order.perm.numpy()
    assert order.perm.dtype == torch.int32 and order.chunks.dtype == torch.int32
    assert np.array_equal(np.sort(perm), np.arange(flat.size))   # once each
    ptr = order.ptr.numpy()
    assert np.array_equal(np.diff(ptr), np.bincount(flat, minlength=n))
    for s in range(n):                  # each sender's entries, in order
        mine = perm[ptr[s]:ptr[s + 1]]
        assert np.all(flat[mine] == s) and np.all(np.diff(mine) > 0)
    lv, ch = order.levels, order.chunks.numpy()
    first = ch[lv[0]:lv[1]]
    assert set(first[:, 0]) == set(range(n))   # empty senders covered
    for s in range(n):
        mine = first[first[:, 0] == s]
        cnt = ptr[s + 1] - ptr[s]
        assert len(mine) == max(1, math.ceil(cnt / CHUNK))
        assert mine[:, 2].sum() == cnt and np.all(mine[:, 2] <= CHUNK)
        assert (mine[:, 3] < 0).all() == (len(mine) == 1)
    assert np.all(ch[:, 2] <= CHUNK)
    assert order.split_rows == int((np.diff(ptr) > CHUNK).sum())
    assert np.array_equal(np.sort(ch[ch[:, 3] >= 0, 3]),
                          np.arange(order.partials))


@pytest.mark.parametrize('layout', ['table', 'multi'])
def test_layouts_build_the_order(layout):
    g = _graph(wide=200)
    lay = (T.to_neighbor_table(g) if layout == 'table'
           else T.to_multi_table(g))
    tables = [lay] if layout == 'table' else list(lay.tables)
    for t in tables:
        _check_order(t.gather_order, t.idx, g.num_nodes)
        assert t.hot_row_entries == int(np.bincount(t.idx.ravel()).max())
    if layout == 'table':     # the padding: a 10 k-entry run on sender 0
        assert lay.hot_row_entries >= 10_000
    # sender 0's run is cut into ceil(n / C) chunks in every table
    for t in tables:
        o = t.gather_order
        n0 = int(np.sum(np.asarray(t.idx) == 0))
        assert int(np.sum(o.chunks.numpy()[:o.levels[1], 0] == 0)) == max(
            1, math.ceil(n0 / CHUNK))
    # .to() moves the order with the table
    moved = tables[0].to('cpu').gather_order
    assert torch.equal(moved.perm, tables[0].gather_order.perm)


def test_a_table_without_an_order_gets_the_same_order_in_the_call():
    """A bare table's order, built in the call, is the layout's; so is the
    order of a table whose order covers other entries."""
    g = _graph(wide=40)
    ref = T.to_neighbor_table(g)
    bare = T.NeighborTable(idx=torch.as_tensor(ref.idx).long(),
                           weight=torch.as_tensor(ref.weight),
                           in_degrees=torch.as_tensor(ref.in_degrees),
                           num_nodes=g.num_nodes,
                           num_recipients=ref.num_recipients)
    built = gather_order(bare.idx, g.num_nodes)
    for f in ('perm', 'ptr', 'chunks'):
        assert torch.equal(getattr(built, f), getattr(ref.gather_order, f))
    assert (built.levels, built.partials, built.split_rows) == (
        ref.gather_order.levels, ref.gather_order.partials,
        ref.gather_order.split_rows)
    cfg = TE.FSWConfig(d_in=4, d_out=5)
    X = torch.randn(g.num_nodes, 4, dtype=torch.float64, requires_grad=True)
    G = torch.randn(*bare.idx.shape, 4, dtype=torch.float64)
    P.reset()
    (TE.gather_rows(X, bare, cfg) * G).sum().backward()
    c = P.counters()
    assert c['gather.bwd_order_built'] == 1
    assert c['gather.bwd_split_rows'] == ref.gather_order.split_rows == 1
    assert torch.equal(X.grad, gather_bwd_plain(G.reshape(-1, 4),
                                                ref.gather_order))
    other = dataclasses.replace(bare, idx=bare.idx[1:],
                                gather_order=ref.gather_order)
    X.grad = None
    (TE.gather_rows(X, other, cfg) * G[1:]).sum().backward()
    assert P.counters()['gather.bwd_order_built'] == 2
    assert torch.equal(X.grad, gather_bwd_plain(
        G[1:].reshape(-1, 4), gather_order(other.idx, g.num_nodes)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_plain_sums_in_the_orders_order(dtype):
    """The plain version's bits are the chunked sums written out one row
    at a time (its `index_add_` adds in row order on the CPU), through
    three levels: a run so long that its partials are cut again."""
    rng = np.random.default_rng(2)
    idx = np.concatenate([np.full(3 * CHUNK * CHUNK // 2, 7),
                          rng.integers(0, 50, 900)])
    rng.shuffle(idx)
    o = gather_order(idx.reshape(-1, 4), 60)
    assert len(o.levels) == 4 and o.split_rows == 1
    grad = torch.randn(idx.size, 3, dtype=torch.float64).to(dtype)
    assert torch.equal(gather_bwd_plain(grad, o), _sequential(grad, o))
    assert torch.equal(gather_bwd(grad, o), gather_bwd_plain(grad, o))
    _assert_near_float64(gather_bwd(grad, o), grad, idx, 60, o.levels)


@pytest.mark.parametrize('D', [1, 7, 64])
def test_plain_matches_float64_index_add(D):
    g = _graph(seed=3, wide=150)
    for t in T.to_multi_table(g).tables:
        o = t.gather_order
        for dt in (torch.float32, torch.float64):
            grad = torch.randn(t.idx.size, D, dtype=dt)
            got = gather_bwd_plain(grad, o)
            assert got.dtype == dt
            _assert_near_float64(got, grad, t.idx, g.num_nodes, o.levels)


def test_plain_matches_jax_grad_of_the_jax_gather():
    """JAX's gradient of the JAX package's table gather
    (`jnp.take(X, idx.reshape(-1), axis=0)`), float64 on both sides."""
    import jax
    import jax.numpy as jnp
    g = _graph(seed=4, wide=60)
    t = T.to_neighbor_table(g)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((g.num_nodes, 6))
    G = rng.standard_normal((t.idx.size, 6))
    idx = jnp.asarray(t.idx.reshape(-1))
    want = jax.grad(lambda x: jnp.vdot(jnp.take(x, idx, axis=0),
                                       jnp.asarray(G)))(jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = gather(Xt, torch.as_tensor(t.idx).long(), t.gather_order)
    (out.reshape(-1, 6) * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('aggregate', ['rank', 'sort'])
def test_multi_table_gradient_matches_pytorchs_index_backward(
        aggregate, monkeypatch):
    """`fsw_embed_multi_table`'s gradient in X against the route before
    the order (PyTorch's backward of src[idx]), within float32 rounding."""
    g = _graph(n=200, seed=5, wide=90)
    mt = T.to_multi_table(g).to('cpu')
    cfg = TE.FSWConfig(d_in=8, d_out=9)
    torch.manual_seed(0)
    V = torch.randn(cfg.nSlices, 8)
    V = V / V.norm(dim=1, keepdim=True)
    f = torch.rand(cfg.nSlices) * 3
    X0 = torch.randn(g.num_nodes, 8)
    W = torch.randn(g.num_recipients, cfg.out_dim)

    def grad_x():
        X = X0.clone().requires_grad_(True)
        out = TE.fsw_embed_multi_table(X, mt, V, f, cfg, aggregate=aggregate)
        (out * W).sum().backward()
        return X.grad
    P.reset()
    mine = grad_x()
    assert 'gather.bwd_order_built' not in P.counters()
    assert P.counters()['gather.bwd_split_rows'] >= 1
    monkeypatch.setattr(TE, 'gather', lambda src, idx, order: src[idx])
    before = grad_x()
    # the same terms summed in another order: a few float32 ulps of the
    # largest entry
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(mine, before, rtol=0,
                               atol=16 * eps * before.abs().max().item())


def test_no_gradient_takes_pytorchs_gather_and_counts_no_backward():
    t = T.to_neighbor_table(_graph())
    X = torch.randn(t.num_nodes, 3)
    P.reset()
    TE.gather_rows(X, t.to('cpu'), TE.FSWConfig(d_in=3, d_out=5))
    assert not any(k.startswith('gather.bwd') for k in P.counters())


def test_gather_order_rejects_ids_outside_the_senders():
    with pytest.raises(ValueError, match='sender ids'):
        gather_order(np.array([[0, 4]]), 4)
    o = gather_order(np.array([[0, 1]]), 3)
    with pytest.raises(ValueError, match='senders'):
        gather(torch.randn(4, 2, requires_grad=True), torch.tensor([[0, 1]]),
               o)


def test_launch_counter_is_listed():
    assert ops.launch_counters()['gather_bwd'] is gather_bwd


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is '
                    'False')
    from fsw_gnn_tpu_torch.device import resolve_device
    return resolve_device('cuda')


def _hot_table(n=5000, hot=300_000, seed=0):
    """A 300 k-entry run on sender 0, 20 k entries over senders 1 .. n/2,
    the upper half empty."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.zeros(hot, np.int64),
                          rng.integers(1, n // 2, 20_000)])
    rng.shuffle(idx)
    return idx, gather_order(idx, n)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [64, 127, 128, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_kernel_matches_plain_bits(cuda_device, D, dtype):
    idx, order = _hot_table()
    grad = torch.randn(idx.size, D, dtype=torch.float64).to(dtype)
    want = gather_bwd_plain(grad, order)
    dev_order = order.to(cuda_device)
    g_dev = grad.to(cuda_device)
    before = gather_bwd.launches
    got = gather_bwd(g_dev, dev_order)
    again = gather_bwd(g_dev, dev_order)
    torch.cuda.synchronize()
    assert gather_bwd.launches - before == 2 * (len(order.levels) - 1)
    assert torch.equal(got.cpu(), want)                 # the plain's bits
    assert torch.equal(got, again)                      # on every call
    _assert_near_float64(got.cpu(), grad, idx, order.num_senders,
                         order.levels)
    assert not got[order.num_senders // 2:].any()       # empty senders


@pytest.mark.cuda
@pytest.mark.parametrize('D', [1433, 2865])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_tiles_wide_rows(cuda_device, D, dtype):
    """Rows wider than one warp's tile (Cora's features and the unfused
    route's projections) are cut over the grid, with the plain's bits."""
    idx, order = _hot_table(n=600, hot=3000)
    grad = torch.randn(idx.size, D, dtype=torch.float64).to(dtype)
    got = gather_bwd(grad.to(cuda_device), order.to(cuda_device))
    assert torch.equal(got.cpu(), gather_bwd_plain(grad, order))


@pytest.mark.cuda
def test_kernel_takes_an_offset_gradient_and_raises_on_ints(cuda_device):
    """A gradient whose rows start off the vector alignment narrows the
    vector, with the same bits; integer gradients raise."""
    idx, order = _hot_table(n=300, hot=1000)
    dev = order.to(cuda_device)
    big = torch.randn(idx.size * 64 + 1, device=cuda_device)
    grad = big[1:].view(idx.size, 64)
    got = gather_bwd(grad, dev)
    assert torch.equal(got.cpu(), gather_bwd_plain(grad.cpu(), order))
    with pytest.raises(TypeError):
        gather_bwd(grad.int(), dev)


def _trainer(device):
    from fsw_gnn_tpu_torch.data.datasets import synthetic_planted_partition
    from fsw_gnn_tpu_torch.train import TrainConfig, Trainer
    data = synthetic_planted_partition(num_nodes=400, num_classes=4,
                                       feat_dim=16, seed=0)
    return Trainer(data, TrainConfig(hidden_dims=(16,)), device=device)


@pytest.mark.cuda
def test_trainer_step_launches_the_kernel_not_pytorchs_backward(cuda_device):
    tr = _trainer(cuda_device)
    tr.train_epoch()
    before = gather_bwd.launches
    P.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        tr.train_epoch()
        torch.cuda.synchronize()
    assert gather_bwd.launches > before
    assert 'gather.bwd_order_built' not in P.counters()
    names = [e.key for e in prof.key_averages()]
    assert not any('indexing_backward_kernel' in k for k in names)
    assert any('gather_bwd_kernel' in k for k in names)


@pytest.mark.cuda
def test_backward_captured_in_a_graph_replays_the_eager_bits(cuda_device):
    g = _graph(n=3000, seed=6, wide=400)
    mt = T.to_multi_table(g).to(cuda_device)
    cfg = TE.FSWConfig(d_in=16, d_out=17)
    torch.manual_seed(0)
    V = torch.randn(cfg.nSlices, 16, device=cuda_device)
    f = torch.rand(cfg.nSlices, device=cuda_device)
    X = torch.randn(g.num_nodes, 16, device=cuda_device, requires_grad=True)
    W = torch.randn(g.num_recipients, cfg.out_dim, device=cuda_device)

    def step():
        X.grad = None
        (TE.fsw_embed_multi_table(X, mt, V, f, cfg) * W).sum().backward()
        return X.grad
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        eager = step().clone()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = step()
    X.grad = None
    graph.replay()
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(captured, eager)
