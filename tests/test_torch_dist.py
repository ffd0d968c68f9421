"""The edge-partitioned forward across 2 and 4 gloo ranks on the CPU
(`parallel.launch`, the worker functions of `parallel/workers.py`) against
the JAX package's on its virtual mesh with the same P and the same
injected parameters, and the overlapped cartesian embedding across ranks
against the JAX single-device embedding.  The train steps are in
tests/test_torch_dist_step.py, which shares these problems.

Tolerances (those of tests/test_torch_gnn.py): float64 on the sort route,
rtol 1e-10 (the same arithmetic up to summation order); where BatchNorm's
running statistics enter, 1e-6 of each value and of the largest (flax
keeps them in float32 and, in eval mode, forms rsqrt(var + eps) from them
in float32); float32 on the rank
route (the port's plain versions against JAX's own route), rtol 1e-4 with
an absolute floor of 1e-4 of the largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fsw_gnn_tpu as J
from fsw_gnn_tpu.parallel import make_distributed_forward, make_graph_mesh
from fsw_gnn_tpu.parallel import partition as jpart

import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch.parallel import (partition_graph,
                                        unshard_recipient_values)
from fsw_gnn_tpu_torch.parallel.launch import launch

SIZES = (2, 4)
EXCHANGES = ('all_gather', 'all_to_all', 'overlap')
N, D_IN, D_EDGE, N_CLASSES = 40, 5, 3, 3
KW = dict(in_channels=D_IN, hidden_dims=(6, N_CLASSES),
          minimize_slice_coherence=False)
MODELS = {
    # name: (constructor arguments, dtype, edge features)
    'bn': (dict(KW, batchnorm=True, bn_axis_name='graph', aggregate='sort'),
           'float64', False),
    'edge': (dict(KW, edgefeat_dim=D_EDGE, aggregate='sort'), 'float64',
             True),
    'f32': (dict(KW), 'float32', False),
}
STEPS = {2: (('bn', 'all_gather'), ('edge', 'all_to_all'), ('f32', 'overlap')),
         4: (('bn', 'all_to_all'), ('edge', 'overlap'),
             ('f32', 'all_gather'))}
CART = {2: dict(d_edge=0, aggregate='sort', chunks=3),
        4: dict(d_edge=2, aggregate='auto', chunks=2)}


def _graph(seed, d_edge=0):
    """N nodes, each with 1 to 12 in-neighbors (two degree classes)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(N):
        nb = rng.choice(np.delete(np.arange(N), v), rng.integers(1, 13),
                        replace=False)
        src += list(nb)
        dst += [v] * len(nb)
    ei = np.stack([src, dst]).astype(np.int64)
    ef = rng.standard_normal((ei.shape[1], d_edge)) if d_edge else None
    return ei, ef


def _problem(name):
    kw, dtype, edge = MODELS[name]
    rng = np.random.default_rng(len(name))
    ei, ef = _graph(7, D_EDGE if edge else 0)
    X = rng.standard_normal((N, D_IN)).astype(dtype)
    y = rng.integers(0, N_CLASSES, N)
    mask = (rng.random(N) < 0.6).astype(dtype)
    jdt = jnp.dtype(dtype)
    g = J.from_edge_index(ei, N, edge_features=ef, dtype=jdt)
    jm = J.FSWGNN(dtype=jdt, **kw)
    # init outside the mesh: the cross-rank BatchNorm needs none there
    init_kw = dict(kw, bn_axis_name=None) if 'bn_axis_name' in kw else kw
    # jitted: flax's init runs the model op by op otherwise
    variables = jax.jit(J.FSWGNN(dtype=jdt, **init_kw).init)(
        jax.random.PRNGKey(0), jnp.asarray(X), g)
    return dict(ei=ei, ef=ef, X=X, y=y, mask=mask, g=g, jm=jm, kw=kw,
                dtype=dtype, variables=variables)


_PROBLEMS, _RUNS, _JAX_FORWARDS = {}, {}, {}


def problem(name):
    if name not in _PROBLEMS:
        _PROBLEMS[name] = _problem(name)
    return _PROBLEMS[name]


def _case(kind, name, **more):
    p = problem(name)
    return dict(kind=kind, edge_index=p['ei'], n=N, edge_feat=p['ef'],
                X=p['X'], y=p['y'], mask=p['mask'], dtype=p['dtype'],
                model=p['kw'],
                variables=jax.tree_util.tree_map(np.asarray,
                                                 p['variables']), **more)


def _cart_problem(P):
    c = CART[P]
    rng = np.random.default_rng(40 + P)
    ei, ef = _graph(11, c['d_edge'])
    cfg = dict(d_in=D_IN, d_edge=c['d_edge'], n_slices=6, n_freqs=3,
               enable_bias=False)
    proj = rng.standard_normal((6, D_IN + c['d_edge']))
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    return dict(kind='overlap_embed', edge_index=ei, n=N, edge_feat=ef,
                dtype='float64', cfg=cfg, proj=proj,
                freqs=np.abs(rng.standard_normal(3)) + 0.1,
                X=rng.standard_normal((N, D_IN)),
                G=rng.standard_normal((N, 6, 3)), chunks=c["chunks"],
                aggregate=c['aggregate'])


def _pipelined_problem(P):
    """The JAX package's overlapped-forward prototype test
    (tests/test_overlap.py): one table a shard, float64."""
    rng = np.random.default_rng(7 + P)
    ei, _ = _graph(13)
    cfg = dict(d_in=D_IN, d_out=12, enable_bias=False)
    S = J.FSWConfig(**cfg).nSlices
    proj = rng.standard_normal((S, D_IN))
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    return dict(kind='pipelined', edge_index=ei, n=N, dtype='float64',
                cfg=cfg, proj=proj,
                freqs=np.abs(rng.standard_normal(S)) + 0.1,
                X=rng.standard_normal((N, D_IN)), chunks=P)


def runs(P, kind):
    """One launch of P ranks for each `kind`: 'forward' (the forwards and
    the cartesian overlap) or 'step' (the train steps); reports by case
    key, one a rank."""
    if (P, kind) not in _RUNS:
        if kind == 'forward':
            keys = [('forward', m, e) for m in ('bn', 'f32')
                    for e in EXCHANGES] + [('cart',), ('pipelined',)]
            cases = [_case(*k[:2], exchange=k[2]) for k in keys[:-2]]
            cases += [_cart_problem(P), _pipelined_problem(P)]
        else:
            keys = [('step', m, e) for m, e in STEPS[P]]
            cases = [_case('step', m, exchange=e) for _, m, e in keys]
        reports = launch(P, 'fsw_gnn_tpu_torch.parallel.workers:graph_cases',
                         dict(cases=cases), device='cpu', timeout=240)
        _RUNS[P, kind] = {k: [r[i] for r in reports]
                          for i, k in enumerate(keys)}
    return _RUNS[P, kind]


def jax_forward(P, name, exchange):
    """The JAX package's distributed forward of problem `name` on its
    virtual mesh of P devices, assembled (one compile for each
    (P, name, exchange): the float32 cases share the all_gather one)."""
    if (P, name, exchange) not in _JAX_FORWARDS:
        p = problem(name)
        js = jpart.partition_graph(p['g'], P)
        fwd = make_distributed_forward(p['jm'], js, make_graph_mesh(P),
                                       p['variables'], exchange=exchange)
        _JAX_FORWARDS[P, name, exchange] = jpart.unshard_recipient_values(
            fwd(jpart.shard_node_features(p['X'], js), js), js)
    return _JAX_FORWARDS[P, name, exchange]


def _tshards(name, P):
    p = problem(name)
    g = T.from_edge_index(p['ei'], N, edge_features=p['ef'],
                          dtype=np.dtype(p['dtype']))
    return partition_graph(g, P)


def _close(got, want, dtype, stats=False):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    if dtype == 'float64' and not stats:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    else:
        tol = 1e-6 if dtype == 'float64' else 1e-4
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize('exchange', EXCHANGES)
@pytest.mark.parametrize('name', ['bn', 'f32'])
@pytest.mark.parametrize('P', SIZES)
def test_distributed_forward_matches_jax(P, name, exchange):
    """Each rank's rows, assembled, against the JAX package's
    `make_distributed_forward` (float64: the same exchange; float32: its
    all_gather forward), and against the port's single-device forward."""
    p = problem(name)
    want = jax_forward(P, name, 'all_gather' if name == 'f32' else exchange)
    reports = runs(P, 'forward')[('forward', name, exchange)]
    got = unshard_recipient_values(np.stack([r['rows'] for r in reports]),
                                   _tshards(name, P))
    bn = 'batch_stats' in p['variables']
    _close(got, want, p['dtype'], stats=bn)
    single = T.fswgnn_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      p['variables']),
                               device='cpu',
                               dtype=getattr(torch, p['dtype']),
                               **p['kw']).eval()
    with torch.no_grad():
        one = single(torch.from_numpy(p['X']),
                     T.auto_layout(T.from_edge_index(
                         p['ei'], N, dtype=np.dtype(p['dtype']))).to('cpu'))
    _close(got, one.numpy(), p['dtype'])


@pytest.mark.parametrize('P', SIZES)
def test_overlapped_cartesian_embed_across_ranks(P):
    """`fsw_embed_local_overlap` in cartesian mode with the chunked
    all-gather over P ranks: the assembled rows, X's gradient and the
    summed gradients of the slice vectors and frequencies against the JAX
    single-device MultiTable embedding (P = 4 with edge features on the
    port's rank route, K4's plain versions: float32 inside)."""
    case = _cart_problem(P)
    cfg = J.FSWConfig(**case['cfg'])
    mt = J.to_multi_table(J.from_edge_index(
        case['edge_index'], N, edge_features=case['edge_feat'],
        dtype=jnp.float64))
    G = jnp.asarray(case['G'])

    def loss(x, v, f):
        out = J.fsw_embed_multi_table(x, mt, v, f, cfg, aggregate='sort')
        return jnp.sum(out * G), out
    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                  has_aux=True))(
        jnp.asarray(case['X']), jnp.asarray(case['proj']),
        jnp.asarray(case['freqs']))
    shards = partition_graph(T.from_edge_index(
        case['edge_index'], N, edge_features=case['edge_feat'],
        dtype=np.float64), P)
    reports = runs(P, 'forward')[('cart',)]
    dt = 'float64' if case['aggregate'] == 'sort' else 'float32'
    _close(unshard_recipient_values(np.stack([r['rows'] for r in reports]),
                                    shards), want, dt)
    _close(unshard_recipient_values(np.stack([r['dX'] for r in reports]),
                                    shards), grads[0], dt)
    _close(sum(r['dproj'] for r in reports), grads[1], dt)
    _close(sum(r['dfreqs'] for r in reports), grads[2], dt)


@pytest.mark.parametrize('P', SIZES)
def test_pipelined_table_embed_matches_jax(P):
    """`make_overlapped_forward` (the JAX package's first overlapped
    embedding, on one table a shard) at P ranks against the JAX one on its
    virtual mesh."""
    from fsw_gnn_tpu.parallel.overlap import make_overlapped_forward
    case = _pipelined_problem(P)
    g = J.from_edge_index(case['edge_index'], N, dtype=jnp.float64)
    js = jpart.partition_graph(g, P, layout='table')
    fwd = make_overlapped_forward(js, make_graph_mesh(P),
                                  J.FSWConfig(**case['cfg']),
                                  jnp.asarray(case['proj']),
                                  jnp.asarray(case['freqs']),
                                  n_chunks=case['chunks'])
    want = jpart.unshard_recipient_values(
        fwd(jpart.shard_node_features(case['X'], js)), js)
    shards = partition_graph(T.from_edge_index(
        case['edge_index'], N, dtype=np.float64), P, layout='table')
    got = unshard_recipient_values(
        np.stack([r['rows'] for r in runs(P, 'forward')[('pipelined',)]]),
        shards)
    _close(got, want, 'float64')
