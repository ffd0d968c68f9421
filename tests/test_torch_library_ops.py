"""The kernels as `torch.library` custom ops (namespace fsw_gnn_tpu_torch),
on the CPU, where each op's implementation is its kernel's plain version.

  * `torch.library.opcheck` on every op at small shapes: its schema, its
    fake implementation (the shapes torch.export and graph capture see),
    its autograd registration and its AOT dispatch, static and dynamic.
  * Gradients through the public functions are the plain backward
    versions' bits (torch.equal): the ops only route to them.
  * The export of a function that calls the public functions holds one
    node of each op.
  * The launch counter skips a capture; K3's workspace is never made
    while a stream captures.

No tolerance is needed: every comparison is bit for bit.  `op_cases` is
also the card's opcheck (`tests/test_torch_cuda.py`), so this file imports
no JAX.
"""
import sys

import numpy as np
import pytest
import torch

import fsw_gnn_tpu_torch.ops.fsw_rank  # noqa: F401  (the modules, below)
import fsw_gnn_tpu_torch.ops.segcumsum  # noqa: F401

R_ = sys.modules['fsw_gnn_tpu_torch.ops.fsw_rank']
K3 = sys.modules['fsw_gnn_tpu_torch.ops.segcumsum']

OP_NAMES = ('fsw_rank_aggregate', 'fsw_rank_aggregate_bwd',
            'fsw_rank_aggregate_proj', 'fsw_rank_aggregate_proj_bwd',
            'fsw_rank_aggregate_cart', 'fsw_rank_aggregate_cart_bwd',
            'segcumsum', 'segcumsum_rows')

# (op, variant) cases for opcheck: each op with and without with_dw (the
# backward's outputs differ), uniform_w, K3 by ids and by mask, reverse
CASES = ('K2f', 'K2f uniform', 'K2b dw', 'K2b', 'K1f', 'K1b dw', 'K1b',
         'K4f', 'K4b dw', 'K4b uniform', 'K3 ids', 'K3 mask reverse',
         'K3 rows', 'K3 rows reverse')


def _inputs(device, R=5, B=6, S=7, D=4, F=3):
    """float32 rank inputs from a seed: normalized weights with padding,
    a phantom mass, an f = 0 slice, tied projections."""
    rng = np.random.default_rng(0)
    real = rng.random((R, B)) < 0.7
    real[:, 0] = True
    w = np.abs(rng.standard_normal((R, B))) * real
    wsp = np.maximum(w.sum(1), 1.0)
    freqs = np.abs(rng.standard_normal(S)) + 0.1
    freqs[1] = 0.0
    P = rng.standard_normal((R, B, S))
    P[:, 1] = P[:, 0]
    arrays = dict(P=P, wn=w / wsp[:, None],
                  pad=np.maximum(1.0 - w.sum(1), 0.0) / wsp, freqs=freqs,
                  Z=rng.standard_normal((R, B, D)),
                  V=rng.standard_normal((D, S)) / np.sqrt(D),
                  fc=np.abs(rng.standard_normal((S, F))) + 0.1,
                  g2=rng.standard_normal((R, S)),
                  g4=rng.standard_normal((R, S, F)),
                  v=rng.standard_normal(300),
                  rows=rng.standard_normal((3, 300)))
    t = {k: torch.from_numpy(a.astype(np.float32)).to(device)
         for k, a in arrays.items()}
    ids = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    t['ids'] = torch.from_numpy(ids).to(device)
    t['mask'] = K3.segment_boundaries(t['ids'])
    return t


def op_cases(device):
    """{case: (op, args)} of every op on `device`; the differentiable
    inputs take a gradient."""
    t = _inputs(device)

    def g(*names):
        return [t[n].clone().requires_grad_(True) for n in names]
    P, wn, pad, f = g('P', 'wn', 'pad', 'freqs')
    Z, V, fc = g('Z', 'V', 'fc')
    ops = torch.ops.fsw_gnn_tpu_torch
    return {
        'K2f': (ops.fsw_rank_aggregate, (P, wn, pad, f, False, True)),
        'K2f uniform': (ops.fsw_rank_aggregate,
                        (P, t['wn'], t['pad'], f, True, False)),
        'K2b dw': (ops.fsw_rank_aggregate_bwd,
                   (t['P'], t['wn'], t['pad'], t['freqs'], t['g2'], False,
                    True)),
        'K2b': (ops.fsw_rank_aggregate_bwd,
                (t['P'], t['wn'], t['pad'], t['freqs'], t['g2'], True,
                 False)),
        'K1f': (ops.fsw_rank_aggregate_proj, (Z, wn, pad, f, V, False,
                                              True)),
        'K1b dw': (ops.fsw_rank_aggregate_proj_bwd,
                   (t['Z'], t['wn'], t['pad'], t['freqs'], t['V'], t['g2'],
                    False, True)),
        'K1b': (ops.fsw_rank_aggregate_proj_bwd,
                (t['Z'], t['wn'], t['pad'], t['freqs'], t['V'], t['g2'],
                 False, False)),
        'K4f': (ops.fsw_rank_aggregate_cart, (P, wn, pad, fc, False, True)),
        'K4b dw': (ops.fsw_rank_aggregate_cart_bwd,
                   (t['P'], t['wn'], t['pad'], t['fc'], t['g4'], False,
                    True)),
        'K4b uniform': (ops.fsw_rank_aggregate_cart_bwd,
                        (t['P'], t['wn'], t['pad'], t['fc'], t['g4'], True,
                         False)),
        'K3 ids': (ops.segcumsum, (g('v')[0], t['ids'], None, None,
                                   False)),
        'K3 mask reverse': (ops.segcumsum, (g('v')[0], None, t['mask'],
                                            None, True)),
        'K3 rows': (ops.segcumsum_rows, (g('rows')[0], t['mask'], False)),
        'K3 rows reverse': (ops.segcumsum_rows, (g('rows')[0], t['mask'],
                                                 True)),
    }


def test_every_kernel_is_an_op():
    """Each of the eight ops is registered with a CPU and a CUDA kernel, a
    fake implementation, and (the forwards) an autograd kernel; the op
    modules hold no torch.autograd.Function any more."""
    for name in OP_NAMES:
        qual = f'fsw_gnn_tpu_torch::{name}'
        for key in ('CPU', 'CUDA', 'Meta'):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (
                name, key)
    for mod in (R_, K3):
        assert not [v for v in vars(mod).values() if isinstance(v, type)
                    and issubclass(v, torch.autograd.Function)], mod


@pytest.mark.parametrize('case', CASES)
def test_opcheck(case):
    op, args = op_cases('cpu')[case]
    torch.library.opcheck(op, args)


def _grads(fn, inputs, g):
    out = fn(*inputs)
    return out, torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize('with_dw', [True, False])
def test_rank_gradients_are_the_plain_bits(with_dw):
    """K1, K2 and K4 forward and backward through the public functions
    against the plain versions on the same inputs, bit for bit; without
    with_dw the weights take no gradient (None) and the rest are the same
    bits."""
    t = _inputs('cpu')
    for kind in ('K1', 'K2', 'K4'):
        if kind == 'K1':
            fn, plain, bwd = (R_.fsw_rank_aggregate_proj,
                              R_.fsw_rank_aggregate_proj_plain,
                              R_.fsw_rank_aggregate_proj_bwd_plain)
            xs = [t['Z'], t['wn'], t['pad'], t['freqs'], t['V']]
            g = t['g2']
        elif kind == 'K2':
            fn, plain, bwd = (R_.fsw_rank_aggregate,
                              R_.fsw_rank_aggregate_plain,
                              R_.fsw_rank_aggregate_bwd_plain)
            xs = [t['P'], t['wn'], t['pad'], t['freqs']]
            g = t['g2']
        else:
            fn, plain, bwd = (R_.fsw_rank_aggregate_cart,
                              R_.fsw_rank_aggregate_cart_plain,
                              R_.fsw_rank_aggregate_cart_bwd_plain)
            xs = [t['P'], t['wn'], t['pad'], t['fc']]
            g = t['g4']
        xs = [x.clone().requires_grad_(i not in (1, 2) or with_dw)
              for i, x in enumerate(xs)]
        out = fn(*xs, with_dw=with_dw)
        assert torch.equal(out, plain(*[x.detach() for x in xs]))
        out.backward(g)
        want = bwd(*[x.detach() for x in xs], g, with_dw=with_dw)
        order = [0, 1, 2, 3, 4] if kind == 'K1' else [0, 1, 2, 3]
        for x, w in zip(xs, [want[i] for i in order]):
            if w is None:
                assert x.grad is None
            else:
                assert torch.equal(x.grad, w), kind


def test_segcumsum_gradients_are_the_plain_bits():
    """K3 flat (ids, mask) and rows: the gradient is the plain reverse
    scan of the cotangent, bit for bit; the output the plain forward."""
    t = _inputs('cpu')
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 300)).astype(np.float32))
    for kw in (dict(segment_ids=t['ids']), dict(boundaries=t['mask'])):
        v = t['v'].clone().requires_grad_(True)
        out = K3.segcumsum(v, **kw)
        assert torch.equal(out, K3.segcumsum_plain(t['v'], **kw))
        out.backward(g[0])
        assert torch.equal(v.grad, K3._plain(g[0], kw.get('segment_ids'),
                                             kw.get('boundaries'), None,
                                             True))
    v = t['rows'].clone().requires_grad_(True)
    out = K3.segcumsum_rows(v, t['mask'])
    assert torch.equal(out, K3.segcumsum_rows_plain(t['rows'], t['mask']))
    out.backward(g)
    assert torch.equal(v.grad, K3.segcumsum_rows_plain(g, t['mask'],
                                                       reverse=True))


def test_once_differentiable():
    """A second derivative through an op's backward raises, as through the
    torch.autograd.Functions the ops replace."""
    t = _inputs('cpu')
    P = t['P'].clone().requires_grad_(True)
    out = R_.fsw_rank_aggregate(P, t['wn'], t['pad'], t['freqs'],
                                with_dw=False)
    g, = torch.autograd.grad((out * out).sum(), P, create_graph=True)
    with pytest.raises(RuntimeError, match='once_differentiable'):
        g.sum().backward()


def test_export_sees_one_op_each():
    """torch.export of a function of the public entry points: one node of
    each kernel's op, nothing of its plain version's arithmetic."""
    t = _inputs('cpu')

    class M(torch.nn.Module):
        def forward(self, Z, V, rows):
            a = R_.fsw_rank_aggregate_proj(Z, t['wn'], t['pad'], t['freqs'],
                                           V, with_dw=False)
            return a, K3.segcumsum_rows(rows, t['mask'])
    ep = torch.export.export(M(), (t['Z'], t['V'], t['rows']))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert targets.count('fsw_gnn_tpu_torch.fsw_rank_aggregate_proj.default'
                         ) == 1
    assert targets.count('fsw_gnn_tpu_torch.segcumsum_rows.default') == 1
    a, b = ep.module()(t['Z'], t['V'], t['rows'])
    assert torch.equal(a, R_.fsw_rank_aggregate_proj_plain(
        t['Z'], t['wn'], t['pad'], t['freqs'], t['V']))
    assert torch.equal(b, K3.segcumsum_rows_plain(t['rows'], t['mask']))


def test_launch_counter_skips_a_capture(monkeypatch):
    """`_count` adds a launch unless the stream is capturing a graph."""
    def fn():
        pass
    fn.launches = 0
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    R_._count(fn)
    assert fn.launches == 0
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: False)
    R_._count(fn)
    assert fn.launches == 1


def test_k3_workspace_never_made_under_capture(monkeypatch):
    """K3's workspace: made zeroed at a stream's first call, kept for a
    call that fits, made twice as large (the old one kept alive for the
    graphs that use it) for one that does not; under a capture a call
    that needs a new one raises and one that fits reuses it."""
    dev, key = torch.device('cpu'), (None, 12345)
    monkeypatch.setattr(K3, '_WS', {})
    monkeypatch.setattr(K3, '_RETIRED', [])
    nbytes = lambda cap: 64 * cap                           # noqa: E731
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    with pytest.raises(RuntimeError, match='before the capture'):
        K3._workspace(dev, key[1], 10, nbytes)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: False)
    ws, cap = K3._workspace(dev, key[1], 10, nbytes)
    assert cap == 10 and ws.numel() == 640 and not bool(ws.any())
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    assert K3._workspace(dev, key[1], 7, nbytes)[0] is ws
    with pytest.raises(RuntimeError):
        K3._workspace(dev, key[1], 11, nbytes)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: False)
    ws2, cap2 = K3._workspace(dev, key[1], 11, nbytes)
    assert cap2 == 20 and ws2 is not ws and K3._RETIRED[0][0] is ws
