"""The port's span-and-counter recorder (`utils/profiling.py`) on the CPU:
span nesting and steps, the cost of a span that is off, the spans' clock
against a profiler trace, the gathers' counters against numpy, the set-up
span of the first op, the launch counters in `counters()`, and (on the
card) no counting inside a CUDA-graph capture."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.embedding as TE
from fsw_gnn_tpu_torch import ops
from fsw_gnn_tpu_torch.data.datasets import synthetic_planted_partition
from fsw_gnn_tpu_torch.train import TrainConfig, Trainer
from fsw_gnn_tpu_torch.utils import profiling as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _empty():
    """Every test starts from an empty buffer and no counters."""
    P.reset()
    yield
    P.reset()


def _recorded():
    """The buffer's spans: the set-up spans of whatever test ran first in
    this process are kept for good."""
    return [s for s in P.spans() if not s.name.startswith(P.SETUP)]


def _named(prefix):
    return [s for s in P.spans() if s.name.startswith(prefix)]


def _called(name):
    return [s for s in P.spans() if s.name == name]


def _graph(n=40, seed=0):
    """A random graph with degrees 0 .. 20 (two degree classes and
    padding) and a hub sender."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for r in range(n):
        deg = int(rng.integers(0, 21))
        src += list(rng.integers(0, n, deg))
        dst += [r] * deg
    src += [3] * 15
    dst += list(range(15))
    return T.from_edge_index(np.array([src, dst]), n, dtype=np.float32)


def test_spans_nest_with_parent_and_step():
    with P.recording():
        with P.span('fsw.train.step', step=7):
            with P.span('a', x=1):
                with P.span('b'):
                    pass
            with P.span('c'):
                pass
        with P.span('d'):
            pass
    got = {s.name: s for s in _recorded()}
    assert set(got) == {'fsw.train.step', 'a', 'b', 'c', 'd'}
    assert got['fsw.train.step'].parent is None
    assert got['a'].parent == 'fsw.train.step' and got['a'].attrs == {'x': 1}
    assert got['b'].parent == 'a' and got['c'].parent == 'fsw.train.step'
    assert {got[k].step for k in 'abc'} == {7}
    assert got['fsw.train.step'].step == 7
    assert got['d'].step is None and got['d'].parent is None
    for s in got.values():
        assert s.t0_ns <= s.t1_ns
    assert got['a'].t0_ns <= got['b'].t0_ns <= got['b'].t1_ns <= got['a'].t1_ns
    assert [s.name for s in _recorded()] == ['fsw.train.step', 'a', 'b', 'c',
                                            'd']


def test_named_scope_is_span():
    assert P.named_scope is P.span


def test_off_span_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = P._range

    def spy(*args, **kwargs):
        opened.append(args[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(P, '_range', spy)
    assert not torch.autograd.profiler._is_profiler_enabled
    with P.span('off.outer'):
        with P.span('off.inner', k=2):
            pass
    assert opened == [] and _named('off.') == []
    with P.recording():
        with P.span('on.outer'):
            pass
    assert opened == ['on.outer']
    assert [s.name for s in _named('on.')] == ['on.outer']
    # recording(False) inside recording() turns it off again
    with P.recording(), P.recording(False):
        with P.span('off.again'):
            pass
    assert _named('off.') == []


def test_buffer_keeps_the_newest(monkeypatch):
    import collections
    monkeypatch.setattr(P, '_buffer', collections.deque(maxlen=3))
    with P.recording():
        for i in range(5):
            with P.span(f'n{i}'):
                pass
    assert [s.name for s in _recorded()] == ['n2', 'n3', 'n4']


def test_spans_share_the_profiler_trace_clock(tmp_path):
    """A span's in-memory stamps lie within 1 ms of its record_function
    event, on the trace's clock (ts + baseTimeNanoseconds / 1000)."""
    with P.trace(str(tmp_path), device='cpu'):
        with P.span('clock.warmup'):
            pass
        for i in range(4):
            with P.span(f'clock.{i}'):
                time.sleep(0.002)
                torch.ones(8).sum()
    trace = json.loads((tmp_path / 'trace.json').read_text())
    base_us = trace['baseTimeNanoseconds'] / 1000
    events = {e['name']: e for e in trace['traceEvents']
              if e.get('ph') == 'X'
              and str(e.get('name', '')).startswith('clock.')}
    mine = {s.name: s for s in _named('clock.')}
    assert set(mine) == set(events)
    for i in range(4):
        e, s = events[f'clock.{i}'], mine[f'clock.{i}']
        start = e['ts'] + base_us
        end = start + e['dur']
        assert abs(s.t0_ns / 1000 - start) < 1000, (s, e)
        assert abs(s.t1_ns / 1000 - end) < 1000, (s, e)
        assert s.t1_ns - s.t0_ns >= 2_000_000


def _expected(table):
    idx = np.asarray(table.idx)
    real = int(np.count_nonzero(np.asarray(table.weight)))
    return idx.size, idx.size - real, int(np.bincount(idx.ravel()).max())


@pytest.mark.parametrize('layout', ['table', 'multi'])
@pytest.mark.parametrize('moved', [False, True], ids=['numpy', 'to_cpu'])
def test_gather_counters_match_bincount(layout, moved):
    g = _graph()
    lay = (T.to_neighbor_table(g) if layout == 'table'
           else T.to_multi_table(g))
    tables = [lay] if layout == 'table' else list(lay.tables)
    if layout == 'multi':
        assert len(tables) >= 2
    want = [_expected(t) for t in tables]
    for t, (n, pad, hot) in zip(tables, want):
        assert (t.pad_entries, t.hot_row_entries) == (pad, hot)
    if moved:
        lay = lay.to('cpu')
        tables = [lay] if layout == 'table' else list(lay.tables)
        for t, (n, pad, hot) in zip(tables, want):
            assert isinstance(t.idx, torch.Tensor)
            assert (t.pad_entries, t.hot_row_entries) == (pad, hot)
    cfg = TE.FSWConfig(d_in=3, d_out=5)
    X = torch.randn(g.num_nodes, 3)
    for t in tables:
        TE.gather_rows(X, t.to('cpu'), cfg)
    c = P.counters()
    assert c['gather.entries'] == sum(n for n, _, _ in want)
    assert c['gather.pad_entries'] == sum(p for _, p, _ in want)
    # the source takes no gradient: no backward, no hot row
    assert 'gather.hot_row_entries' not in c
    Xg = X.clone().requires_grad_(True)
    for t in tables:
        TE.gather_rows(Xg, t.to('cpu'), cfg)
    assert P.counters()['gather.hot_row_entries'] == max(
        h for _, _, h in want)
    with torch.no_grad():
        P.reset()
        TE.gather_rows(Xg, tables[0].to('cpu'), cfg)
    assert 'gather.hot_row_entries' not in P.counters()


def test_gather_of_a_table_without_counts_counts_entries_only():
    idx = torch.tensor([[0, 1, 0], [2, 0, 0]])
    t = T.NeighborTable(idx=idx, weight=torch.ones(2, 3),
                        in_degrees=torch.ones(2), num_nodes=3,
                        num_recipients=2, num_edges=6)
    TE.gather_rows(torch.randn(3, 2, requires_grad=True), t,
                   TE.FSWConfig(d_in=2, d_out=3))
    assert {k: v for k, v in P.counters().items()
            if k.startswith('gather.')} == {'gather.entries': 6}


def test_unfused_route_counts_its_gather_and_names_its_route():
    """The unfused route gathers the projections Xp, which the slice
    vectors differentiate; the table's span carries the route."""
    g = _graph(seed=1)
    tbl = T.to_neighbor_table(g).to('cpu')
    cfg = TE.FSWConfig(d_in=3, d_out=5)
    X = torch.randn(g.num_nodes, 3)
    V = torch.randn(5, 3, requires_grad=True)
    f = torch.rand(5)
    with P.recording():
        TE.fsw_embed_table(X, tbl, V, f, cfg, aggregate='sort')
    (s,) = _called('fsw.embed.table')
    assert s.attrs == {'route': 'sort', 'B': tbl.bucket_size,
                       'R': tbl.idx.shape[0]}
    (gs,) = _called('fsw.gather')
    assert gs.parent == 'fsw.embed.table'
    c = P.counters()
    assert c['gather.entries'] == tbl.idx.numel()
    assert c['gather.pad_entries'] == tbl.pad_entries
    assert c['gather.hot_row_entries'] == tbl.hot_row_entries


def test_trainer_step_spans():
    """One recorded Trainer step: the step and its five parts, one
    `fsw.gnn.layer` a conv, and the embedding's spans below them, all of
    the step's id."""
    data = synthetic_planted_partition(num_nodes=60, num_classes=3,
                                       feat_dim=5, seed=0)
    tr = Trainer(data, TrainConfig(hidden_dims=(4,)), device='cpu')
    tr.train_epoch()
    assert _named('fsw.train') == []
    with P.recording():
        tr.train_epoch()
    (step,) = _called('fsw.train.step')
    assert step.step == 1 and step.parent is None
    parts = [s.name for s in P.spans() if s.parent == 'fsw.train.step']
    assert parts == ['fsw.train.forward', 'fsw.train.loss',
                     'fsw.train.backward', 'fsw.train.optimizer',
                     'fsw.train.readback']
    layers = _called('fsw.gnn.layer')
    assert [s.attrs['layer'] for s in layers] == [0, 1]
    assert {s.parent for s in layers} == {'fsw.train.forward'}
    assert len(_called('fsw.conv')) == len(_called('fsw.embed')) == 2
    assert len(_called('fsw.mlp_head')) == 2
    entries = [s.name for s in P.spans() if s.parent == 'fsw.embed']
    assert len(entries) == 2
    assert set(entries) <= {'fsw.embed.multi_table', 'fsw.embed.table'}
    for s in P.spans():
        if s.name.startswith(('fsw.train', 'fsw.gnn', 'fsw.conv',
                              'fsw.embed', 'fsw.gather', 'fsw.mlp')):
            assert s.step == 1, s
            assert step.t0_ns <= s.t0_ns <= s.t1_ns <= step.t1_ns
    routes = {s.attrs['route'] for s in _called('fsw.embed.table')}
    assert routes <= {'rank_proj', 'rank', 'sort'} and routes


def test_counters_hold_the_launch_counters():
    ops.fsw_rank_aggregate_proj.launches += 3
    try:
        c = P.counters()
        counts = ops.launch_counts()
        assert counts
        for k, v in counts.items():
            assert c[f'launch.{k}'] == v
        assert c['launch.fsw_rank_fwdp'] >= 3
    finally:
        ops.fsw_rank_aggregate_proj.launches -= 3


def test_count_and_gauge_max():
    P.count('x')
    P.count('x', 4)
    P.gauge_max('g', 3)
    P.gauge_max('g', 2)
    P.gauge_max('g', 9)
    c = P.counters()
    assert c['x'] == 5 and c['g'] == 9


def test_first_op_is_recorded_once_a_process():
    code = """
import json, torch
from fsw_gnn_tpu_torch.ops import fsw_rank_aggregate, segcumsum
from fsw_gnn_tpu_torch.utils import profiling as P
P_ = torch.randn(3, 4, 5)
args = (P_, torch.rand(3, 4), torch.zeros(3), torch.rand(5))
fsw_rank_aggregate(*args)
segcumsum(torch.ones(6), torch.tensor([0, 0, 1, 1, 1, 2]))
fsw_rank_aggregate(*args)
print(json.dumps([[s.name, s.attrs.get('op'), s.t1_ns - s.t0_ns]
                  for s in P.spans()]))
"""
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    first = [s for s in got if s[0] == 'fsw.setup.first_op']
    assert len(first) == 1
    assert first[0][1] == 'fsw_gnn_tpu_torch::fsw_rank_aggregate'
    assert first[0][2] > 0


@pytest.mark.cuda
def test_counters_do_not_advance_during_a_capture():
    """Neither the recorder's counters nor a gather's count a capture,
    which runs nothing; the eager warm-up before it counts."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: torch.cuda.is_available() is '
                    'False')
    dev = torch.device('cuda', 0)
    tbl = T.to_neighbor_table(_graph()).to(dev)
    cfg = TE.FSWConfig(d_in=3, d_out=5)
    X = torch.randn(tbl.num_nodes, 3, device=dev, requires_grad=True)

    def work():
        P.count('cap.n', 2)
        P.gauge_max('cap.g', 5)
        return TE.gather_rows(X, tbl, cfg).sum()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        work()
    torch.cuda.current_stream(dev).wait_stream(side)
    before = P.counters()
    assert before['cap.n'] == 2 and before['cap.g'] == 5
    assert before['gather.entries'] == tbl.idx.numel()
    P.gauge_max('cap.g', 1)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        P.gauge_max('cap.g', 50)
        work()
    graph.replay()
    torch.cuda.synchronize(dev)
    assert P.counters() == before
