"""The port's profiling helpers (`utils/profiling.py`) on the CPU: the
section timer's summary against the JAX package's on the same sections,
the named ranges of `fsw_embed_graph` in a `trace()`, the Trainer's trace
written through `trace()`, and an exported CSR forward that holds no
profiler op."""
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fsw_gnn_tpu.utils.profiling as JP
import fsw_gnn_tpu_torch as T
import fsw_gnn_tpu_torch.embedding as TE
from fsw_gnn_tpu_torch.data.datasets import synthetic_planted_partition
from fsw_gnn_tpu_torch.train import TrainConfig, Trainer
from fsw_gnn_tpu_torch.utils import SectionTimer, named_scope, trace

N, D_IN = 30, 4


def _edges(seed=0, n=N):
    rng = np.random.default_rng(seed)
    A = rng.random((n, n)) < 0.2
    np.fill_diagonal(A, False)
    return np.stack(np.nonzero(A)).astype(np.int64)


def _sections(timer, arrays):
    """The same sections on either timer: two named blocks, one twice,
    and a timed function."""
    for _ in range(2):
        with timer.section('build', result=arrays):
            pass
    with timer.section('apply'):
        pass
    out = timer.time_fn('fn', lambda a: a, arrays)
    return out


def test_section_timer_summary_matches_jax():
    x = np.arange(6.0)
    jt, tt = JP.SectionTimer(), SectionTimer()
    _sections(jt, jnp.asarray(x))
    out = _sections(tt, {'x': torch.from_numpy(x), 'n': 3})
    assert out['n'] == 3 and torch.equal(out['x'], torch.from_numpy(x))
    want, got = jt.summary(), tt.summary()
    assert sorted(got) == sorted(want) == ['apply', 'build', 'fn']
    for name in want:
        assert sorted(got[name]) == sorted(want[name]) == [
            'mean_ms', 'min_ms', 'n', 'total_s']
        assert got[name]['n'] == want[name]['n']
        s = got[name]
        assert 0 <= 1e3 * s['total_s'] / s['n'] - s['mean_ms'] < 1e-9
        assert 0 <= s['min_ms'] <= s['mean_ms']


def _events(path):
    return json.loads(path.read_text())['traceEvents']


def _embed_graph():
    rng = np.random.default_rng(1)
    g = T.from_edge_index(_edges(1), N, dtype=np.float32)
    cfg = TE.FSWConfig(d_in=D_IN, d_out=7)
    X = torch.from_numpy(rng.standard_normal((N, D_IN)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((7, D_IN)).astype(np.float32))
    f = torch.from_numpy(rng.random(7).astype(np.float32))
    return lambda: TE.fsw_embed_graph(X, g, V, f, cfg, slice_chunk=4)


def test_trace_of_fsw_embed_graph_holds_the_named_ranges(tmp_path):
    """fsw_embed_graph marks 'fsw_project' and 'fsw_segcumsum' (the JAX
    embedding's named scopes) once a slice chunk; a CPU trace written by
    `trace()` holds both, and the output is the untraced call's."""
    run = _embed_graph()
    with trace(str(tmp_path / 'tr'), device='cpu') as prof:
        out = run()
    names = [e.get('name') for e in _events(tmp_path / 'tr' / 'trace.json')]
    assert names.count('fsw_project') == 2          # 7 slices, chunks of 4
    assert names.count('fsw_segcumsum') == 2
    assert any(n.startswith('aten::') for n in names if n)
    assert not any(e.get('cat') == 'kernel' for e in
                   _events(tmp_path / 'tr' / 'trace.json'))
    assert 'fsw_project' in {e.key for e in prof.key_averages()}
    assert torch.equal(out, run())


def test_trace_writes_on_error(tmp_path):
    """A block that raises still leaves its trace."""
    with pytest.raises(ValueError):
        with trace(str(tmp_path), device='cpu'):
            with named_scope('inside'):
                torch.ones(3).sum()
            raise ValueError('stop')
    names = [e.get('name') for e in _events(tmp_path / 'trace.json')]
    assert 'inside' in names


def test_trainer_trace_goes_through_trace(tmp_path, monkeypatch):
    """`Trainer(trace_dir=...)` writes trace_dir/trace.json through
    `utils.profiling.trace`, for the trainer's own device, around the
    epochs."""
    from fsw_gnn_tpu_torch.train import trainer as TT
    seen = []
    real = TT.trace

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)
    monkeypatch.setattr(TT, 'trace', spy)
    data = synthetic_planted_partition(num_nodes=48, num_classes=3,
                                       feat_dim=6, seed=0)
    Trainer(data, TrainConfig(hidden_dims=(4,), epochs=2, eval_every=2,
                              trace_dir=str(tmp_path)), device='cpu').fit()
    assert seen == [((str(tmp_path),), {'device': torch.device('cpu')})]
    names = {e.get('name') for e in _events(tmp_path / 'trace.json')}
    assert any(str(n).startswith('aten::') for n in names)


def test_export_of_the_csr_forward_has_no_profiler_op():
    """The named ranges leave no op in an exported CSR forward, which
    loads and gives the module's bits."""
    rng = np.random.default_rng(2)
    g = T.from_edge_index(_edges(2), N, dtype=np.float32)
    conv = T.FSWConv(D_IN, 5, mlp_layers=2, minimize_slice_coherence=False,
                     device='cpu', generator=torch.Generator().manual_seed(0))
    X = torch.from_numpy(rng.standard_normal((N, D_IN)).astype(np.float32))
    blob = T.export_forward(conv, X, g, device='cpu')
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert any('segcumsum' in t for t in targets)       # the CSR route
    assert not any('profiler' in t or 'record_function' in t
                   for t in targets), targets
    with torch.no_grad():
        assert torch.equal(T.load_forward(blob)(X), conv.eval()(X, g))
