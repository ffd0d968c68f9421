"""The ported benchmark scripts of `fsw_gnn_tpu_torch/benchmarks/` (serving,
CSR against tables, the breakdowns, arxiv's scale, multisets, the
cartesian scripts, scaling) against the JAX scripts of `benchmarks/`.

  * Inputs: each port script's `setup` gives the arrays the JAX script
    builds inline, at tiny knob values.  The JAX side is the JAX script as
    it stands: its module statements, then `main`'s statements up to its
    first model, server or timed loop, run from the file's syntax tree
    (`_jax_main`); the cartesian scripts' own draw functions.  Integer
    arrays and draws equal bit for bit; float32 arrays derived by
    arithmetic (the normalized slice rows) within 1 ulp.
  * Functions: the port's functions on those arrays against the JAX
    functions: `fsw_embed_graph` and the sort route in float64 (rtol 1e-9
    of each output's scale: the same expressions, other summation orders),
    `fsw_embed_multi_table` and `fsw_embed_multiset` on the rank route in
    float32 (the JAX Pallas kernels in interpret mode; rtol 1e-4, atol 2e-5
    of the scale, the rank tests' tolerance), `fsw_rank_aggregate_cart`'s
    plain version and `bucket_quadrature(..., 'sort')` in float64 (rtol
    1e-10, atol 1e-12 of the scale).
  * Every script's `main(['--device', 'cpu'])` at tiny knobs, all in one
    subprocess: JSON lines naming the CPU, the first saying the plain
    versions run, no device metric, and the JAX script's keys.
"""
import ast
import contextlib
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / 'benchmarks'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Small shapes: torch's thread pool only adds contention when pytest
    runs several workers on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TINY = dict(SRV_REQUESTS='3', SRV_MAX_NODES='64', SRV_MAX_EDGES='512',
            SRV_DIN='8', SRV_DOUT='4', SRV_REPS='2', FSW_BD_NODES='64', FSW_BD_DEG='4',
            FSW_BD_DIN='8', FSW_BD_EMBED='16', FSW_BD_ITERS='1',
            FSW_BD_STEPS='1', FSW_BD_CALLS='1', FSW_AX_NODES='200',
            FSW_AX_DEG='3', FSW_AX_DIN='8', FSW_AX_HIDDEN='8',
            FSW_AX_EMBED='9', FSW_AX_STEPS='2', FSW_MS_BATCH='2',
            FSW_MS_N='16', FSW_MS_D='4', FSW_MS_EMBED='16',
            FSW_MS_ITERS='1', CART_R='16', CART_B='8', CART_S='8',
            CART_F='4', CART_STEPS='1', CART_CALLS='1', CART_S_LIST='4,8',
            CART_BS='12', FSW_SC_NODES='128', FSW_SC_DEG='4',
            FSW_SC_DIN='8', FSW_SC_HIDDEN='8', FSW_SC_ITERS='1',
            CART_DIFF='1')

# module constants set in the subprocess where the JAX script has no knob
SMALL = {'bench_csr_vs_table': {'N_NODES': 64, 'AVG_DEG': 4}}


@contextlib.contextmanager
def tiny_env():
    saved = {k: os.environ.get(k) for k in TINY}
    os.environ.update(TINY)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port(name):
    """The port's script module with its knobs read under TINY."""
    with tiny_env():
        return importlib.reload(importlib.import_module(
            f'fsw_gnn_tpu_torch.benchmarks.{name}'))


def _jax_module(path, env=TINY):
    """The JAX script's module statements (not `if __name__ ...`) under
    `env`: (namespace, syntax tree)."""
    tree = ast.parse(path.read_text())
    ns = {'__name__': f'_jax_{path.stem}', '__file__': str(path)}
    top = [n for n in tree.body if not isinstance(n, ast.If)]
    with tiny_env():
        exec(compile(ast.Module(body=top, type_ignores=[]), str(path),
                     'exec'), ns)
    return ns, tree


def _jax_main(name, stop, skip=()):
    """The JAX script's `main` body run in its module's namespace up to the
    first statement whose source contains `stop`, leaving out those that
    contain any of `skip`; returns the namespace."""
    path = BENCH / f'{name}.py'
    ns, tree = _jax_module(path)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    body = []
    for n in main.body:
        src = ast.unparse(n)
        if stop in src:
            break
        if not any(k in src for k in skip):
            body.append(n)
    with tiny_env():
        exec(compile(ast.Module(body=body, type_ignores=[]), str(path),
                     'exec'), ns)
    return ns


_NO_MODEL = ('enable_compilation_cache', 'FSWGNN(', 'model.init',
             'GraphServer(', 'print(')


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _same_requests(got, want):
    assert len(got) == len(want)
    for (ge, gx), (we, wx) in zip(got, want):
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gx, wx)


# ---- inputs: setup against the JAX script's inline construction --------

@pytest.mark.parametrize('name', ['bench_serving', 'bench_serving_aba'])
def test_serving_setup_is_the_jax_scripts(name):
    ns = _jax_main(name, stop='for name, srv',
                   skip=_NO_MODEL + ('def mk', 'servers = ['))
    model, classes, class_rows, reqs = _port(name).setup('cpu')
    assert classes == list(ns['classes'])
    assert class_rows == list(ns['class_rows'])
    _same_requests(reqs, ns['reqs'])
    assert model.hidden_dims == (64, int(TINY['SRV_DOUT']))


def test_serving_probes_setup_is_the_jax_scripts():
    ns = _jax_main('probe_serving_budget', stop='def stage_build',
                   skip=_NO_MODEL)
    _, classes, class_rows, ei, X = _port('probe_serving_budget').setup('cpu')
    assert (classes, class_rows) == (list(ns['classes']),
                                     list(ns['class_rows']))
    _same_requests([(ei, X)], [(ns['ei'], ns['X'])])
    ns = _jax_main('probe_serving_fresh', stop='never',
                   skip=_NO_MODEL + ('srv', 'h2d('))
    _, classes, class_rows, fresh, same, bufs = _port(
        'probe_serving_fresh').setup('cpu')
    assert (classes, class_rows) == (list(ns['classes']),
                                     list(ns['class_rows']))
    _same_requests(fresh, ns['fresh'])
    np.testing.assert_array_equal(same, ns['buf'])
    for a, b in zip(bufs, ns['bufs'], strict=True):
        np.testing.assert_array_equal(a, b)


def _same_graph(tg, jg):
    for f in ('src', 'dst', 'row_ptr', 'weight', 'in_degrees'):
        np.testing.assert_array_equal(_np(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert tg.num_edges == jg.num_edges


def _same_multi(tm, jm):
    assert len(tm.tables) == len(jm.tables)
    for tt, jt in zip(tm.tables, jm.tables):
        np.testing.assert_array_equal(_np(tt.idx), np.asarray(jt.idx))
        np.testing.assert_array_equal(_np(tt.weight), np.asarray(jt.weight))
    for a, b in zip(tm.row_ids, jm.row_ids):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_csr_vs_table_setup_is_the_jax_scripts():
    """The JAX script has no knobs: its full size (8192 nodes)."""
    ns = _jax_main('bench_csr_vs_table', stop='cases = {', skip=('print(',))
    g, t, mt, X, cfg, proj, freqs = _port('bench_csr_vs_table').setup(
        'cpu')
    _same_graph(g, ns['g'])
    np.testing.assert_array_equal(_np(t.idx), np.asarray(ns['t'].idx))
    _same_multi(mt, ns['mt'])
    for a, k in ((X, 'X'), (proj, 'proj'), (freqs, 'freqs')):
        np.testing.assert_array_equal(_np(a), np.asarray(ns[k]), err_msg=k)
    assert (cfg.nSlices, cfg.nFreqs) == (ns['cfg'].nSlices,
                                         ns['cfg'].nFreqs)


def test_breakdowns_setup_is_the_jax_scripts():
    ns = _jax_main('bench_breakdown', stop='def proj_gather')
    g, X, cfg, proj, freqs = _port('bench_breakdown').setup('cpu')
    _same_graph(g, ns['g'])
    for a, k in ((X, 'X'), (proj, 'proj'), (freqs, 'freqs')):
        np.testing.assert_array_equal(_np(a), np.asarray(ns[k]), err_msg=k)
    ns = _jax_main('bench_table_breakdown', stop='def gather_all')
    g, mt, X, cfg, proj, freqs = _port('bench_table_breakdown').setup('cpu')
    _same_multi(mt, ns['mt'])
    np.testing.assert_array_equal(_np(X), np.asarray(ns['X']))
    np.testing.assert_array_equal(_np(freqs), np.asarray(ns['freqs']))
    # the unit rows: float32 arithmetic on both sides, within an ulp
    np.testing.assert_allclose(_np(proj), np.asarray(ns['proj']), rtol=0,
                               atol=float(np.finfo(np.float32).eps))


def test_arxiv_and_scaling_setup_is_the_jax_scripts():
    ns = _jax_main('bench_arxiv_scale', stop='model = FSWGNN(')
    g, gl, X, y, mask = _port('bench_arxiv_scale').setup('cpu')
    _same_graph(g, ns['g'])
    assert type(gl).__name__ == ns['layout']
    np.testing.assert_array_equal(_np(X), np.asarray(ns['X']))
    np.testing.assert_array_equal(_np(y), np.asarray(ns['y']))
    ns = _jax_main('bench_scaling', stop='model = FSWGNN(')
    ei, X, y = _port('bench_scaling').setup()
    np.testing.assert_array_equal(ei, np.stack([ns['src'][ns['keep']],
                                                ns['dst'][ns['keep']]]))
    np.testing.assert_array_equal(X, ns['X'])
    np.testing.assert_array_equal(y, ns['y'])


@pytest.fixture(scope='module')
def multiset_case():
    ns = _jax_main('bench_multiset', stop='points = ')
    return ns, _port('bench_multiset').setup('cpu')


def test_multiset_setup_is_the_jax_scripts(multiset_case):
    ns, (cfg, X, W, proj, freqs) = multiset_case
    for a, k in ((X, 'X'), (W, 'W'), (proj, 'proj'), (freqs, 'freqs')):
        np.testing.assert_array_equal(_np(a), np.asarray(ns[k]), err_msg=k)


def _cart_loop_draws(name):
    """bench_cart_kernel's draws: its config loop, each pass up to its
    first function, collecting (P, wn, pad, freqs) by (S, F)."""
    path = BENCH / f'{name}.py'
    ns, tree = _jax_module(path)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    loop = next(n for n in main.body if isinstance(n, ast.For))
    body = []
    for n in loop.body:
        if isinstance(n, ast.FunctionDef):
            break
        body.append(n)
    body += ast.parse('_out[(S, F)] = (P, wn, pad, freqs)').body
    loop.body = body
    pre = [n for n in main.body[:main.body.index(loop)]]
    code = ast.Module(body=pre + [loop], type_ignores=[])
    ns['_out'] = {}
    with tiny_env():
        exec(compile(ast.fix_missing_locations(code), str(path), 'exec'), ns)
    return ns['_out']


def _same_arrays(got, want):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_cartesian_setups_are_the_jax_scripts():
    want = _cart_loop_draws('bench_cart_kernel')
    got = _port('bench_cart_kernel').setup('cpu')
    assert list(got) == list(want)
    for k in want:
        _same_arrays(got[k], want[k])
    ns, _ = _jax_module(BENCH / 'bench_cart_dw.py')
    dw = _port('bench_cart_dw')
    rng = np.random.default_rng(0)
    small, big = dw.setup('cpu')
    _same_arrays(small, ns['_args'](rng, *dw.SMALL))
    _same_arrays(big, ns['_args'](rng, dw.R, dw.B, dw.S, dw.F))
    ns, _ = _jax_module(BENCH / 'bench_cart_waste.py')
    waste = _port('bench_cart_waste')
    rng = np.random.default_rng(0)
    for S, args in waste.setup('cpu').items():
        _same_arrays(args, ns['_args'](rng, waste.R, waste.B, S, waste.F))
    path = BENCH / 'probe_cart_dw_frontier.py'
    ns, tree = _jax_module(path)
    attempt = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name == 'attempt')
    body = [n for n in attempt.body[:next(
        i for i, n in enumerate(attempt.body)
        if isinstance(n, ast.FunctionDef))]
        if 'enable_compilation_cache' not in ast.unparse(n)]
    frontier = _port('probe_cart_dw_frontier')
    for B in frontier.BUCKETS:
        ns['B'] = B
        with tiny_env():
            exec(compile(ast.Module(body=body, type_ignores=[]), str(path),
                         'exec'), ns)
        _same_arrays(frontier.setup('cpu', B),
                     (ns['P'], ns['wn'], ns['pad'], ns['fq']))


# ---- functions: the port's against the JAX package's -------------------

def _close(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def test_csr_and_sort_routes_match_jax_in_float64():
    """bench_csr_vs_table's and bench_breakdown's graph (their
    `random_graph` draw at 64 nodes) through `fsw_embed_graph` and the
    `multi` layout's sort route, float64, on both sides."""
    from fsw_gnn_tpu import embedding as JE
    from fsw_gnn_tpu.embedding import FSWConfig as JCfg
    from fsw_gnn_tpu.graph import from_edge_index as jax_graph
    from fsw_gnn_tpu.graph import to_multi_table as jax_multi
    from fsw_gnn_tpu_torch import embedding as TE
    from fsw_gnn_tpu_torch.graph import from_edge_index, to_multi_table
    ct = _port('bench_csr_vs_table')
    rng = np.random.default_rng(0)
    n = 64
    ei = ct.random_edges(rng, n, 4)
    jg = jax_graph(ei, n, dtype=jnp.float64)
    tg = from_edge_index(ei, n, dtype=np.float64)
    X64 = rng.standard_normal((n, 8))
    p64 = rng.standard_normal((16, 8))
    f64 = np.abs(rng.standard_normal(16)) + 0.1
    jcfg = JCfg(d_in=8, d_out=16, enable_bias=False)
    cfg = TE.FSWConfig(d_in=8, d_out=16, enable_bias=False)
    jX, jp, jf = (jnp.asarray(a) for a in (X64, p64, f64))
    tX, tp, tf = (torch.from_numpy(a) for a in (X64, p64, f64))
    # jitted: the JAX restart scan runs op by op for seconds otherwise
    want = jax.jit(lambda X, p, f: JE.fsw_embed_graph(X, jg, p, f, jcfg))(
        jX, jp, jf)
    _close(TE.fsw_embed_graph(tX, tg, tp, tf, cfg), want, 1e-9, 1e-9)
    jmt = jax_multi(jg)
    want = jax.jit(lambda X, p, f: JE.fsw_embed_multi_table(
        X, jmt, p, f, jcfg, aggregate='sort'))(jX, jp, jf)
    got = TE.fsw_embed_multi_table(tX, to_multi_table(tg).to('cpu'), tp, tf,
                                   cfg, aggregate='sort')
    _close(got, want, 1e-9, 1e-9)


def test_multi_table_rank_route_matches_jax_in_float32():
    """bench_table_breakdown's stage (c) on both sides, float32, the rank
    route (K1's plain version against the JAX kernel in interpret mode)."""
    from fsw_gnn_tpu import embedding as JE
    ns = _jax_main('bench_table_breakdown', stop='def gather_all')
    g, mt, X, cfg, proj, freqs = _port('bench_table_breakdown').setup('cpu')
    want = JE.fsw_embed_multi_table(ns['X'], ns['mt'], ns['proj'],
                                    ns['freqs'], ns['cfg'],
                                    weights_grad=False, aggregate='rank')
    from fsw_gnn_tpu_torch.embedding import fsw_embed_multi_table
    with torch.no_grad():
        got = fsw_embed_multi_table(X, mt, proj, freqs, cfg,
                                    weights_grad=False, aggregate='rank')
    _close(got, want, 1e-4, 2e-5)


@pytest.mark.parametrize('agg', ['rank', 'sort'])
def test_multiset_matches_jax(multiset_case, agg):
    from fsw_gnn_tpu import fsw_embed_multiset as jax_ms
    from fsw_gnn_tpu_torch.embedding import fsw_embed_multiset
    ns, (cfg, X, W, proj, freqs) = multiset_case
    dt = np.float32 if agg == 'rank' else np.float64
    arrs = [np.asarray(ns[k], dt) for k in ('X', 'W', 'proj', 'freqs')]
    want = jax_ms(*(jnp.asarray(a) for a in arrs), ns['cfg'], aggregate=agg)
    got = fsw_embed_multiset(*(torch.from_numpy(a) for a in arrs), cfg,
                             aggregate=agg)
    if agg == 'rank':
        _close(got, want, 1e-4, 2e-5)
    else:
        _close(got, want, 1e-9, 1e-9)


def test_cartesian_functions_match_jax_in_float64():
    from fsw_gnn_tpu.embedding import FSWConfig as JCfg
    from fsw_gnn_tpu.embedding import bucket_quadrature as jax_bq
    from fsw_gnn_tpu.ops.fsw_rank_pallas import \
        fsw_rank_aggregate_cart as jax_cart
    from fsw_gnn_tpu_torch.embedding import bucket_quadrature
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_aggregate_cart_plain
    dw = _port('bench_cart_dw')
    small, big = dw.setup('cpu')
    for args in (small, big):
        a64 = [_np(a).astype(np.float64) for a in args]
        S, F = a64[3].shape
        want = jax_cart(*(jnp.asarray(a) for a in a64), None, True, True)
        got = fsw_rank_aggregate_cart_plain(*(torch.from_numpy(a)
                                              for a in a64))
        _close(got, want, 1e-10, 1e-12)
        jcfg = JCfg(d_in=4, n_slices=S, n_freqs=F, enable_bias=False)
        want = jax_bq(*(jnp.asarray(a) for a in a64), jcfg, 'sort')
        got = bucket_quadrature(*(torch.from_numpy(a) for a in a64),
                                dw.cart_cfg(S, F), 'sort')
        _close(got, want, 1e-10, 1e-12)


# ---- every script's main on the CPU -------------------------------------

SCRIPTS = ('bench_serving', 'bench_serving_aba', 'probe_serving_budget',
           'probe_serving_fresh', 'bench_csr_vs_table', 'bench_breakdown',
           'bench_table_breakdown', 'bench_arxiv_scale', 'bench_multiset',
           'bench_cart_kernel', 'bench_cart_dw', 'bench_cart_waste',
           'probe_cart_dw_frontier', 'bench_scaling')
# keys of the JAX script's lines that each port script must print (a
# time's key is 'cpu_ms' or '..._cpu_ms' on the CPU where the JAX script
# says 'ms')
KEYS = {
    'bench_serving': {'server', 'first_request_s', 'requests', 'req_per_s',
                      'p50_ms', 'p90_ms', 'max_ms', 'compiles', 'fallbacks',
                      'mode', 'cross_check_rel_err', 'ok'},
    'bench_serving_aba': {'server', 'first_request_s', 'requests', 'p50_ms',
                          'p90_ms', 'cross_check', 'rel_err', 'ok'},
    'probe_serving_budget': {'carrier_bytes', 'stage', 'p50_ms', 'min_ms',
                             'max_ms'},
    'probe_serving_fresh': {'server', 'repeat_same_p50_ms', 'fresh_p50_ms',
                            'h2d_760KB_same_p50_ms',
                            'h2d_760KB_fresh_p50_ms'},
    'bench_csr_vs_table': {'multi_classes', 'rows', 'case', 'cpu_ms'},
    'bench_breakdown': {'stage', 'cpu_ms'},
    'bench_table_breakdown': {'stage', 'cpu_ms', 'edges', 'stages_cpu_ms'},
    'bench_arxiv_scale': {'nodes', 'edges', 'layout', 'ms_per_step',
                          'edges_per_s', 'final_loss'},
    'bench_multiset': {'case', 'cpu_ms'},
    'bench_cart_kernel': {'S', 'F', 'impl', 'fwd_bwd_cpu_ms',
                          'speedup_rank_vs_sort'},
    'bench_cart_dw': {'stage', 'seconds', 'grad', 'rel_err_vs_sort', 'ok',
                      'variant', 'fwd_bwd_cpu_ms'},
    'bench_cart_waste': {'S', 'waste', 'variant', 'fwd_bwd_cpu_ms'},
    'probe_cart_dw_frontier': {'B', 'stage'},
    'bench_scaling': {'devices', 'ms_per_step', 'edges_per_s',
                      'scaling_efficiency'},
}


def test_every_script_runs_on_the_cpu_and_prints_json_lines():
    code = ('import importlib, sys\n'
            f'for name in {SCRIPTS!r}:\n'
            '    print("#", name, flush=True)\n'
            '    mod = importlib.import_module('
            '"fsw_gnn_tpu_torch.benchmarks." + name)\n'
            f'    for k, v in {SMALL!r}.get(name, {{}}).items():\n'
            '        setattr(mod, k, v)\n'
            '    mod.main(["--device", "cpu"])\n')
    # one intra-op thread a process (the subprocess and the ranks it
    # launches): at these sizes torch's pool only adds contention when
    # pytest runs several workers on the same cores
    env = dict(os.environ, **TINY, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    blocks, cur = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith('# '):
            cur = blocks.setdefault(line[2:], [])
            continue
        cur.append(json.loads(line))
    assert tuple(blocks) == SCRIPTS
    for name, lines in blocks.items():
        assert len(lines) >= 2, name
        assert 'plain PyTorch versions on the CPU' in lines[0]['runs'], name
        keys = set()
        for fields in lines:
            assert fields['device'] == 'cpu', (name, fields)
            assert 'ms' not in fields, (name, fields)   # no device metric
            keys |= set(fields)
        assert KEYS[name] <= keys, (name, KEYS[name] - keys)
    for f in blocks['bench_serving'] + blocks['bench_serving_aba']:
        assert f.get('ok', True) is True and f.get('compiles', 1) == 1
    assert [f['devices'] for f in blocks['bench_scaling']
            if 'devices' in f] == [1, 2]
    assert any(f.get('knob') == 'CART_DIFF' and f['applies'] is False
               for f in blocks['bench_cart_waste'])
    stages = [f['stage'] for f in blocks['probe_cart_dw_frontier']
              if 'stage' in f]
    assert stages == ['first call', 'ran']
