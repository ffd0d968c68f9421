"""The plain versions of K3's probes against the JAX probes they port, and
the four ported scripts' `main` on the CPU.

Each JAX probe defines its kernel inside `main()`; the tests run `main`'s
statements from the file's syntax tree, as it stands, up to the function
that makes the kernel, with the probe's own knobs set small, and call it:

  * P2 (`benchmarks.probe_fill_floor`): `build(ablate, k)(v, m)` in
    interpret mode (FSW_PROBE_INTERPRET=1) at N 4096, ROWS 8, segments of
    64 and 700 (crossing rows and tiles), on the probe's own v and m: io,
    fill1 and fill7 bit for bit, the rest within 1e-5 max(1, |JAX|); full
    also against the float64 oracle.
  * P3 (`benchmarks.probe_segcumsum_fill`): `run_mask` in interpret mode
    (SEG_INTERPRET=1, small SEG_*) with the mask and packed, against the
    plain mask and packed forms within the probe's 1e-4 of max(1, |JAX|),
    and once with zero values at segment ends (-0.0 packed).
  * P5 (`benchmarks.probe_segscan_variants`): `segcumsum(values, ids,
    name)` with its `pallas_call` in interpret mode (the name `pl` replaced
    after `main`'s imports), on the probe's 40000-element case: within
    1e-5 max(1, |JAX|), and within the probe's 1e-3 of float64.
  * The four scripts' `main` on `--device cpu` at tiny knobs, in one
    subprocess: every line a JSON object naming the CPU.
"""
import ast
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fsw_gnn_tpu_torch.benchmarks import _timing
from fsw_gnn_tpu_torch.benchmarks import probe_fill_floor as P2
from fsw_gnn_tpu_torch.benchmarks import probe_segcumsum_fill as P3
from fsw_gnn_tpu_torch.benchmarks import probe_segscan_variants as P5

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / 'benchmarks'


def _probe(name, env, stop, patch=None):
    """The namespace of benchmarks/<name>.py's module statements and of
    `main`'s statements up to the one `stop` picks, run with `env` set;
    `patch(ns)` runs after `main`'s imports."""
    src = BENCH / f'{name}.py'
    saved = {k: os.environ.get(k) for k in env}
    path = list(sys.path)
    os.environ.update(env)
    try:
        tree = ast.parse(src.read_text())
        ns = {'__name__': f'_{name}', '__file__': str(src)}
        top = [n for n in tree.body
               if not isinstance(n, (ast.If, ast.FunctionDef))]
        main = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == 'main')
        body = main.body[:next(i for i, n in enumerate(main.body)
                               if stop(n)) + 1]
        imports = [n for n in body
                   if isinstance(n, (ast.Import, ast.ImportFrom))]
        for part in (top, imports, None,
                     [n for n in body if n not in imports]):
            if part is None:
                if patch:
                    patch(ns)
                continue
            exec(compile(ast.Module(body=part, type_ignores=[]), str(src),
                         'exec'), ns)
    finally:
        sys.path[:] = path                   # the probes insert their dirs
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ns


def _defines(name):
    return lambda n: isinstance(n, ast.FunctionDef) and n.name == name


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert got.shape == want.shape and err.max() <= tol, err.max()


# ---- P2 ------------------------------------------------------------------

@pytest.fixture(scope='module', params=[64, 700], ids=['seg64', 'seg700'])
def p2(request):
    def quiet(ns):
        ns['enable_compilation_cache'] = lambda: None   # no cache on disk
    ns = _probe('probe_fill_floor',
                dict(FSW_PROBE_INTERPRET='1', FSW_SEGBENCH_N='4096',
                     FSW_SEGBENCH_ROWS='8',
                     FSW_SEGBENCH_SEG=str(request.param)),
                _defines('build'), quiet)
    assert (ns['N'], ns['ROWS'], ns['v'].shape) == (4096, 8, (32, 128))
    # `build` reads FSW_PROBE_INTERPRET when it is called
    ns['os'] = types.SimpleNamespace(
        environ=dict(os.environ, FSW_PROBE_INTERPRET='1'))
    return ns


@pytest.mark.parametrize('ablate,passes', P2.ABLATIONS)
def test_p2_plain_stages_match_the_jax_probe(p2, ablate, passes):
    want = np.asarray(p2['build'](ablate, passes)(p2['v'], p2['m']))
    v = torch.from_numpy(np.array(p2['v'])).reshape(-1)
    m = torch.from_numpy(np.array(p2['m'])).reshape(-1)
    got = P2.fill_floor(v, m, ablate, passes, max_seg=p2['max_seg'],
                        rows=p2['ROWS']).numpy().reshape(want.shape)
    assert got.dtype == np.float32
    if ablate in ('io', 'fill1', 'fill7'):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    else:
        _close(got, want, 1e-5)
    if ablate == 'full':
        ids = np.asarray(p2['ids'])
        bounds = np.flatnonzero(np.diff(ids)) + 1
        oracle = np.concatenate([np.cumsum(c) for c in np.split(
            np.abs(np.asarray(p2['vals'], np.float64)), bounds)])
        _close(got.reshape(-1), oracle, 1e-5)


# ---- P3 ------------------------------------------------------------------

P3_ENV = dict(SEG_INTERPRET='1', SEG_N='4096', SEG_AVG='64', SEG_MAX='512',
              SEG_ROWS='8')


@pytest.fixture(scope='module')
def p3():
    ns = _probe('probe_segcumsum_fill', P3_ENV,
                lambda n: isinstance(n, ast.Assign)
                and getattr(n.targets[0], 'id', None) == 'p2')
    assert (ns['N'], ns['ROWS'], ns['MAX_SEG']) == (4096, 8, 512)
    return ns


def _p3_case(ns, vals, is_end):
    """run_mask's inputs for (vals, is_end) as the probe pads them, and the
    packed values."""
    n = vals.size
    block = ns['ROWS'] * 128
    pad = -(-n // block) * block - n
    packed = np.where(is_end, -vals, vals).astype(np.float32)
    v2 = jnp.asarray(np.pad(vals, (0, pad))).reshape(-1, 128)
    m2 = jnp.asarray(np.pad(is_end.astype(np.int8), (0, pad),
                            constant_values=1)).reshape(-1, 128)
    pk = np.pad(packed, (0, pad))
    pk[n:] = np.float32(-0.0)
    return v2, m2, jnp.asarray(pk).reshape(-1, 128), packed


@pytest.mark.parametrize('zeros_at_ends', [False, True])
def test_p3_plain_forms_match_the_jax_probe(p3, zeros_at_ends):
    vals, is_end = np.array(p3['vals']), np.array(p3['is_end'])
    if zeros_at_ends:
        vals[is_end & (np.arange(vals.size) % 3 == 0)] = 0.0
    v2, m2, p2, packed = _p3_case(p3, vals, is_end)
    n = vals.size
    by_mask = np.asarray(p3['run_mask'](v2, m2, False)).reshape(-1)[:n]
    by_sign = np.asarray(p3['run_mask'](p2, m2, True)).reshape(-1)[:n]
    tp = torch.from_numpy(packed)
    assert int(torch.signbit(tp).sum()) == int(is_end.sum())  # -0.0 kept
    plain_mask = P3.segcumsum(torch.from_numpy(vals),
                              boundaries=torch.from_numpy(
                                  is_end.astype(np.int8))).numpy()
    plain_packed = P3.segcumsum_packed(tp).numpy()
    assert np.array_equal(plain_packed, plain_mask)
    _close(plain_mask, by_mask, P3.TOL_REL)
    _close(plain_packed, by_sign, P3.TOL_REL)


# ---- P5 ------------------------------------------------------------------

@pytest.fixture(scope='module')
def p5():
    def interpret(ns):
        pl = ns['pl']
        shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                        if not k.startswith('__')})
        shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
        ns['pl'] = shim
    return _probe('probe_segscan_variants', {}, _defines('segcumsum'),
                  interpret)


@pytest.mark.parametrize('variant', ['roll', 'shift', 'fma'])
def test_p5_plain_loops_match_the_jax_probe(p5, variant):
    vs, ss, want, _, _ = P5.inputs('cpu', n=128)
    ref = np.asarray(p5['segcumsum'](jnp.asarray(vs.numpy()),
                                     jnp.asarray(ss.numpy()), variant))
    got = P5.segscan_variant(vs, ss, variant).numpy()
    assert vs.shape[0] == 40000 and got.dtype == np.float32
    _close(got, ref, 1e-5)
    assert np.abs(got - want.numpy()).max() < P5.CHECK_ATOL


def test_aba_turns_run_forward_then_back():
    calls = []
    fns = {k: functools.partial(calls.append, k) for k in 'abc'}
    out = _timing.aba_ms(fns, torch.device('cpu'), iters=1, reps=1)
    assert calls == list('abc') * 2 + list('abccba')  # warm-up, host time
    assert {k: len(v) for k, v in out.items()} == {'a': 2, 'b': 2, 'c': 2}


def test_card_windows_start_behind_a_sleep_kernel(monkeypatch):
    """A window on the card queues a sleep kernel before its first event,
    long enough for the host to enqueue the window's calls, so no call
    waits for the host (without it a kernel shorter than its Python call
    was timed at the host's rate)."""
    log = []

    class Event:
        def __init__(self, **_):
            pass

        def record(self):
            log.append('record')

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, 'Event', Event)
    monkeypatch.setattr(torch.cuda, '_sleep', lambda c: log.append(c))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    dev = torch.device('cuda')
    assert _timing.median_ms(lambda: log.append('call'), dev, iters=2,
                             reps=1) == 0.5
    cycles = log[2]
    assert log == ['call', 'call', cycles, 'record', 'call', 'call',
                   'record']
    assert 2e-3 * _timing.SLEEP_HZ <= cycles <= (
        _timing.SLEEP_MAX_S * _timing.SLEEP_HZ)


# ---- the scripts -----------------------------------------------------------

SCRIPTS = ('probe_segscan_variants', 'probe_fill_floor',
           'probe_segcumsum_fill', 'bench_segcumsum')
TINY = dict(FSW_SEGBENCH_N='8192', FSW_SEGBENCH_ROWS='16',
            FSW_SEGBENCH_ITERS='1', FSW_SEGBENCH_SEG='700', SEG_N='8192',
            SEG_ROWS='8', SEG_MAX='512', SEG_AVG='64', SEG_ITERS='1')


def test_every_script_runs_on_the_cpu_and_prints_json_lines():
    code = ('import importlib\n'
            f'for name in {SCRIPTS!r}:\n'
            '    print("#", name, flush=True)\n'
            '    importlib.import_module("fsw_gnn_tpu_torch.benchmarks." '
            '+ name).main(["--device", "cpu"])\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          env=dict(os.environ, **TINY), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    blocks, cur = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith('# '):
            cur = blocks.setdefault(line[2:], [])
            continue
        cur.append(json.loads(line))
    assert tuple(blocks) == SCRIPTS
    for name, lines in blocks.items():
        assert 'plain PyTorch versions on the CPU' in lines[0]['runs'], name
        for fields in lines:
            assert fields['device'] == 'cpu', (name, fields)
            assert 'ms' not in fields and 'GB_s' not in fields, (name, fields)
    p5 = [f for f in blocks['probe_segscan_variants'] if 'cpu_ms' in f]
    assert [f['variant'] for f in p5] == ['roll', 'shift', 'fma']
    p2 = {f.get('ablate') for f in blocks['probe_fill_floor']}
    assert {a for a, _ in P2.ABLATIONS} <= p2
    assert any('stage_ms' in f for f in blocks['probe_fill_floor'])
    p3 = [f.get('variant') for f in blocks['probe_segcumsum_fill']]
    assert {'ids(default)', 'ids(highest)', 'ids(scan)', 'mask8',
            'packed'} <= set(p3)
    assert any(f.get('packed_is_mask_bits') for f in
               blocks['probe_segcumsum_fill'])
    last = blocks['bench_segcumsum'][-1]
    assert set(last) >= {'max_rel_disagreement'}
