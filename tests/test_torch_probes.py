"""The plain versions of the benchmark folder's probe kernels against the
JAX probes they port, and every ported benchmark script's `main` on the CPU.

  * P6 (`benchmarks.probe_select_ceiling`): the 21 plain bodies against the
    JAX probe's bodies, taken from benchmarks/probe_select_ceiling.py as it
    stands (its module statements, then `main`'s up to the `BODIES` table,
    run from the file's syntax tree with FSW_PROBE_R/B/S small), and the
    REP loop of `make_kernel` around each.  Tolerance: 1e-5 of max |out|
    (float32 on both sides; libm's and XLA's sin, cos and division round
    apart by an ulp or two, and the bodies sum up to B terms).
  * P1 (`benchmarks.probe_kernel_matmul`): the five plain contractions
    against `jnp.einsum` of the same inputs at the probe's shapes, the
    probe's own `expect`s, float32: 1e-5 of the result's scale.
  * P4 (`benchmarks.probe_emit_pipeline`): the staged forward's plain side
    against the JAX rank kernel's forward (interpret mode), float32, at
    the rank tests' tolerance (2e-5 of the scale, rtol 1e-5).
  * Each script's `main` on `--device cpu` at tiny knobs, all in one
    subprocess (torch imported once): every line is a JSON object naming
    the device, the first says the plain versions run.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fsw_gnn_tpu.ops.fsw_rank_pallas import fsw_rank_aggregate as jax_rank
from fsw_gnn_tpu_torch.benchmarks import probe_emit_pipeline as P4
from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1
from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6

ROOT = Path(__file__).resolve().parent.parent
SELECT = ROOT / 'benchmarks' / 'probe_select_ceiling.py'
PR, PB, PS, PREP = 16, 8, 16, 2


@pytest.fixture(scope='module')
def jax_bodies():
    """The JAX probe's BODIES table, from its file as it stands."""
    saved = {k: os.environ.get(k) for k in ('FSW_PROBE_R', 'FSW_PROBE_B',
                                            'FSW_PROBE_S')}
    os.environ.update(FSW_PROBE_R=str(PR), FSW_PROBE_B=str(PB),
                      FSW_PROBE_S=str(PS))
    try:
        tree = ast.parse(SELECT.read_text())
        ns = {'__name__': '_probe_select_ceiling', '__file__': str(SELECT)}
        top = [n for n in tree.body if not isinstance(n, ast.If)]
        exec(compile(ast.Module(body=top, type_ignores=[]), str(SELECT),
                     'exec'), ns)
        main = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == 'main')
        stop = next(i for i, n in enumerate(main.body)
                    if isinstance(n, ast.Assign)
                    and any(getattr(t, 'id', None) == 'BODIES'
                            for t in n.targets))
        exec(compile(ast.Module(body=main.body[:stop + 1], type_ignores=[]),
                     str(SELECT), 'exec'), ns)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert (ns['R'], ns['B'], ns['S']) == (PR, PB, PS)
    return ns['BODIES']


def _probe_inputs():
    rng = np.random.default_rng(0)
    P = rng.standard_normal((PR, PB, PS)).astype(np.float32)
    wn = rng.random((PR, PB)).astype(np.float32)
    P[:, 1] = P[:, 0]                          # ties for the rank body
    wn[:, -1] = 0.0                            # a padded entry
    return P, wn


def test_p6_table_is_the_jax_probes(jax_bodies):
    assert tuple(jax_bodies) == P6.BODY_NAMES
    for name, (_, ops, steps) in jax_bodies.items():
        assert P6.BODIES[name][1] == ops, name
        assert P6.BODIES[name][2] == (steps == PB), name


@pytest.mark.parametrize('name', P6.BODY_NAMES)
def test_p6_plain_bodies_match_the_jax_probe(jax_bodies, name):
    P, wn = _probe_inputs()
    jbody = jax_bodies[name][0]
    jpos = jnp.broadcast_to(jnp.arange(PB, dtype=jnp.int32)[None, :, None],
                            (PR, PB, PS))
    want = np.asarray(jbody(jnp.asarray(P), jnp.asarray(wn), jpos))
    tpos = torch.arange(PB).view(1, PB, 1)
    got = P6.BODIES[name][0](torch.from_numpy(P), torch.from_numpy(wn),
                             tpos).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # make_kernel's REP loop around the JAX body
    Pj, acc = jnp.asarray(P), jnp.zeros((PR, PS), jnp.float32)
    for _ in range(PREP):
        c = jbody(Pj, jnp.asarray(wn), jpos)
        acc = acc + jnp.sum(c, axis=1)
        Pj = Pj + 1e-30 * c
    got = P6.probe_select(name, torch.from_numpy(P), torch.from_numpy(wn),
                          PREP).numpy()
    np.testing.assert_allclose(got, np.asarray(acc), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(acc)).max())


@pytest.mark.parametrize('name', tuple(P6.PIPE_BODIES))
def test_p6_pipe_bodies_match_a_numpy_loop(name):
    """The three pipe bodies (not of the TPU table) against their steps
    written out in numpy float32: NI chains from P + 0.25 k - 1, each
    PIPE_STEPS steps of v = v a + P (a = 0.5 + 0.25 w), of
    v = P if v < w else w - P, or of v = P + (w - P) [v < w], summed
    over k."""
    P, wn = _probe_inputs()
    w = np.broadcast_to(wn[:, :, None], P.shape)
    a, z = np.float32(0.5) + np.float32(0.25) * w, w - P
    want = np.zeros_like(P)
    for k in range(P6.NI):
        v = P + np.float32(0.25 * k - 1.0)
        for _ in range(P6.PIPE_STEPS):
            if name == 'pipe_ffma':
                v = v * a + P
            elif name == 'pipe_rank':
                v = P + z * (v < w).astype(np.float32)
            else:
                v = np.where(v < w, P, z)
        want = want + v
    got = P6.PIPE_BODIES[name][0](torch.from_numpy(P), torch.from_numpy(wn),
                                  None).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_p1_plain_contractions_match_jnp_einsum():
    """The TPU probe's operands (TR 16, B 32, D 64, S 128) and expects."""
    x = P1.operands(P1.SHAPES[0], 'cpu')
    xj = {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    for kind in P1.KINDS:
        names, eq = P1.SPEC[kind]
        want = np.asarray(jnp.einsum(eq, *(xj[n] for n in names)))
        got = P1.kernel_matmul(kind, *(x[n] for n in names)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32, kind
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=kind)


def test_p4_plain_forward_matches_the_jax_rank_kernel():
    args = P4.inputs('cpu', R=24, B=13, S=20, seed=3)
    args[1][::3, 5] = 0.0                      # padded entries
    want = np.asarray(jax_rank(*(jnp.asarray(a.numpy()) for a in args),
                               None, True, False, False))
    got = P4.fsw_rank_aggregate_staged(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-5 * np.abs(want).max())


SCRIPTS = ('bench_fused_table', 'probe_kernel_matmul',
           'probe_select_ceiling', 'probe_emit_pipeline', 'bench_rank_proj',
           'bench_rank_kernel')
TINY = dict(FSW_FT_NODES='128', FSW_FT_DEG='4', FSW_FT_DIN='8',
            FSW_FT_EMBED='17', FSW_FT_ITERS='1', FSW_PROBE_R='4',
            FSW_PROBE_B='8', FSW_PROBE_S='16', FSW_PROBE_REP='1',
            FSW_PROBE_ITERS='1', BRK_R='8', BRK_B='8', BRK_S='16',
            BRK_STEPS='1', BRK_REPS='1', BRK_CALLS='1', BRP_N='32',
            BRP_R='16', BRP_B='8', BRP_D='8', BRP_S='16', BRP_STEPS='1',
            BRP_CALLS='1')


def test_every_script_runs_on_the_cpu_and_prints_json_lines():
    code = ('import importlib, sys\n'
            f'for name in {SCRIPTS!r}:\n'
            '    print("#", name, flush=True)\n'
            '    importlib.import_module("fsw_gnn_tpu_torch.benchmarks." '
            '+ name).main(["--device", "cpu"])\n')
    env = dict(os.environ, **TINY)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
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
        for fields in lines:
            assert fields['device'] == 'cpu', (name, fields)
            assert 'ms' not in fields, (name, fields)   # no device metric
    variants = [f['variant'] for f in blocks['probe_select_ceiling']
                if 'variant' in f]
    assert tuple(variants) == P6.BODY_NAMES
    pipes = [f['pipe'] for f in blocks['probe_select_ceiling'] if 'pipe' in f]
    assert tuple(pipes) == tuple(P6.PIPE_BODIES)
    cases = {f.get('case') for f in blocks['probe_emit_pipeline']}
    assert {'implicit', 'emit'} <= cases
    assert any(f.get('bit_equal') for f in blocks['probe_emit_pipeline'])
