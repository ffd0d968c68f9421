"""The headline benchmark (`fsw_gnn_tpu_torch.bench`, `cli bench`,
`fsw_gnn_tpu_torch.benchmarks.bench_repspread`) against the repository's
bench.py.

  * The JAX side is bench.py as it stands, loaded as a fresh module under
    tiny knobs (its constants are read at import) and built once for the
    module; the locals of its `build` (the edge index, X, the model's
    variables) are read at its return by a profile hook.  The port's
    module takes the same knobs as module constants.
  * Inputs: the edge index, E_real and the MultiTable's indices, row ids
    and weights bit for bit; X bit for bit in float32.
  * Forward: the JAX parameters carried into the port
    (`fswconv_from_jax`), the port's forward against JAX's ('auto': JAX
    sorts on the CPU, the port runs K1's plain version) within rtol 1e-4,
    atol 2e-5 of the scale, the rank tests' tolerance.
  * First update: one step of the port's `run_1` from the JAX parameters,
    its update (lr times the gradient) times N (the port's loss is
    bench.py's divided by N), against bench.py's params - run_1(params) at
    the same tolerance plus half the float32 spacing of each parameter (the
    rounding of bench.py's stepped parameters).
  * Runs: `reset()` then a 3-step run gives the same probe twice, and a
    3-step run the parameters of three 1-step runs, bit for bit (the CPU's
    eager steps).  Graph against eager is checked on the card (smoke phase
    42).
  * Floor: `speed_of_light_step` on a hand-built MultiTable against a count
    by hand.
  * Entry points: `bench.main`, `cli bench` and `bench_repspread.main` with
    `--device cpu` in one subprocess: JSON lines with the JAX scripts' keys
    that name the CPU.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import fsw_gnn_tpu_torch as T
from fsw_gnn_tpu_torch import bench as TB
from fsw_gnn_tpu_torch.graph import MultiTable, NeighborTable

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(FSW_BENCH_NODES='64', FSW_BENCH_DEG='4', FSW_BENCH_DIN='8',
            FSW_BENCH_DOUT='8', FSW_BENCH_STEPS='3', FSW_BENCH_CALLS='1',
            FSW_BENCH_REPS='1')
# the port's module constants of the same knobs
TINY_CONSTS = dict(N_NODES=64, AVG_DEG=4, D_IN=8, D_OUT=8, STEPS_PER_CALL=3,
                   TIMED_CALLS=1, REPS=1)
CONV = dict(in_channels=8, out_channels=8, mlp_layers=3)
RTOL, ATOL_REL = 1e-4, 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _build_with_locals(build):
    """build() and the locals of its frame at its return."""
    seen = {}

    def hook(frame, event, arg):
        if event == 'return' and frame.f_code is build.__code__:
            seen.update(frame.f_locals)
    before = sys.getprofile()
    sys.setprofile(hook)
    try:
        out = build()
    finally:
        sys.setprofile(before)
    return out, seen


@pytest.fixture(scope='module')
def both():
    """(JAX bench's build, its locals, the port's build), at the tiny
    knobs, on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TINY.items():
            mp.setenv(k, v)
        mp.delenv('FSW_BENCH_LAYOUT', raising=False)
        mp.delenv('FSW_BENCH_DTYPE', raising=False)
        spec = importlib.util.spec_from_file_location(
            'jax_headline_bench', ROOT / 'bench.py')
        jbench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jbench)
        jb, jlocals = _build_with_locals(jbench.build)
        for k, v in TINY_CONSTS.items():
            mp.setattr(TB, k, v)
        mp.setattr(TB, 'DTYPE', 'float32')
        tb = TB.build(device='cpu')
    return jb, jlocals, tb


def _load_jax_params(tb, variables):
    """The port build's model holding the JAX variables' parameters."""
    carried = dict(T.fswconv_from_jax(variables, device='cpu', **CONV)
                   .named_parameters())
    with torch.no_grad():
        for name, p in tb['model'].named_parameters():
            p.copy_(carried[name])


def _close(got, want, err_msg=''):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max(),
                               err_msg=err_msg)


def test_inputs_match_jax_bit_for_bit(both):
    jb, jl, tb = both
    np.testing.assert_array_equal(tb['edge_index'], jl['edge_index'])
    assert tb['E_real'] == jb['E_real'] > 0
    assert (tb['layout'], jb['layout']) == ('multi', 'multi')
    jg, tg = jb['graph'], tb['graph']
    assert len(tg.tables) == len(jg.tables)
    for tt, jt, tr, jr in zip(tg.tables, jg.tables, tg.row_ids, jg.row_ids):
        np.testing.assert_array_equal(tt.idx.numpy(), np.asarray(jt.idx))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tt.weight.numpy(),
                                      np.asarray(jt.weight))
    X = np.asarray(jl['X'])
    assert X.dtype == np.float32
    np.testing.assert_array_equal(tb['X'].numpy(), X)
    assert (tb['n_nodes'], tb['d_in'], tb['d_out'], tb['steps_per_call']) \
        == (jb['n_nodes'], jb['d_in'], jb['d_out'], jb['steps_per_call'])


def test_forward_matches_jax(both):
    jb, jl, tb = both
    variables = _np_tree({'params': jb['params'], **jl['fixed']})
    _load_jax_params(tb, variables)
    want = np.asarray(jl['model'].apply(variables, jl['X'], jb['graph']))
    with torch.no_grad():
        got = tb['model'](tb['X'], tb['graph']).numpy()
    assert got.shape == (64, 8)
    _close(got, want)


def test_first_update_is_jax_update_over_n(both):
    """The port's loss is sum(out**2) / N, so its SGD update, lr times the
    gradient, is bench.py's divided by N.  bench.py's update is read as
    params - run_1(params), two float32 parameters the second of which was
    rounded after the update: it is known to within half the float32
    spacing of each parameter, which the tolerance adds."""
    jb, jl, tb = both
    fixed = _np_tree(jl['fixed'])
    params = jb['params']
    after, _, probe = jb['run_1'](params, jb['opt_state'])
    assert np.isfinite(float(probe))
    init = dict(T.fswconv_from_jax({'params': _np_tree(params), **fixed},
                                   device='cpu', **CONV).named_parameters())
    stepped = dict(T.fswconv_from_jax({'params': _np_tree(after), **fixed},
                                      device='cpu', **CONV)
                   .named_parameters())
    _load_jax_params(tb, {'params': _np_tree(params), **fixed})
    tb['run_1']()
    for k, p in tb['model'].named_parameters():
        p0, p1 = init[k].detach().numpy(), stepped[k].detach().numpy()
        want = (p0 - p1).astype(np.float64)         # exact (Sterbenz)
        got = TB.LR * p.grad.double().numpy() * tb['n_nodes']
        assert np.abs(want).max() > 0, k
        slack = 0.5 * np.maximum(np.spacing(np.abs(p0)),
                                 np.spacing(np.abs(p1)))
        err = np.abs(got - want)
        tol = RTOL * np.abs(want) + ATOL_REL * np.abs(want).max() + slack
        assert np.all(err <= tol), (k, float((err - tol).max()),
                                    float(np.abs(want).max()))


def test_runs_restart_from_reset_and_chain(both):
    _, _, tb = both
    assert tb['cuda_graph'] is None
    run3 = tb['make_run'](3)
    tb['reset']()
    first = run3()
    p3 = [p.detach().clone() for p in tb['model'].parameters()]
    tb['reset']()
    second = run3()
    assert torch.equal(first, second) and bool(torch.isfinite(first))
    tb['reset']()
    for _ in range(3):
        probe = tb['run_1']()
    assert torch.equal(probe, first)
    for a, b in zip(p3, tb['model'].parameters()):
        assert torch.equal(a, b)
    tb['reset']()
    moved = any(not torch.equal(a, b) for a, b in
                zip(p3, tb['model'].parameters()))
    assert moved


def test_floor_is_a_count_by_hand():
    """Two degree classes: B = 8 with rows of 2 and 8 real entries, B = 16
    with one row of 12; d_in 1, 128 slices.  Each class's K1f and K1b
    bound is the largest of float32 operations / 67e12, 3 x product
    operations / 495e12 and bytes / 3.35e12, summed."""
    def table(rows, B):
        w = np.zeros((len(rows), B), np.float32)
        for r, d in enumerate(rows):
            w[r, :d] = 1.0
        return NeighborTable(idx=np.zeros((len(rows), B), np.int32),
                             weight=w, in_degrees=w.sum(1))
    mt = MultiTable(tables=(table([2, 8], 8), table([12], 16)),
                    row_ids=(np.arange(2), np.arange(1)),
                    in_degrees=np.zeros(3, np.float32))
    S = 128
    # ranking d entries: d log2 d + d; the real entries' trig 20 (K1f) and
    # 45 (K1b) an entry-slice; products 2 D (K1f) and 6 D (K1b) an entry
    rank_a = (2 * 1 + 2) + (8 * 3 + 8)
    rank_b = 12 * math.log2(12) + 12
    k1f_a = (S * (20 * 10 + rank_a), S * 10 * 2, 4 * (16 + 16 + 2 + 128
                                                     + 128 + 256))
    k1b_a = (S * (45 * 10 + rank_a), S * 10 * 6, 4 * (32 + 16 + 2 + 256
                                                     + 256 + 256))
    k1f_b = (S * (20 * 12 + rank_b), S * 12 * 2, 4 * (16 + 16 + 1 + 128
                                                     + 128 + 128))
    k1b_b = (S * (45 * 12 + rank_b), S * 12 * 6, 4 * (32 + 16 + 1 + 256
                                                     + 256 + 128))
    calls = (k1f_a, k1b_a, k1f_b, k1b_b)
    want = sum(max(o / 67e12, 3 * m / 495e12, b / 3.35e12)
               for o, m, b in calls)
    # the B = 8 class is bound by its bytes, the B = 16 class by its
    # float32 operations
    assert k1f_a[2] / 3.35e12 > k1f_a[0] / 67e12
    assert k1f_b[0] / 67e12 > k1f_b[2] / 3.35e12
    got, detail = TB.speed_of_light_step(mt, S, 3, 1)
    assert got == pytest.approx(want, rel=1e-12)
    assert detail['table_entries'] == 32 and detail['real_entries'] == 22
    assert detail['ops'] == pytest.approx(sum(c[0] for c in calls),
                                          rel=1e-12)
    assert detail['tf32_product_ops'] == sum(c[1] for c in calls)
    assert detail['bytes'] == sum(c[2] for c in calls)


# keys of the JAX scripts' lines that each entry point must print
BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'n_reps',
              'spread_pct', 'min', 'max', 'roofline_edges_per_sec',
              'pct_of_roofline', 'roofline_detail'}
ARM_KEYS = {'arm', 'reps', 'median_Meps', 'spread_pct', 'p10_Meps',
            'max_Meps', 'raw_tn_ms', 'raw_t1_ms'}
# device metrics, which a CPU line must not carry
DEVICE_KEYS = {'ms', 'step_device_ms', 'eager_edges_per_sec',
               'graph_vs_eager_max_abs_diff', 'card'}


def test_entry_points_run_on_the_cpu_and_print_json_lines():
    code = ('import sys\n'
            'from fsw_gnn_tpu_torch import bench, cli\n'
            'from fsw_gnn_tpu_torch.benchmarks import bench_repspread\n'
            'print("# bench", flush=True)\n'
            'bench.main(["--device", "cpu"])\n'
            'print("# cli", flush=True)\n'
            'assert cli.main(["bench", "--device", "cpu"]) == 0\n'
            'print("# repspread", flush=True)\n'
            'bench_repspread.main(["--device", "cpu"])\n')
    env = dict(os.environ, **TINY, FSW_SPREAD_REPS='2', OMP_NUM_THREADS='1',
               MKL_NUM_THREADS='1')
    env.pop('FSW_BENCH_LAYOUT', None)
    env.pop('FSW_BENCH_DTYPE', None)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    blocks, cur = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith('# '):
            cur = blocks.setdefault(line[2:], [])
            continue
        cur.append(json.loads(line))
    assert tuple(blocks) == ('bench', 'cli', 'repspread')
    for name in ('bench', 'cli'):
        (line,) = blocks[name]
        assert BENCH_KEYS <= set(line), (name, BENCH_KEYS - set(line))
        assert line['device'] == 'cpu' and line['probes_finite'] is True
        assert 'plain PyTorch versions on the CPU' in line['runs']
        assert not DEVICE_KEYS & set(line), name
        assert line['pct_of_roofline'] is None
        assert line['vs_baseline'] is None
        assert line['metric'] == 'fsw_conv_fwd_bwd_edges_per_sec'
        assert line['value'] > 0 and line['edges'] > 0
    arms = blocks['repspread']
    assert [a.get('arm') for a in arms] == [
        'A_back2back', 'B_spaced_2s', 'C_long_scan', None]
    for a in arms[:3]:
        assert ARM_KEYS <= set(a) and a['device'] == 'cpu'
        assert a['reps'] == 2 and len(a['raw_tn_ms']) == 2
    assert set(arms[3]['verdict_hints']) == {'rtt_noise_dominates',
                                            'thermal_spacing_effect'}
    assert arms[3]['probes_finite'] is True and arms[3]['device'] == 'cpu'
