"""The headline bench's rep-to-rep spread, arm by arm.

Counterpart of benchmarks/bench_repspread.py.  Every arm times the exact
headline program, `fsw_gnn_tpu_torch.bench.build`'s runs (on the card,
replays of the captured step), with bench's protocol: a rep is
timed(run_hi) - timed(run_1), each the host clock over CALLS calls from the
initial parameters, ended by reading the last call's probe back.

  A back2back   REPS differenced reps, no gaps (the headline protocol,
                more reps): the baseline distribution.
  B spaced      REPS reps with 2 s sleeps: if the median shifts or
                tightens, the card's clock state matters.
  C long        the same protocol with LONGMULT times the steps a run:
                the host's dispatch and readback are a LONGMULT-th of the
                share, so if the spread shrinks that much the variance
                lives on the host, not on the card.
  raw t_n/t_1   each rep's raw wall times of the long and the 1-step
                calls: host noise makes them jitter independently (the
                difference inherits both), clock drift moves them
                together (`corr_tn_t1`, from 4 reps).

Each arm prints its JSON line with the JAX script's keys and the device's
name and power limit, then one `verdict_hints` line.  Every probe must be
finite, or `main` raises after the lines.

    python -m fsw_gnn_tpu_torch.benchmarks.bench_repspread [--device cpu]

Knobs (the JAX script's, with its defaults): FSW_SPREAD_REPS 12,
FSW_SPREAD_CALLS 3, FSW_SPREAD_LONGMULT 3; the workload's are bench's
(FSW_BENCH_*).
"""
from __future__ import annotations

import os
import time

import numpy as np

from .. import bench
from . import _timing

REPS = int(os.environ.get('FSW_SPREAD_REPS', 12))
CALLS = int(os.environ.get('FSW_SPREAD_CALLS', 3))
LONG_MULT = int(os.environ.get('FSW_SPREAD_LONGMULT', 3))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    b = bench.build(device=dev)
    run_n, run_1 = b['run_n'], b['run_1']
    E_real, spc = b['E_real'], b['steps_per_call']
    run_long = b['make_run'](spc * LONG_MULT)
    probes = []

    for run in (run_n, run_1, run_long):     # drain before any timing
        b['reset']()
        probes.append(run())
        float(probes[-1])

    def arm(name, run_hi, hi_steps, sleep_s=0.0):
        tn, t1, eps = [], [], []
        steps = (hi_steps - 1) * CALLS
        for _ in range(REPS):
            if sleep_s:
                time.sleep(sleep_s)
            a = bench.timed(b, run_hi, CALLS, probes)
            c = bench.timed(b, run_1, CALLS, probes)
            tn.append(a)
            t1.append(c)
            eps.append(E_real * steps / max(a - c, 1e-9))
        eps_s = sorted(eps)
        med = float(np.median(eps_s))
        out = {
            'arm': name, 'reps': REPS,
            'median_Meps': med / 1e6,
            'spread_pct': 100 * (eps_s[-1] - eps_s[0]) / med,
            'p10_Meps': eps_s[len(eps_s) // 10] / 1e6,
            'max_Meps': eps_s[-1] / 1e6,
            'raw_tn_ms': [x * 1e3 for x in tn],
            'raw_t1_ms': [x * 1e3 for x in t1],
        }
        if REPS >= 4:
            # clock drift moves t_n and t_1 together; host noise does not
            out['corr_tn_t1'] = float(np.corrcoef(tn, t1)[0, 1])
        _timing.emit(dev, **out)
        return out

    a = arm('A_back2back', run_n, spc)
    bm = arm('B_spaced_2s', run_n, spc, sleep_s=2.0)
    c = arm('C_long_scan', run_long, spc * LONG_MULT)
    hints = {
        'rtt_noise_dominates': bool(c['spread_pct'] < 0.5 * a['spread_pct']),
        'thermal_spacing_effect':
            bool(abs(bm['median_Meps'] - a['median_Meps'])
                 > 0.02 * a['median_Meps'])}
    finite = bench.all_finite(probes)
    _timing.emit(dev, verdict_hints=hints, probes=len(probes),
                 probes_finite=finite)
    if not finite:
        raise RuntimeError('bench_repspread: a probe is not finite')
    return {'arms': [a, bm, c], 'verdict_hints': hints,
            'probes_finite': finite,
            'eager_steps': b['counts']['eager_steps'],
            'classes': (len(b['graph'].tables) if b['layout'] == 'multi'
                        else None)}


if __name__ == '__main__':
    main()
