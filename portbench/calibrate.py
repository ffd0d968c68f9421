"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's compared numbers over many seeds (the
lower reading), the control's (the plain reference in TF32, the precision
below the configuration's float32 with TF32 off, put in the program's
place) and each planted fault's (`faults.py`) over a few seeds.  The
benchmark's own runs never run this.

    python3 -m portbench.calibrate --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 --fault-seeds 1-3 [--out file.jsonl]

Prints one JSON line a reading ({'seed', 'side', 'numbers'}), then a
summary line: for each number the largest of the program's readings and
the smallest of the control's and of each fault's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .run import ROOT, BUILD, load_module, load_spec, make_inputs, sync


def seeds(text: str) -> list:
    out = []
    for part in text.split(','):
        lo, _, hi = part.partition('-')
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(workload: str, prog_seeds, control_seeds, fault_seeds,
             device=None, root: Path = ROOT, emit=print) -> dict:
    import torch

    from . import compare, reference
    from .faults import FAULTS, planted
    spec = load_spec(root, workload)
    # the readings need the checked steps only, not the window's settle
    cfg, wl = spec['cfg'], {**spec['wl'], 'settle_s': 0.0}
    device = torch.device('cuda', 0) if device is None else device
    if device.type == 'cuda':
        from fsw_gnn_tpu_torch.utils import enable_compilation_cache
        enable_compilation_cache(str(root / BUILD))
    driver = load_module(root, 'drivers', wl['driver'])
    steps = int(wl['checked_steps'])
    blk = wl.get('reference_slice_block')
    out = {'program': [], 'control': []}

    def program(inputs):
        cell = driver.Cell(cfg, wl, inputs, device)
        sync(device)
        got = {'losses': [float(v) for v in cell.first['losses']],
               'out': cell.first['out'], 'grad': cell.first['grad'],
               'change': cell.first['change']}
        del cell
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        return got

    for seed in sorted(set(prog_seeds) | set(control_seeds)
                       | set(fault_seeds)):
        inputs = make_inputs(cfg, seed, device)
        feed = {**inputs, 'features': inputs['X']}
        ref = reference.train_steps(cfg, feed, steps,
                                    reference.Arith(torch.float64), blk)
        sides = []
        if seed in prog_seeds:
            sides.append(('program', lambda: program(inputs)))
        if seed in control_seeds:
            sides.append(('control', lambda: reference.train_steps(
                cfg, feed, steps, reference.Arith(torch.float32, tf32=True),
                blk)))
        if seed in fault_seeds:
            for fault in FAULTS:
                def faulty(fault=fault):
                    with planted(fault, cfg):
                        return program(inputs)
                sides.append((fault, faulty))
        for side, fn in sides:
            got = fn()
            nums = compare.numbers(got, ref)
            out.setdefault(side, []).append(nums)
            emit(json.dumps({'seed': seed, 'side': side, 'numbers': nums,
                             'detail': compare.detail(got, ref)}))
        del ref, inputs, feed
    summary = {}
    for side, rows in out.items():
        if rows:
            pick = max if side == 'program' else min
            summary[side] = {k: pick(r[k] for r in rows) for k in rows[0]}
    emit(json.dumps({'summary': summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='1-12')
    ap.add_argument('--control-seeds', default='1-3')
    ap.add_argument('--fault-seeds', default='1-3')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    sink = open(args.out, 'a') if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + '\n')
            sink.flush()
    try:
        readings(args.workload, seeds(args.seeds), seeds(args.control_seeds),
                 seeds(args.fault_seeds), emit=emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
