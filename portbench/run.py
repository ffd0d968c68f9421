"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything about a cell is found by name: its entry in BENCHMARK.json (the
configuration, the end-to-end and per-layer metrics that apply to it), the
configuration `portbench/configs/<config>.json` (model, data, training),
the workload `portbench/workloads/<cell>.json` (driver, layout, window
calls, trace part, the limits of the comparison), the driver
`portbench/drivers/<driver>.py` and one reader a metric,
`portbench/metrics/<metric>.py` (a metric split by cells,
`<quantity>.<part>`, is read by `<quantity>.py` where it has no file of its
own).  A configuration or workload may bring
its own parts as files too: a data generator that `gen.py` does not have
(`portbench/generators/<generator>.py`), a model kind
(`portbench/models/<kind>.py`) and a reference
(`portbench/references/<reference>.py`, named by the workload).

A run: the inputs and initial leaves from the seed (`gen.py`), the
driver's set-up (the program's model and optimizer, the warm-up and the
checked first steps), then the measured window of `--seconds` (calls of the
driver until the time is up, ended by a synchronise), with `--trace 1` a
profiled part of it, then the plain reference (`reference.py`, or the
workload's own) over the same first steps once the program's state is
freed, and the comparison (`compare.py`).  The last line of standard
output is the JSON result; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.  Exits 2
without a result where the card is missing, and 3 where the window's
process holds JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BUILD = 'portbench/_build'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fsw_gnn_tpu')


def process_start() -> float:
    """time.time() at which this process started (/proc; the module's
    import where that cannot be read)."""
    try:
        with open('/proc/self/stat') as f:
            ticks = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the part before the first dot)."""
    tops = {name.split('.', 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _check_name(name: str) -> str:
    if not re.fullmatch(r'[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}', name):
        raise ValueError(f'not a name: {name!r}')
    return name


def load_spec(root: Path, workload: str) -> dict:
    """The cell's entry, configuration, workload file and metrics, found by
    name under `root`."""
    bench = load_json(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no cell {workload!r} in BENCHMARK.json')
    cell = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    cfg = dict(load_json(root / configs[cell['config']]['file']))
    cfg['name'] = cell['config']
    wl = load_json(root / 'portbench' / 'workloads'
                   / f'{_check_name(workload)}.json')
    e2e = [m for m in bench['end_to_end']
           if workload in m.get('workloads', cells)]
    moved = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (workload in m['workloads'] if 'workloads' in m
                     else m['moves'] in moved)]
    return {'cell': cell, 'cfg': cfg, 'wl': wl, 'end_to_end': e2e,
            'per_layer': per_layer, 'root': root}


def load_module(root: Path, folder: str, name: str):
    """portbench/<folder>/<name>.py, loaded by its path."""
    path = root / 'portbench' / folder / f'{_check_name(name)}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench.{folder}.{name.replace(".", "_").replace("-", "_")}',
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """portbench/metrics/<name>.py; for `<quantity>.<part>` without a file
    of its own, `<quantity>.py`: one quantity split by the cells whose
    end-to-end metrics differ."""
    if not (root / 'portbench' / 'metrics' / f'{_check_name(name)}.py'
            ).exists():
        name = name.split('.', 1)[0]
    return load_module(root, 'metrics', name)


def make_inputs(cfg: dict, seed: int, device, root: Path = ROOT) -> dict:
    """The seed's inputs and initial leaves, on the host and the device.
    A generator that gen.GENERATORS lacks is
    portbench/generators/<generator>.py (`graph`, `features`), a model
    kind that gen.MODEL_KINDS lacks portbench/models/<kind>.py
    (`leaves`)."""
    import torch

    from . import gen
    data, model = cfg['data'], cfg['model']
    generator = None
    if data['generator'] not in gen.GENERATORS:
        mod = load_module(root, 'generators', data['generator'])
        generator = (mod.graph, mod.features)
    inputs = gen.make_data(data, seed, generator)
    inputs['seed'] = int(seed)
    inputs['X'] = torch.as_tensor(inputs['features'], device=device)
    leaves = (gen.model_leaves(model) if model['kind'] in gen.MODEL_KINDS
              else load_module(root, 'models', model['kind']).leaves(model))
    inputs['params'] = gen.init_params(leaves, seed, device)
    inputs['trainable'] = {k for k in inputs['params'] if gen.trainable(k)}
    return inputs


def real_degrees(inputs: dict):
    """In-degree of every node on the graph with duplicates merged: the
    real entries each recipient aggregates."""
    import numpy as np

    from .gen import coalesce
    _, dst, _ = coalesce(inputs['edge_index'], inputs['num_nodes'])
    return np.bincount(dst, minlength=inputs['num_nodes'])


def sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def window(cell, seconds: float, device, trace_part=None) -> dict:
    """Calls of the cell until `seconds` have passed, at most two calls
    ahead of the device, ended by a synchronise.  With `trace_part`
    ({'skip_calls', 'calls'}), those calls are profiled: the device drains
    first and again at their end, inside the traced range.  The steps are
    numbered from the window's first; the traced ones start at
    `traced_from`."""
    import torch

    from . import trace as tr
    cuda = device.type == 'cuda'
    pending, steps, calls, traced, traced_from = [], 0, 0, None, None
    sync(device)
    t0 = time.perf_counter()
    while True:
        if trace_part and calls == int(trace_part['skip_calls']):
            sync(device)
            traced_from = steps
            prof = tr.profiler()
            prof.start()
            n_traced = 0
            with torch.profiler.record_function(tr.WINDOW):
                for _ in range(int(trace_part['calls'])):
                    n_traced += cell.call()
                sync(device)
            prof.stop()
            traced = (prof, n_traced)
            steps += n_traced
            calls += int(trace_part['calls'])
        steps += cell.call()
        calls += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.pop(0).synchronize()
        if time.perf_counter() - t0 >= seconds and (
                not trace_part or traced is not None):
            break
    sync(device)
    t1 = time.perf_counter()
    return {'seconds': t1 - t0, 'steps': steps, 'calls': calls,
            'traced': traced, 'traced_from': traced_from}


def device_info(device, chips: int) -> dict:
    import torch
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': chips,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device))}


def reference_steps(root: Path, cfg: dict, wl: dict, inputs: dict, ar):
    """The plain reference's first `checked_steps` training steps in the
    arithmetic `ar`, on the inputs' device: `train_steps(cfg, inputs,
    n_steps, ar, wl)` of portbench/references/<reference>.py where the
    workload names one, else reference.py's full-graph steps."""
    from . import reference
    feed = {**inputs, 'features': inputs['X']}
    steps = int(wl['checked_steps'])
    if 'reference' in wl:
        return load_module(root, 'references', wl['reference']).train_steps(
            cfg, feed, steps, ar, wl)
    return reference.train_steps(cfg, feed, steps, ar,
                                 slice_block=wl.get('reference_slice_block'))


def reference_numbers(spec: dict, inputs: dict, prog: dict) -> dict:
    """The reference's first steps in float64, and the compared
    numbers."""
    import torch

    from . import compare, reference
    ref = reference_steps(spec['root'], spec['cfg'], spec['wl'], inputs,
                          reference.Arith(torch.float64))
    return compare.numbers(prog, ref)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device=None, started: float = None) -> dict:
    """One run of a cell; returns the result line's object, whose last key,
    'compared', holds each compared number beside its limit."""
    import torch

    from . import compare, workmodel
    from . import trace as tr
    started = process_start() if started is None else started
    spec = load_spec(root, workload)
    cfg, wl, chips = spec['cfg'], spec['wl'], int(spec['cell']['chips'])
    device = torch.device('cuda', 0) if device is None else device
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == 'cuda':
        from fsw_gnn_tpu_torch.utils import enable_compilation_cache
        enable_compilation_cache(str(root / BUILD))
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    phases = {'start': time.time() - started}
    inputs = make_inputs(cfg, seed, device, root)
    sync(device)
    phases['inputs'] = time.time() - started
    driver = load_module(root, 'drivers', wl['driver'])
    cell = driver.Cell(cfg, wl, inputs, device)
    sync(device)
    setup_s = time.time() - started
    phases['program'] = setup_s
    print('setup phases (s from the process start): '
          + json.dumps(phases), file=sys.stderr)
    win = window(cell, seconds, device, wl['trace'] if trace else None)
    dev_info = device_info(device, chips)
    print(f"window: {win['steps']} steps in {win['seconds']!r} s",
          file=sys.stderr)
    # a cell that counts its steps' own work: summed after the window
    if hasattr(cell, 'tally'):
        win['work'] = cell.tally(0, win['steps'])
        if trace:
            first = win['traced_from']
            win['traced_work'] = cell.tally(first, first + win['traced'][1])
        print('window work: ' + json.dumps(win['work']), file=sys.stderr)
    prog = {'losses': [float(v) for v in cell.first['losses']],
            'out': cell.first['out'], 'grad': cell.first['grad'],
            'change': cell.first['change']}
    nonfinite = sum(1 for p in cell.leaves()
                    if not bool(torch.isfinite(p).all()))
    del cell
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    values = reference_numbers(spec, inputs, prog)
    values['nonfinite'] = float(nonfinite)
    lim = dict(wl['limits'])
    lim['nonfinite'] = 0.0
    correct = compare.judge(values, lim)

    deg = real_degrees(inputs)
    edges = int(deg.sum())
    ctx = {'edges': edges, 'window': win, 'setup_s': setup_s,
           'cfg': cfg, 'wl': wl,
           'step': workmodel.step_work(cfg['model'], cfg['train'], deg,
                                       inputs['num_nodes'], edges),
           'k1': workmodel.k1_work(cfg['model'], deg, inputs['num_nodes'])}
    metrics = {}
    if trace:
        prof, n_traced = win['traced']
        ctx['trace'] = tr.read(prof, tr.DEVICE_CATS if device.type == 'cuda'
                               else tr.CPU_CATS)
        ctx['traced_steps'] = n_traced
        dev_info['busy_s'] = ctx['trace']['busy_s']
        dev_info['window_s'] = ctx['trace']['window_s']
    for m in spec['per_layer'] if trace else spec['end_to_end']:
        value = metric_reader(root, m['name']).read(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    out = {'correct': correct, 'attempted': win['steps'],
           'failed': win['steps'] if nonfinite else 0,
           'metrics': metrics, 'device': dev_info}
    if trace:
        out['breakdown'] = {
            'device_ops': tr.top_ops(ctx['trace']['kernels']),
            'idle_gaps': [[n, s] for n, s in ctx['trace']['gaps']]}
    out['compared'] = {k: {'value': values[k], 'limit': lim[k]}
                       for k in lim}
    return out


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """The command.  `root` and `device` are for the tests: a device
    given skips the look for the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    print(f'portbench: python up at {time.time() - started:.3f} s',
          file=sys.stderr)
    import torch
    print(f'portbench: torch imported at {time.time() - started:.3f} s',
          file=sys.stderr)
    spec = load_spec(root, args.workload)
    chips = int(spec['cell']['chips'])
    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < chips):
        print(f'portbench: the cell needs {chips} CUDA device(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   root=root, device=device, started=started)
    found = forbidden_modules()
    if found:
        print(f'portbench: the process holds {", ".join(found)}',
              file=sys.stderr)
        return 3
    for k, v in out['compared'].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
