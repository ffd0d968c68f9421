"""Start P local processes, one per device, joined by a process group on a
file store (no TCP port), and collect what each returns.

Counterpart of `scripts/run_multiprocess_cpu.py`.  Two uses:

  * the command line, as torchrun would run it:
        python -m fsw_gnn_tpu_torch.parallel.launch --nproc 4 -- \\
            train --dataset cora --num-devices 4 --exchange all_to_all
    runs `fsw_gnn_tpu_torch.cli` in P processes (gloo on the CPU with
    --device cpu, else NCCL with rank r on cuda:r) and exits with the
    first non-zero exit code;
  * `launch(P, 'module:function', kwargs, device=None)`: each process
    starts the group (`runtime.ensure_distributed`; NCCL with rank r on
    cuda:r unless `device='cpu'` asks for gloo), calls the function with
    `kwargs` (picklable values) and returns its result; the call returns
    the P results in rank order.  The functions live in the package
    (parallel/workers.py), so a process imports nothing else.

Every process gets RANK, WORLD_SIZE, LOCAL_RANK and FSW_DIST_INIT_METHOD
(a `file://` store in a fresh temporary directory).  A process that fails
or outlives `timeout` ends the launch: the others are killed.
"""
from __future__ import annotations

import argparse
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..device import resolve_device
from .runtime import INIT_METHOD_ENV

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _env(rank: int, nproc: int, store: str) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nproc))
    env[INIT_METHOD_ENV] = 'file://' + store
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    return env


def _run(cmds, envs, timeout: float, logs=None):
    """Run the processes to their end; returns their (exit code, output).
    With `logs` (a path a process) each writes its stdout and stderr
    there, else to the caller's.  The first failure or the timeout kills
    the rest."""
    files = [open(p, 'w') for p in logs] if logs else [None] * len(cmds)
    try:
        procs = [subprocess.Popen(c, env=e, cwd=ROOT, stdout=f,
                                  stderr=subprocess.STDOUT if f else None)
                 for c, e, f in zip(cmds, envs, files)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() not in (None, 0) for p in procs)):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
    finally:
        for f in files:
            if f is not None:
                f.close()
    outs = []
    for k in range(len(cmds)):
        if logs:
            with open(logs[k]) as f:
                outs.append(f.read())
        else:
            outs.append('')
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def launch(nproc: int, target: str, kwargs=None, *, device=None,
           timeout: float = 300.0):
    """The results of `target` ('module:function') run in `nproc`
    processes of one group, in rank order.  `device` None or 'cuda': the
    cards, NCCL with rank r on cuda:r (a RuntimeError where there are
    fewer than `nproc`); 'cpu': gloo.  Each process computes on one
    intra-op thread: the ranks share the host's cores.  Raises a
    RuntimeError with every process's last output where one fails or the
    launch outlives `timeout`."""
    device = resolve_device(device).type
    if device == 'cuda' and nproc > torch.cuda.device_count():
        raise RuntimeError(
            f'{nproc} processes need {nproc} CUDA devices, one each (NCCL '
            f'cannot share a card between ranks); '
            f'{torch.cuda.device_count()} are present')
    tmp = tempfile.mkdtemp(prefix='fsw_launch_')
    try:
        task = os.path.join(tmp, 'task.pkl')
        with open(task, 'wb') as f:
            pickle.dump({'target': target, 'kwargs': kwargs or {},
                         'device': device}, f)
        store = os.path.join(tmp, 'store')
        cmds = [[sys.executable, '-m', 'fsw_gnn_tpu_torch.parallel.launch',
                 '--task', task, '--report',
                 os.path.join(tmp, f'report_{r}.pkl')]
                for r in range(nproc)]
        envs = [_env(r, nproc, store) for r in range(nproc)]
        runs = _run(cmds, envs, timeout,
                    [os.path.join(tmp, f'log_{r}.txt') for r in range(nproc)])
        if any(rc != 0 for rc, _ in runs):
            tails = '\n'.join(f'--- rank {r} exit {rc}\n{out[-3000:]}'
                              for r, (rc, out) in enumerate(runs))
            raise RuntimeError(f'{target} failed in {nproc} processes '
                               f'(timeout {timeout} s):\n{tails}')
        reports = []
        for r in range(nproc):
            with open(os.path.join(tmp, f'report_{r}.pkl'), 'rb') as f:
                reports.append(pickle.load(f))
        return reports
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _task(task_path: str, report_path: str) -> int:
    with open(task_path, 'rb') as f:
        task = pickle.load(f)
    import torch.distributed as dist
    from .runtime import ensure_distributed
    torch.set_num_threads(1)
    ensure_distributed(device=task['device'])
    module, name = task['target'].split(':')
    fn = getattr(importlib.import_module(module), name)
    try:
        result = fn(**task['kwargs'])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(report_path + '.tmp', 'wb') as f:
        pickle.dump(result, f)
    os.replace(report_path + '.tmp', report_path)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ['--task']:
        return _task(argv[1], argv[3])
    parser = argparse.ArgumentParser(
        prog='python -m fsw_gnn_tpu_torch.parallel.launch',
        description='run `fsw_gnn_tpu_torch.cli` in NPROC processes of one '
                    'process group (the arguments after -- are the cli\'s)')
    parser.add_argument('--nproc', type=int, required=True)
    parser.add_argument('--timeout', type=float, default=3600.0)
    parser.add_argument('cli_args', nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cli_args = args.cli_args[1:] if args.cli_args[:1] == ['--'] \
        else args.cli_args
    tmp = tempfile.mkdtemp(prefix='fsw_launch_')
    try:
        store = os.path.join(tmp, 'store')
        cmds = [[sys.executable, '-m', 'fsw_gnn_tpu_torch.cli'] + cli_args
                for _ in range(args.nproc)]
        envs = [_env(r, args.nproc, store) for r in range(args.nproc)]
        runs = _run(cmds, envs, args.timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return next((rc for rc, _ in runs if rc != 0), 0)


if __name__ == '__main__':
    sys.exit(main())
