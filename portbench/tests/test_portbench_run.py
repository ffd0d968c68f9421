"""A cell end to end on the CPU at a tiny size, the plain versions in the
kernels' place: the command's last line, and a cell added as new files."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from portbench import run

CPU = torch.device('cpu')


def last_line(root, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(argv, root=root, device=CPU)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize('workload', ['conv64-multi-train',
                                      'arxiv-full-train',
                                      'arxiv-minibatch-train'])
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_prints_one_result(tiny_root, workload, trace):
    out = last_line(tiny_root, ['--workload', workload, '--seed',
                                '3000000017', '--seconds', '0.2',
                                '--trace', str(trace)])
    assert list(out)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(out)[-1] == 'compared'
    assert out['correct'] is True, out['compared']
    assert out['attempted'] > 0 and out['failed'] == 0
    spec = run.load_spec(tiny_root, workload)
    names = {m['name'] for m in (spec['per_layer'] if trace
                                 else spec['end_to_end'])}
    assert set(out['metrics']) <= names
    if trace:
        assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
        assert out['device']['window_s'] > 0
    else:
        assert set(out['metrics']) == names
        assert all(m['value'] > 0 for m in out['metrics'].values())


def test_same_seed_same_inputs(tiny_root):
    spec = run.load_spec(tiny_root, 'arxiv-full-train')
    a = run.make_inputs(spec['cfg'], 2 ** 31 + 5, CPU)
    b = run.make_inputs(spec['cfg'], 2 ** 31 + 5, CPU)
    c = run.make_inputs(spec['cfg'], 2 ** 31 + 6, CPU)
    assert (a['edge_index'] == b['edge_index']).all()
    assert torch.equal(a['X'], b['X'])
    assert all(torch.equal(a['params'][k], b['params'][k])
               for k in a['params'])
    assert not torch.equal(a['X'], c['X'])


def add_to_rate(bench, cell):
    """The full-graph rate `train_edges_per_s` lists its cells: a new one
    is added by name."""
    rate = [m for m in bench['end_to_end']
            if m['name'] == 'train_edges_per_s'][0]
    rate['workloads'].append(cell)


@pytest.mark.parametrize('layout', ['table', 'csr'])
def test_a_cell_added_as_files(tiny_root, layout):
    """A new cell (another layout of an existing configuration) needs only
    a workload file and entries in BENCHMARK.json."""
    wl = json.loads((tiny_root / 'portbench' / 'workloads'
                     / 'conv64-multi-train.json').read_text())
    wl.update(layout=layout, steps_per_call=2)
    name = f'conv64-{layout}-train'
    (tiny_root / 'portbench' / 'workloads'
     / f'{name}.json').write_text(json.dumps(wl))
    bench = json.loads((tiny_root / 'BENCHMARK.json').read_text())
    bench['workloads'].append({
        'name': name, 'config': 'fswconv-64',
        'traffic': f'{layout}-step', 'chips': 1,
        'why': f'the step on the {layout} layout'})
    add_to_rate(bench, name)
    (tiny_root / 'BENCHMARK.json').write_text(json.dumps(bench))
    out = last_line(tiny_root, ['--workload', name,
                                '--seed', '9', '--seconds', '0.2'])
    assert out['correct'] is True
    assert set(out['metrics']) == {'train_edges_per_s', 'setup_s'}
