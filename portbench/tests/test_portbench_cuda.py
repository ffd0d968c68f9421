"""On the card (marked `cuda`; each test skips where there is none): a
tiny cell through the captured CUDA graph and the traced window, and the
control and a fault at a small size against the card's kernels.

    python -m pytest portbench/tests -o addopts= -m cuda -q
"""
from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from portbench import compare, reference, run
from portbench.faults import planted

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    return torch.device('cuda', 0)


@pytest.mark.parametrize('workload', ['conv64-multi-train',
                                      'arxiv-full-train'])
def test_tiny_cell_on_the_card(tiny_root, card, workload):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(['--workload', workload, '--seed', '3000000021',
                       '--seconds', '1', '--trace', '1'], root=tiny_root)
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out['correct'] is True, out['compared']
    assert out['device']['platform'] == 'gpu'
    assert 0 < out['device']['busy_s'] <= out['device']['window_s']
    assert out['breakdown']['device_ops']


@pytest.mark.parametrize('workload', ['conv64-multi-train',
                                      'arxiv-full-train'])
def test_control_and_fault_on_the_card(tiny_root, card, workload):
    spec = run.load_spec(tiny_root, workload)
    inputs = run.make_inputs(spec['cfg'], 23, card)
    feed = {**inputs, 'features': inputs['X']}
    steps = int(spec['wl']['checked_steps'])
    ref = reference.train_steps(spec['cfg'], feed, steps, reference.Arith())
    control = reference.train_steps(
        spec['cfg'], feed, steps, reference.Arith(torch.float32, tf32=True))
    limits = spec['wl']['limits']
    assert not compare.judge(compare.numbers(control, ref), limits)
    driver = run.load_module(tiny_root, 'drivers', spec['wl']['driver'])
    with planted('altered_answer', spec['cfg']):
        cell = driver.Cell(spec['cfg'], spec['wl'], inputs, card)
    prog = {'losses': [float(v) for v in cell.first['losses']],
            'out': cell.first['out'], 'grad': cell.first['grad'],
            'change': cell.first['change']}
    assert not compare.judge(compare.numbers(prog, ref), limits)
