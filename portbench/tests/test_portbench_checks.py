"""The comparison that decides `correct`: the reference agrees with the
program at a small size, and the control and each planted fault fail it."""
from __future__ import annotations

import pytest
import torch

from portbench import compare, reference, run
from portbench.faults import FAULTS, planted

CPU = torch.device('cpu')
CELLS = ['conv64-multi-train', 'arxiv-full-train', 'arxiv-minibatch-train']


def first_steps(root, workload, seed, fault=None):
    spec = run.load_spec(root, workload)
    inputs = run.make_inputs(spec['cfg'], seed, CPU, root)
    driver = run.load_module(root, 'drivers', spec['wl']['driver'])
    if fault is None:
        cell = driver.Cell(spec['cfg'], spec['wl'], inputs, CPU)
    else:
        with planted(fault, spec['cfg']):
            cell = driver.Cell(spec['cfg'], spec['wl'], inputs, CPU)
    prog = {'losses': [float(v) for v in cell.first['losses']],
            'out': cell.first['out'], 'grad': cell.first['grad'],
            'change': cell.first['change']}
    return spec, inputs, prog


def reference_of(spec, inputs, arith):
    return run.reference_steps(spec['root'], spec['cfg'], spec['wl'],
                               inputs, arith)


@pytest.mark.parametrize('workload', CELLS)
def test_reference_agrees_with_the_program(tiny_root, workload):
    spec, inputs, prog = first_steps(tiny_root, workload, 11)
    ref = reference_of(spec, inputs, reference.Arith())
    values = compare.numbers(prog, ref)
    assert compare.judge(values, spec['wl']['limits']), values


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('fault', FAULTS)
def test_each_fault_fails(tiny_root, workload, fault):
    spec, inputs, prog = first_steps(tiny_root, workload, 12, fault)
    ref = reference_of(spec, inputs, reference.Arith())
    values = compare.numbers(prog, ref)
    assert not compare.judge(values, spec['wl']['limits']), values


@pytest.mark.parametrize('workload', CELLS)
def test_the_control_fails(tiny_root, workload):
    """The reference in TF32 (float32, products' operands rounded to TF32)
    put in the program's place."""
    spec = run.load_spec(tiny_root, workload)
    inputs = run.make_inputs(spec['cfg'], 13, CPU, tiny_root)
    ref = reference_of(spec, inputs, reference.Arith())
    control = reference_of(spec, inputs,
                           reference.Arith(torch.float32, tf32=True))
    values = compare.numbers(control, ref)
    assert not compare.judge(values, spec['wl']['limits']), values


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -12])
    got = reference.tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


def test_worst_leaf_and_row():
    want = {'a': torch.ones(4), 'b': torch.full((4,), 3.0)}
    got = {'a': torch.ones(4) * 1.5, 'b': torch.full((4,), 3.0)}
    # a's norm 2 -> 3 against the larger of 2 and the median 4
    assert compare.worst_leaf(got, want) == pytest.approx(0.25)
    rows = torch.ones(5, 2)
    moved = rows.clone()
    moved[2] = 2.0
    assert compare.worst_row(moved, rows) == pytest.approx(1.0)
    assert compare.worst_row(rows[:2], rows) == float('inf')
