"""The readers of the program's spans and counters on hand-made spans and
counters, and on a program without the recorder (nothing to read)."""
from __future__ import annotations

import types

import pytest

from portbench import program, run
from portbench.tests.conftest import REPO


def metric(name):
    return run.load_module(REPO, 'metrics', name)


def sp(name, t0_ms, t1_ms, parent=None, step=None, **attrs):
    from fsw_gnn_tpu_torch.utils.profiling import Span
    return Span(name, parent, step, int(t0_ms * 1e6), int(t1_ms * 1e6),
                attrs)


def test_setup_first_op_s_is_self_time():
    spans = [sp('fsw.setup.first_op', 1000, 3500),
             sp('fsw.setup.kernel_load', 1200, 1700,
                parent='fsw.setup.first_op', library='fsw_rank_fwdp'),
             # a load outside the first op (the backward's library)
             sp('fsw.setup.kernel_load', 4000, 4900, library='fsw_rank_bwdp'),
             sp('fsw.train.step', 5000, 6000, step=3)]
    assert metric('setup_first_op_s').value(spans) == pytest.approx(2.0)
    assert metric('setup_first_op_s').value(spans[1:]) is None
    assert metric('setup_first_op_s').value([]) is None


def test_host_enqueue_ms_takes_the_waits_out():
    spans = [sp('fsw.setup.first_op', 0, 10),
             sp('fsw.train.step', 100, 900, step=4),
             sp('fsw.train.forward', 101, 103, 'fsw.train.step', 4),
             sp('fsw.wait.sync', 110, 150, 'fsw.train.backward', 4),
             sp('fsw.wait.inner', 120, 130, 'fsw.wait.sync', 4),
             sp('fsw.train.readback', 200, 898, 'fsw.train.step', 4),
             sp('fsw.train.step', 1000, 1806, step=5),
             sp('fsw.train.readback', 1004, 1800, 'fsw.train.step', 5)]
    # step 4: 800 - 40 - 698 = 62 ms; step 5: 806 - 796 = 10 ms
    assert metric('host_enqueue_ms').value(spans) == pytest.approx(36.0)
    assert metric('host_enqueue_ms').value(spans[:1]) is None
    assert metric('host_enqueue_ms').value([]) is None


def test_gather_counters():
    pad = metric('gather_pad_share_pct')
    hot = metric('gather_hot_row_entries')
    c = {'gather.entries': 1702080, 'gather.pad_entries': 536433,
         'gather.hot_row_entries': 289944, 'launch.fsw_rank_fwdp': 9}
    assert pad.value(c) == pytest.approx(31.516321, abs=1e-6)
    assert hot.value(c) == 289944
    # zero entries, or no padding count: nothing to read
    assert pad.value({'gather.entries': 0, 'gather.pad_entries': 0}) is None
    assert pad.value({'gather.entries': 5}) is None
    assert pad.value({}) is None
    # no differentiated gather: no hot row
    assert hot.value({'gather.entries': 5, 'gather.pad_entries': 1}) is None


def test_readers_read_the_program_that_runs():
    from fsw_gnn_tpu_torch.utils import profiling
    assert program.recorder() is profiling
    profiling.count('gather.entries', 10)
    profiling.count('gather.pad_entries', 3)
    try:
        got = metric('gather_pad_share_pct').read({})
        assert got is not None and 0 < got < 100
    finally:
        profiling.reset()


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    """The parent's program: `profiling` with no spans() or counters().
    Every new reader returns None and raises nothing."""
    import fsw_gnn_tpu_torch.utils as utils
    bare = types.ModuleType('fsw_gnn_tpu_torch.utils.profiling')
    bare.named_scope = lambda name: None
    monkeypatch.setattr(utils, 'profiling', bare)
    monkeypatch.setitem(__import__('sys').modules,
                        'fsw_gnn_tpu_torch.utils.profiling', bare)
    assert program.recorder() is None
    for name in ('setup_first_op_s', 'host_enqueue_ms',
                 'gather_pad_share_pct', 'gather_hot_row_entries'):
        assert metric(name).read({}) is None
