"""The register rank loop of the probes P4 and P6
(`fsw_gnn_tpu_torch/csrc/rank_regs.cuh`) on the CPU, where no kernel runs:

  * its algorithm emulated in numpy float32 (the column padded to W = 32
    with zero projections and weights, the tie rule settled by the pair's
    place, c summed j = 0 .. W-1 with one rounding a pair, as
    fmaf(w, [pred], c) rounds) against the plain `rank` body, bit for bit,
    on ties, zero weights and NaN projections at padded entries;
  * the two scripts' mirrors of the libraries' choice of loop by width,
    the kernel instance each body runs on, their shared memory, and the
    card's issue-slot floors at the probes' shapes;
  * the reader of ptxas' report on a report in nvcc's format.
"""
import numpy as np
import pytest
import torch

from fsw_gnn_tpu_torch import kernels
from fsw_gnn_tpu_torch.benchmarks import probe_emit_pipeline as P4
from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6


def rank_regs_emulated(P, wn, W=P6.REGS_W):
    """rank_regs::rank for every (row, slice) of P (R, B, S), wn (R, B)."""
    R, B, S = P.shape
    p = np.zeros((R, W, S), np.float32)
    p[:, :B] = P
    w = np.zeros((R, W, 1), np.float32)
    w[:, :B, 0] = wn
    i = np.arange(W).reshape(1, W, 1)
    c = np.zeros_like(p)
    for j in range(W):
        pj = p[:, j:j + 1]
        before = np.where(i > j, pj <= p, np.where(i == j, p == p, pj < p))
        c = c + np.where(before, w[:, j:j + 1], np.float32(0))
    return c[:, :B]


@pytest.mark.parametrize('B', [1, 7, 31, 32])
def test_register_loop_is_the_plain_rank_body_bit_for_bit(B):
    rng = np.random.default_rng(B)
    P = rng.standard_normal((6, B, 33)).astype(np.float32)
    P[:, 1::3] = P[:, 0:B - 1:3]                   # ties
    wn = rng.random((6, B)).astype(np.float32)
    wn[:, ::4] = 0.0                               # padded entries
    P = np.where(wn[:, :, None] == 0, np.float32(np.nan), P)
    want = P6.body_rank(torch.from_numpy(P), torch.from_numpy(wn),
                        torch.arange(B).view(1, -1, 1)).numpy()
    got = rank_regs_emulated(P, wn)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_width_dispatch():
    assert P4.stage_loop(32, 128) == 'registers_bulk'
    assert P4.stage_loop(1, 4) == 'registers_bulk'
    assert P4.stage_loop(32, 132) == 'registers_tensor_map'
    assert P4.stage_loop(13, 300) == 'registers_tensor_map'
    assert P4.stage_loop(33, 128) == 'shared'
    assert P4.stage_loop(100, 196) == 'shared'
    for name in P6.KERNEL_BODIES:
        on = name in ('fma_anchor', 'select_add', 'rank')
        assert P6.loop_of(name, 32) == ('registers' if on else 'shared')
        assert P6.loop_of(name, 33) == 'shared'
    assert P6.instance_tag('rank', 32) == 'probe_select_regsILi2EE'
    assert P6.instance_tag('rank', 33) == 'probe_select_kernelILi2ELi64EE'
    assert P6.instance_tag('pipe_rank', 32) == \
        'probe_select_kernelILi23ELi128EE'
    # the ring of three 128-byte-aligned stages of B x cols projections and
    # the weights, the ranks 32 x 128 (32 x 64 by a tensor map), or two
    # rows of 64 slices
    assert P4.stage_smem_bytes(32, 128) == 128 + 4 * (
        3 * (32 * 128 + 32) + 32 * 128) + 48
    assert P4.stage_smem_bytes(13, 40) == 128 + 4 * (
        3 * (13 * 40 + 24) + 32 * 128) + 48
    assert P4.stage_smem_bytes(32, 300) == 128 + 4 * (
        3 * (32 * 64 + 32) + 32 * 64) + 48
    assert P4.stage_smem_bytes(33, 128) == 8 * (64 * 33 + 36)


def test_issue_slot_floors():
    """Pairs x slots / (67e12 / 2) s: P6's at R 8192, B 32, S 128, REP 4
    (4.295e9 pairs), P4's at 8192 x 32 x 128 (1.074e9 pairs)."""
    assert P6.ISSUE_SLOTS == {'fma_anchor': 1, 'select_add': 2, 'rank': 2}
    assert P6.issue_floor('rank', 8192, 32, 128, 4) == pytest.approx(
        0.25642, rel=1e-4)
    assert P6.issue_floor('select_add', 8192, 32, 128, 4) == pytest.approx(
        0.25642, rel=1e-4)
    assert P6.issue_floor('fma_anchor', 8192, 32, 128, 4) == pytest.approx(
        0.12821, rel=1e-4)
    assert P4.pair_floor_ms(8192, 32, 128) == pytest.approx(0.064104,
                                                            rel=1e-4)


def test_cpu_calls_count_no_loop():
    """On CPU tensors the wrappers run the plain versions: no launch, no
    loop counted."""
    P = torch.zeros((2, 4, 8))
    wn = torch.full((2, 4), 0.25)
    loops, launches = dict(P6.probe_select.loops), P6.probe_select.launches
    P6.probe_select('rank', P, wn, 1)
    assert (P6.probe_select.loops, P6.probe_select.launches) == (loops,
                                                                 launches)
    args = P4.inputs('cpu', R=3, B=4, S=8)
    loops = dict(P4.fsw_rank_aggregate_staged.loops)
    P4.fsw_rank_aggregate_staged(*args)
    assert P4.fsw_rank_aggregate_staged.loops == loops


REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117probe_select_regsILi2EEEvPKfS2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117probe_select_regsILi2EEEvPKfS2_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers, 128 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119probe_select_kernelILi2ELi64EEEvPKfS2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119probe_select_kernelILi2ELi64EEEvPKfS2_Pfiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_ptxas_report_reader(monkeypatch):
    monkeypatch.setattr(kernels, 'build_log', lambda name: REPORT)
    got = P6.ptxas_of('probe_select', ['probe_select_regsILi2EE',
                                       'probe_select_kernelILi2ELi64EE',
                                       'probe_select_regsILi0EE'])
    assert got == {
        'probe_select_regsILi2EE': {'registers': 112, 'stack': 0,
                                    'spill_stores': 0, 'spill_loads': 0},
        'probe_select_kernelILi2ELi64EE': {'registers': 40, 'stack': 8,
                                           'spill_stores': 4,
                                           'spill_loads': 4}}
