#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card's name, and its name and power limit from nvidia-smi;
  2. build every CUDA kernel of the package from its sources (nvcc,
     sm_90a, all sources at once), with the seconds it took and ptxas'
     resource report;
  3. K1f (`fsw_rank_fwdp`) against its plain PyTorch version on the card,
     at every degree-class shape of the served envelope, and both timed;
  4. serving: the bench FSWConv (in = out = 64 channels, 127 slices,
     3-layer MLP head, float32, random weights from seed 0) behind a
     GraphServer with a degree-class envelope sized from an 8192-node,
     average-degree-16 simple random graph, serving requests of 4096 to
     8192 nodes through `predict` and `predict_many`; every output is
     checked finite, one full-size request against the same model on the
     CPU, and K1f's launches against the path's classes;
  5. K1b (`fsw_rank_bwdp`) against its plain PyTorch version on the card,
     every output (dZ, df, dV, and dwn, dpad with with_dw), at every
     degree-class table of the bench graph, on the arguments the rank
     route passes in one forward (captured, not rebuilt), in four variants
     (the training path's: uniform_w on, with_dw off; uniform_w off; ties
     with an f = 0 slice; with_dw on with random weights);
  6. the bench training step (bench.py): the same FSWConv on the 8192-node
     graph in the `multi` layout, SGD(1e-3), 61 steps; the first step's
     gradients against the same step on the CPU, the loss finite and
     falling, K1f and K1b each launched (classes x steps) times; then the
     step, its forward, backward and optimizer, and K1f and K1b at every
     class, timed, and the step's device-busy time read from a
     torch.profiler trace of 10 steps.  The loss is sum(out**2) / N, bench.py's sum(out**2)
     per node: on the plain sum, SGD(1e-3) diverges from this model's
     initial weights within three steps (in the JAX package too), and the
     steps after that would be timed on NaNs.  The work of a step is the
     same;
  7. the Trainer: `load('cora')` (its synthetic stand-in when data/cora.npz
     is absent: 2708 nodes, 1433 features, 7 classes) with
     TrainConfig(hidden_dims=(64, 64), epochs=30, eval_every=10).  Before
     `fit`, the rank route's arguments of one forward are captured and
     both kernels held against their plain versions on every (layer,
     degree class) table at its full size (layer 0: D = 1433, S = 2865,
     2712 and 8 rows): K1f on the arguments as passed, K1b on the dyadic
     grid with with_dw off (the path's) and on.  Then `fit`: the initial
     loss against a CPU forward of the same model, the loss falling, the
     final train accuracy above 0.9, K1f and K1b launched
     (layers x classes x passes) times; then one epoch's parts timed;
  8. one JSON line listing the kernels with their launches, errors, times
     and bounds (the launches are those of the three main-path runs, 4, 6
     and 7, together);
  9. the last line: {"ok": true, "device": {...}}.

Tolerances:
  * K1f against its plain version, both on the card in float32:
    |kernel - plain| <= 2e-5 * max|plain| + 1e-5 * |plain|.  The weighted
    ranks agree to the bit wherever the projections do; the projections
    differ by summation order (sequential FMAs against cuBLAS) and the
    trig by sincospi against the plain version's libm-style sin/cos.
  * K1b against its plain version, each output on its own scale:
    |kernel - plain| <= 1e-4 * max|plain| + 1e-4 * |plain|.  The backward
    jumps where two projections swap order, so Z and V are first rounded
    to a dyadic grid on which every projection is exact in float32 in any
    summation order (`dyadic`): both sides then rank alike, and what
    differs is the trig and the summation order of dZ (over S), dV (over
    the R * B entries) and df (over R).
  * served output against the CPU: |gpu - cpu| <= 1e-4 * max|cpu|.  The
    CPU runs the plain versions (MKL products, another summation order);
    three Linear layers follow the embedding.
  * the bench step's first gradients against the CPU, per parameter:
    |gpu - cpu| <= 1e-4 * max|cpu| + 1e-4 * |cpu|, with the features and
    the slice vectors on the dyadic grid (so both rank alike).
  * the Trainer's first loss against the CPU: relative 1e-4.  A forward
    is continuous in every input, so float32 rounding (about 1e-6 of each
    layer's scale) is all that differs, through three layers.

Bounds: the least time the card could take for a kernel's work, the
larger of (bytes that must move) / 3.35 TB/s and (float32 operations) /
67 TFLOP/s, the H100 SXM's published peaks at 700 W.  Bytes: every input
tensor read once and every output written once.  Operations: what this
run's data needs.  Zero-weight (padding) entries and rows contribute
exactly 0, so a row with d real entries needs
  K1f: S * d * (2 D + 3 d + 20) operations: 2 D for the projection, 3 d
       for the rank loop (compare, select, add), about 20 for the trig of
       one entry-slice;
  K1b: S * d * (6 D + 3 d + 45) operations: 2 D each for the recomputed
       projection, dZ and dV, 3 d for the rank loop, about 45 for the two
       sincospi, the dp, phi_f and df terms of one entry-slice (with
       with_dw, which the training path does not use, the transposed loop
       adds 3 d more).
The bound of the padded shapes (every table entry counted) is printed
beside K1f's.

Device times are medians over 5 windows of back-to-back calls between
two CUDA events, a sleep kernel queued first so the card never waits for
the host (`device_ms`); host times are the mean over back-to-back calls
on the host clock, from a synchronised start to the last call's return.  Latency is reported as the
median and the 90th percentile of the `predict` requests (100 samples).
"""
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, AVG_DEG, D_IN, D_OUT = 8192, 16, 64, 64
MAX_EDGES = N_NODES * AVG_DEG
MIN_NODES = 4096
N_PREDICT, N_MANY, WINDOW = 100, 32, 8
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-5, 2e-5
BWD_RTOL, BWD_ATOL_REL = 1e-4, 1e-4
SERVE_ATOL_REL = 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
N_STEPS, STEP_LR = 60, 1e-3
TRAIN_EPOCHS, TRAIN_EVAL_EVERY, TRAIN_ACC_MIN = 30, 10, 0.9
LOSS0_RTOL = 1e-4
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
TRIG_OPS, BWD_TRIG_OPS = 20, 45
BWD_NAMES = ('dZ', 'dwn', 'dpad', 'df', 'dV')


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def simple_graph(seed, n, deg=AVG_DEG):
    """A simple random directed graph (no self-loops, no duplicate edges)
    with about n * deg edges, as bench.py builds it."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n * deg)
    dst = rng.integers(0, n, n * deg)
    keep = src != dst
    pairs = np.unique(src[keep].astype(np.int64) * n + dst[keep])
    return np.stack([pairs // n, pairs % n]), rng


def dyadic(Z, V):
    """Z (..., D) and V (D, S) rounded to dyadic grids 2^-p and 2^-q, the
    finest for which every partial sum of Z V is an integer multiple of
    2^-(p+q) below 2^24 of them: every projection is then exact in float32
    in any summation order, so a kernel and its plain version rank the
    entries identically (the backward jumps where two projections swap
    order)."""
    import torch

    def bound(z, v):
        return float((z.abs().reshape(-1, z.shape[-1]).double()
                      @ v.abs().double()).max())
    bits = int(np.floor(np.log2(2.0 ** 23 / bound(Z, V))))
    p = bits // 2
    q = bits - p
    Zq = torch.round(Z * 2.0 ** p) / 2.0 ** p
    Vq = torch.round(V * 2.0 ** q) / 2.0 ** q
    if not bound(Zq, Vq) * 2.0 ** (p + q) < 2.0 ** 24:
        raise ValueError('dyadic rounding left a projection inexact')
    return Zq, Vq


def device_ms(torch, fn, n, reps=5):
    """(device ms per call, host ms per call) of `fn`.  The host time is
    the median of `n` back-to-back calls on the host clock, from a
    synchronised start: the Python cost of a call, and any wait inside it.
    The device time is the median over `reps` of the mean over `n`
    back-to-back calls between two CUDA events; a sleep kernel queued
    first keeps the card busy while the host enqueues the calls, so the
    host's cost does not leave the card idle inside the timed region."""
    fn()
    torch.cuda.synchronize()
    hosts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        hosts.append(time.perf_counter() - t0)
    host = float(np.median(hosts))
    torch.cuda.synchronize()
    cycles = int(2e9 * max(2e-3, 3 * sum(hosts)))  # >= 2 GHz SM clock
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times)), 1e3 * host


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def rank_bound_ms(wn, D, S):
    """(bound ms, 'operations' or 'bytes', padded-shape bound ms) of one
    K1f call on (R, B) normalized weights wn, zero at the padding (see the
    module docstring)."""
    R, B = wn.shape
    deg = (wn > 0).sum(dim=1).double()
    ops = S * float((deg * (2 * D + 3 * deg + TRIG_OPS)).sum())
    ops_padded = R * B * S * (2 * D + 3 * B + TRIG_OPS)
    nbytes = 4 * (R * B * D + R * B + R + S + D * S + R * S)
    ms, by = _bound(ops, nbytes)
    return ms, by, 1e3 * max(ops_padded / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def rank_bwd_bound_ms(wn, D, S):
    """(bound ms, 'operations' or 'bytes') of one K1b call without with_dw
    on (R, B) normalized weights wn: reads Z, wn, pad, freqs, V and the
    output cotangent, writes dZ, df and dV (see the module docstring)."""
    R, B = wn.shape
    deg = (wn > 0).sum(dim=1).double()
    ops = S * float((deg * (6 * D + 3 * deg + BWD_TRIG_OPS)).sum())
    nbytes = 4 * (2 * R * B * D + R * B + R + 2 * S + 2 * D * S + R * S)
    return _bound(ops, nbytes)


def capture_rank_calls(run):
    """Run `run()` with the rank route's entry point wrapped, and return
    the arguments of every call it made, in order: a list of ((Z, wn,
    pad_norm, freqs, V), uniform_w, with_dw), detached copies.  The checks
    and timings replay exactly what the path passes.  Launches made here
    count as usual: callers reset the counts after."""
    from fsw_gnn_tpu_torch import embedding
    real = embedding.fsw_rank_aggregate_proj
    calls = []

    def spy(*args, uniform_w=False, with_dw=True):
        calls.append((tuple(t.detach().clone() for t in args),
                      bool(uniform_w), bool(with_dw)))
        return real(*args, uniform_w=uniform_w, with_dw=with_dw)
    embedding.fsw_rank_aggregate_proj = spy
    try:
        run()
    finally:
        embedding.fsw_rank_aggregate_proj = real
    return calls


def tables_of(graph):
    return graph.tables if hasattr(graph, 'tables') else [graph]


def check_fwd(torch, label, args, unif):
    """K1f against its plain version on one input; returns the largest
    absolute error and the largest error relative to the output's
    scale."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_plain)
    got = fsw_rank_aggregate_proj(*args, uniform_w=unif)
    torch.cuda.synchronize()
    want = fsw_rank_aggregate_proj_plain(*args, uniform_w=unif)
    err = (got - want).abs()
    scale = want.abs().max().item()
    ok = bool(torch.all(err <= KERNEL_ATOL_REL * scale
                        + KERNEL_RTOL * want.abs()))
    if not (ok and torch.isfinite(got).all()):
        fail(f'K1f disagrees ({label}): max abs err {err.max().item():.3e}, '
             f'scale {scale:.3e}')
    return err.max().item(), err.max().item() / max(scale, 1e-30)


def check_bwd(torch, label, args, G, unif, with_dw):
    """K1b against its plain version on one input; returns the largest
    absolute error and the largest error relative to its output's
    scale."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj_bwd, fsw_rank_aggregate_proj_bwd_plain)
    got = fsw_rank_aggregate_proj_bwd(*args, G, uniform_w=unif,
                                      with_dw=with_dw)
    torch.cuda.synchronize()
    want = fsw_rank_aggregate_proj_bwd_plain(*args, G, uniform_w=unif,
                                             with_dw=with_dw)
    max_err = worst_rel = 0.0
    for name, g, w in zip(BWD_NAMES, got, want):
        if w is None:
            if g is not None:
                fail(f'K1b returned {name} without with_dw ({label})')
            continue
        err = (g - w).abs()
        scale = w.abs().max().item()
        ok = bool(torch.all(err <= BWD_ATOL_REL * scale
                            + BWD_RTOL * w.abs()))
        if not (ok and torch.isfinite(g).all()):
            fail(f'K1b {name} disagrees ({label}): max abs err '
                 f'{err.max().item():.3e}, scale {scale:.3e}')
        max_err = max(max_err, err.max().item())
        worst_rel = max(worst_rel, err.max().item() / max(scale, 1e-30))
    dead = args[1] == 0
    if not torch.all(got[0][dead] == 0):
        fail(f'K1b gave padded entries a non-zero dZ ({label})')
    return max_err, worst_rel


def time_rank_kernels(torch, calls, per_layer, gen, n=10, plain_reps=0):
    """Device ms of K1f and K1b on the captured rank calls of one pass
    (`per_layer` calls a layer), summed, with the plain versions when
    plain_reps > 0, and the bound ms of K1b.  Launches made here are not
    counted as the path's."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_bwd,
        fsw_rank_aggregate_proj_bwd_plain, fsw_rank_aggregate_proj_plain)
    tot = dict(fwd=0.0, bwd=0.0, fwd_plain=0.0, bwd_plain=0.0, bwd_bound=0.0)
    bound_by = set()
    rows = []
    with torch.no_grad():
        for i, (args, unif, dw) in enumerate(calls):
            Z, wn, _, _, V = args
            R, B, D = Z.shape
            S = V.shape[1]
            G = torch.randn((R, S), generator=gen, device=Z.device)
            f_ms, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj(
                *args, uniform_w=unif, with_dw=dw), n)
            b_ms, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj_bwd(
                *args, G, uniform_w=unif, with_dw=dw), n)
            bm, by = rank_bwd_bound_ms(wn, D, S)
            bound_by.add(by)
            row = dict(layer=i // per_layer, B=B, R=R, D=D, S=S, k1f_ms=f_ms,
                       k1b_ms=b_ms, k1b_bound_ms=bm, k1b_bound_by=by)
            if plain_reps:
                row['k1f_plain_ms'], _ = device_ms(
                    torch, lambda: fsw_rank_aggregate_proj_plain(
                        *args, uniform_w=unif), 3, plain_reps)
                row['k1b_plain_ms'], _ = device_ms(
                    torch, lambda: fsw_rank_aggregate_proj_bwd_plain(
                        *args, G, uniform_w=unif, with_dw=dw), 3,
                    plain_reps)
                tot['fwd_plain'] += row['k1f_plain_ms']
                tot['bwd_plain'] += row['k1b_plain_ms']
            tot['fwd'] += f_ms
            tot['bwd'] += b_ms
            tot['bwd_bound'] += bm
            rows.append(row)
    tot['bwd_bound_by'] = ('operations' if 'operations' in bound_by
                           else 'bytes')
    return tot, rows


def traced_busy_ms(torch, fn, n):
    """Device-busy ms per call of `fn` from a torch.profiler trace of n
    calls: the summed durations of the kernels and copies it records on
    the card (one stream, so they do not overlap).  None where the trace
    holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / n if busy_us else None


def step_parts_ms(torch, forward, loss_of, opt):
    """Device and host ms of one training step and of its forward,
    backward and optimizer parts, each timed on its own (the backward
    repeated on one retained graph)."""
    def step():
        opt.zero_grad(set_to_none=True)
        loss_of(forward()).backward()
        opt.step()
    parts = {}
    parts['step_device_ms'], parts['step_host_ms'] = device_ms(
        torch, step, 3)
    parts['forward_device_ms'], parts['forward_host_ms'] = device_ms(
        torch, forward, 3)
    loss = loss_of(forward())
    parts['backward_device_ms'], parts['backward_host_ms'] = device_ms(
        torch, lambda: loss.backward(retain_graph=True), 3)
    parts['optimizer_device_ms'], parts['optimizer_host_ms'] = device_ms(
        torch, opt.step, 5)
    del loss
    opt.zero_grad(set_to_none=True)
    return parts


def serve_and_check_k1f(torch, T, dev, model, counts, errs):
    """Phases 3 and 4.  Returns K1f's entry for the kernels line."""
    from fsw_gnn_tpu_torch.embedding import table_weights
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_plain)
    cfg = model.embed_cfg
    ref_ei, _ = simple_graph(0, N_NODES)
    classes, class_rows = T.multi_envelope(
        T.from_edge_index(ref_ei, N_NODES), N_NODES)
    print(f'envelope: classes {classes} rows {class_rows}; slices '
          f'{cfg.nSlices}, feature width {cfg.proj_dim}')
    server = T.GraphServer(model, N_NODES, MAX_EDGES, classes=classes,
                           class_rows=class_rows, assume_uniform_w=True,
                           device=dev)

    def request(seed, n):
        ei, rng = simple_graph(seed, n)
        return ei, rng.standard_normal((n, D_IN)).astype(np.float32)

    # ---- 3. K1f at every served class, on what one request passes it -------
    server.warmup(D_IN)
    calls = capture_rank_calls(lambda: server.predict(*request(1, N_NODES)))
    if len(calls) != len(classes):
        fail(f'one request made {len(calls)} rank calls for '
             f'{len(classes)} classes')
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err, worst_rel = 0.0, 0.0
    k_ms = p_ms = b_ms = bp_ms = 0.0
    bound_by = set()
    with torch.inference_mode():
        for (Z, wn, pad, freqs, V), unif, _ in calls:
            R, B, D = Z.shape
            f_zero = freqs.clone()
            f_zero[0] = 0.0
            # ties: every odd entry repeats the even one before it
            Zt = Z.clone()
            Zt[:, 1::2] = Zt[:, 0::2]
            w = torch.rand((R, B), generator=gen, device=dev) * (wn > 0)
            _, wn_r, pad_r = table_weights(w, cfg)
            variants = [
                ('served', Z, wn, pad, freqs, unif),
                ('served, uniform_w off', Z, wn, pad, freqs, False),
                ('ties, f=0', Zt, wn, pad, f_zero, unif),
                ('ties, f=0, random weights', Zt, wn_r.contiguous(),
                 pad_r.contiguous(), f_zero, False)]
            for label, z, a, p, f, u in variants:
                e, r = check_fwd(torch, f'B={B} R={R}, {label}',
                                 (z, a, p, f, V), u)
                max_err, worst_rel = max(max_err, e), max(worst_rel, r)
            km, kh = device_ms(torch, lambda: fsw_rank_aggregate_proj(
                Z, wn, pad, freqs, V, uniform_w=unif), 20)
            pm, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj_plain(
                Z, wn, pad, freqs, V, uniform_w=unif), 3)
            bm, by, bpm = rank_bound_ms(wn, D, V.shape[1])
            bound_by.add(by)
            k_ms, p_ms = k_ms + km, p_ms + pm
            b_ms, bp_ms = b_ms + bm, bp_ms + bpm
            print(f'  class B={B:3d} R={R:5d} ({int((wn > 0).sum())}'
                  f' real entries): kernel {km:.4f} ms (host {kh:.4f} ms a '
                  f'call), plain {pm:.4f} ms, bound {bm:.5f} ms ({by}), '
                  f'padded-shape bound {bpm:.5f} ms')
    errs['fsw_rank_fwdp'] = max(errs['fsw_rank_fwdp'], max_err)
    print(f'K1f check: ok, max abs err {max_err:.3e} (max '
          f'{worst_rel:.3e} of the output scale); per request: kernel '
          f'{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms, '
          f'padded-shape bound {bp_ms:.5f} ms', flush=True)

    # ---- 4. serving ----------------------------------------------------------
    sizes = np.random.default_rng(2).integers(MIN_NODES, N_NODES + 1,
                                              N_PREDICT + N_MANY)
    sizes[0] = N_NODES               # the request checked against the CPU
    reqs = [request(10 + i, int(n)) for i, n in enumerate(sizes)]
    seq, many = reqs[:N_PREDICT], reqs[N_PREDICT:]
    fsw_rank_aggregate_proj.launches = 0
    latencies, outs = [], []
    for ei, X in seq:
        t0 = time.perf_counter()
        outs.append(server.predict(ei, X))
        latencies.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs += server.predict_many(many, window=WINDOW)
    t_many = time.perf_counter() - t0
    launches = fsw_rank_aggregate_proj.launches
    n_req = len(reqs)
    if launches != len(classes) * n_req:
        fail(f'K1f launched {launches} times for {n_req} requests '
             f'of {len(classes)} classes')
    counts['fsw_rank_fwdp'] += launches
    for (ei, X), out in zip(reqs, outs):
        if out.shape != (X.shape[0], D_OUT) or not np.isfinite(out).all():
            fail(f'bad output for a {X.shape[0]}-node request')
    if server.fallbacks or server.uniform_w_fallbacks:
        fail('a request left the envelope')

    cpu_server = T.GraphServer(copy.deepcopy(model), N_NODES, MAX_EDGES,
                               classes=classes, class_rows=class_rows,
                               assume_uniform_w=True, device='cpu')
    want = cpu_server.predict(*seq[0])
    serve_err = float(np.abs(outs[0] - want).max())
    serve_scale = float(np.abs(want).max())
    if not serve_err <= SERVE_ATOL_REL * serve_scale:
        fail(f'served output differs from the CPU: max abs err '
             f'{serve_err:.3e}, scale {serve_scale:.3e}')
    edges_many = sum(ei.shape[1] for ei, _ in many)

    # where one full-size request's time goes: host build, copy, forward
    with torch.inference_mode():
        t0 = time.perf_counter()
        for _ in range(5):
            g = T.from_edge_index(seq[0][0], N_NODES, pad_to=MAX_EDGES)
            mt = T.to_multi_table(g, classes=classes, class_rows=class_rows)
            Xp = np.zeros((N_NODES, D_IN), np.float32)
            Xp[:] = seq[0][1]
            host = server._pack(mt, Xp)
        host_ms = 1e3 * (time.perf_counter() - t0) / 5
        h2d_ms, _ = device_ms(
            torch, lambda: host.to(dev, non_blocking=True), 10)
        Xd, mtd = server._unpack(host.to(dev))
        fwd_ms, fwd_host_ms = device_ms(torch, lambda: model(Xd, mtd), 10)
    p50_ms = 1e3 * float(np.median(latencies))
    main = {
        'requests': n_req, 'launches': launches,
        'predict_samples': len(latencies),
        'p50_latency_ms': p50_ms,
        'p90_latency_ms': 1e3 * float(np.percentile(latencies, 90)),
        'predict_edges_per_s': (sum(ei.shape[1] for ei, _ in seq)
                                / sum(latencies)),
        'predict_many_requests_per_s': len(many) / t_many,
        'predict_many_edges_per_s': edges_many / t_many,
        'served_vs_cpu_max_abs_err': serve_err,
        'served_output_scale': serve_scale,
        'device_idle_share': 1.0 - fwd_ms / p50_ms,
        'breakdown_ms': {'host_build_and_pack': host_ms, 'h2d_copy': h2d_ms,
                         'forward_host_enqueue': fwd_host_ms,
                         'forward_device': fwd_ms,
                         'rank_kernels_device': k_ms},
    }
    print('serving: ' + json.dumps(main), flush=True)
    return {'name': 'fsw_rank_fwdp', 'route': 'cuda',
            'source': 'fsw_gnn_tpu_torch/csrc/fsw_rank_fwdp.cu',
            'replaces': 'fsw_gnn_tpu/ops/fsw_rank_pallas.py:588',
            'ms': k_ms, 'plain_ms': p_ms,
            'bound_ms': b_ms,
            'bound_by': ('operations' if 'operations' in bound_by
                         else 'bytes'),
            'library_ms': None}


def bench_setup(torch, T):
    """bench.py's graph, features and model: the 8192-node simple graph in
    the `multi` layout, X ~ N(0, 1) from the same generator, FSWConv(64,
    64, mlp_layers=3) from seed 0; X and the slice vectors put on the
    dyadic grid (so the CPU ranks as the card does)."""
    ei, rng = simple_graph(0, N_NODES)
    X = torch.from_numpy(rng.standard_normal((N_NODES, D_IN))
                         .astype(np.float32))
    model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                      minimize_slice_coherence=False, dtype=torch.float32,
                      device='cpu', generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        X, Vq = dyadic(X, model.fsw_embed.proj_vecs.t())
        model.fsw_embed.proj_vecs.copy_(Vq.t())
    graph = T.to_multi_table(T.from_edge_index(ei, N_NODES))
    return model, X, graph


def check_rank_calls(torch, dev, calls, cfg, where, errs, all_variants):
    """K1f and K1b against their plain versions on captured rank calls, at
    the shapes the path gave them.  K1f on the arguments as passed; K1b on
    Z and V rounded to the dyadic grid (so both sides rank alike), in the
    path's variant and with with_dw on and random weights, and with
    `all_variants` also with uniform_w off and with ties and an f = 0
    slice."""
    from fsw_gnn_tpu_torch.embedding import table_weights
    gen = torch.Generator(device=dev).manual_seed(1)
    fwd = [0.0, 0.0]
    bwd = [0.0, 0.0]
    with torch.no_grad():
        for args, unif, dw in calls:
            R, B, D = args[0].shape
            S = args[4].shape[1]
            shape = f'{where}, B={B} R={R} D={D} S={S}'
            e = check_fwd(torch, f'{shape}, path', args, unif)
            fwd = [max(a, b) for a, b in zip(fwd, e)]
            Z, wn, pad, freqs, V = args
            Z, V = dyadic(Z, V)
            w = torch.rand((R, B), generator=gen, device=dev) * (wn > 0)
            _, wn_r, pad_r = table_weights(w, cfg)
            variants = [
                ('path', Z, wn, pad, freqs, unif, dw),
                ('with_dw, random weights', Z, wn_r.contiguous(),
                 pad_r.contiguous(), freqs, False, True)]
            if all_variants:
                f_zero = freqs.clone()
                f_zero[1] = 0.0
                Zt = Z.clone()
                Zt[:, 1::2] = Zt[:, 0::2]
                variants += [
                    ('uniform_w off', Z, wn, pad, freqs, False, dw),
                    ('ties, f=0', Zt, wn, pad, f_zero, unif, dw)]
            G = torch.randn((R, S), generator=gen, device=dev)
            for label, z, a, p, f, u, d in variants:
                e = check_bwd(torch, f'{shape}, {label}', (z, a, p, f, V), G,
                              u, d)
                bwd = [max(a, b) for a, b in zip(bwd, e)]
    errs['fsw_rank_fwdp'] = max(errs['fsw_rank_fwdp'], fwd[0])
    errs['fsw_rank_bwdp'] = max(errs['fsw_rank_bwdp'], bwd[0])
    print(f'{where}: K1f and K1b checked on {len(calls)} tables: ok; K1f max '
          f'abs err {fwd[0]:.3e} ({fwd[1]:.3e} of the output scale), K1b '
          f'{bwd[0]:.3e} ({bwd[1]:.3e} of an output\'s scale), '
          f'{len(variants)} variants', flush=True)


def bench_step(torch, T, dev, counts, errs):
    """Phases 5 and 6.  Returns the K1b entry's timing fields and prints
    the step's numbers."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (fsw_rank_aggregate_proj,
                                                fsw_rank_aggregate_proj_bwd)
    cpu_model, X, graph = bench_setup(torch, T)
    model = copy.deepcopy(cpu_model).to(dev)
    Xd, gd = X.to(dev), graph.to(dev)
    with torch.no_grad():
        calls = capture_rank_calls(lambda: model(Xd, gd))
    check_rank_calls(torch, dev, calls, model.embed_cfg, 'bench graph', errs,
                     all_variants=True)
    n_classes = len(graph.tables)
    e_real = int(graph.num_edges)
    opt = torch.optim.SGD(model.parameters(), lr=STEP_LR)

    def loss_of(out):
        return (out * out).sum() / N_NODES

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model(Xd, gd))
        loss.backward()
        return loss.detach()

    fsw_rank_aggregate_proj.launches = 0
    fsw_rank_aggregate_proj_bwd.launches = 0
    losses = [step()]
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    opt.step()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(N_STEPS):
        losses.append(step())
        opt.step()
    b.record()
    b.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / N_STEPS
    event_ms = a.elapsed_time(b) / N_STEPS
    n_f, n_b = (fsw_rank_aggregate_proj.launches,
                fsw_rank_aggregate_proj_bwd.launches)
    want = n_classes * (N_STEPS + 1)
    if (n_f, n_b) != (want, want):
        fail(f'bench step: K1f launched {n_f}, K1b {n_b} times; expected '
             f'{want} each ({n_classes} classes x {N_STEPS + 1} steps)')
    counts['fsw_rank_fwdp'] += n_f
    counts['fsw_rank_bwdp'] += n_b
    losses = torch.stack(losses).cpu().numpy()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'bench step: loss not finite and falling: {losses[0]} -> '
             f'{losses[-1]}')

    # the first step on the CPU, from the same parameters
    loss_of(cpu_model(X, graph)).backward()
    grad_err = {}
    for k, p in cpu_model.named_parameters():
        w, g = p.grad, grads[k]
        err = (g - w).abs()
        scale = w.abs().max().item()
        if not bool(torch.all(err <= GRAD_ATOL_REL * scale
                              + GRAD_RTOL * w.abs())):
            fail(f'bench step: gradient of {k} differs from the CPU: max '
                 f'abs err {err.max().item():.3e}, scale {scale:.3e}')
        grad_err[k] = err.max().item() / max(scale, 1e-30)

    parts = step_parts_ms(torch, lambda: model(Xd, gd), loss_of, opt)

    def full_step():
        step()
        opt.step()
    busy = traced_busy_ms(torch, full_step, 10)
    gen = torch.Generator(device=dev).manual_seed(2)
    kern, rows = time_rank_kernels(torch, calls, len(calls), gen,
                                   plain_reps=3)
    res = {
        'steps': N_STEPS + 1, 'edges': e_real, 'classes': n_classes,
        'launches_k1f': n_f, 'launches_k1b': n_b,
        'loss_first': float(losses[0]), 'loss_last': float(losses[-1]),
        'step_ms_events': event_ms, 'step_ms_host_clock': wall_ms,
        'fwd_bwd_edges_per_s': e_real / (wall_ms * 1e-3),
        **parts,
        'device_idle_share': 1.0 - parts['step_device_ms'] / wall_ms,
        'step_device_busy_ms_trace': busy,
        'device_idle_share_trace': (None if busy is None
                                    else 1.0 - busy / wall_ms),
        'k1f_ms_per_step': kern['fwd'], 'k1b_ms_per_step': kern['bwd'],
        'k1f_plain_ms_per_step': kern['fwd_plain'],
        'k1b_plain_ms_per_step': kern['bwd_plain'],
        'k1b_bound_ms_per_step': kern['bwd_bound'],
        'first_step_grad_max_rel_err': max(grad_err.values()),
        'per_class': rows,
    }
    print('bench step: ' + json.dumps(res), flush=True)
    return kern


def trainer_phase(torch, T, dev, counts, errs):
    """Phase 7: check the rank kernels on every table of the Trainer's
    path, fit the Trainer on the card, and print its numbers."""
    from fsw_gnn_tpu_torch.ops.fsw_rank import (fsw_rank_aggregate_proj,
                                                fsw_rank_aggregate_proj_bwd)
    from fsw_gnn_tpu_torch.data import load
    from fsw_gnn_tpu_torch.train import masked_softmax_cross_entropy
    data = load('cora')
    tr = T.Trainer(data, T.TrainConfig(
        hidden_dims=(64, 64), epochs=TRAIN_EPOCHS,
        eval_every=TRAIN_EVAL_EVERY), device=dev)
    # the initial loss of the same model on the CPU, in train mode
    cpu_model = copy.deepcopy(tr.model).to('cpu').train()
    with torch.no_grad():
        logits = cpu_model(torch.from_numpy(data.features),
                           T.auto_layout(tr.graph))
        s, c = masked_softmax_cross_entropy(
            logits, torch.from_numpy(data.labels).long(),
            torch.from_numpy(data.train_mask.astype(np.float32)))
        loss0_cpu = (s / max(c.item(), 1.0)).item()
    del cpu_model, logits

    n_layers = len(tr.model.convs)
    n_classes = len(tables_of(tr.compute_graph))
    # both kernels on every (layer, class) table, as one forward passes it
    tr.model.eval()
    with torch.no_grad():
        calls = capture_rank_calls(lambda: tr.model(tr.X, tr.compute_graph))
    if len(calls) != n_layers * n_classes:
        fail(f'trainer: one forward made {len(calls)} rank calls for '
             f'{n_layers} layers x {n_classes} classes')
    check_rank_calls(torch, dev, calls, tr.model.convs[0].embed_cfg,
                     'trainer', errs, all_variants=False)

    fsw_rank_aggregate_proj.launches = 0
    fsw_rank_aggregate_proj_bwd.launches = 0
    out = tr.fit()
    torch.cuda.synchronize()
    n_f, n_b = (fsw_rank_aggregate_proj.launches,
                fsw_rank_aggregate_proj_bwd.launches)
    n_evals = TRAIN_EPOCHS // TRAIN_EVAL_EVERY + 1     # and the final one
    want_f = n_layers * n_classes * (TRAIN_EPOCHS + n_evals)
    want_b = n_layers * n_classes * TRAIN_EPOCHS
    if (n_f, n_b) != (want_f, want_b):
        fail(f'trainer: K1f launched {n_f}, K1b {n_b} times; expected '
             f'{want_f} and {want_b}')
    counts['fsw_rank_fwdp'] += n_f
    counts['fsw_rank_bwdp'] += n_b
    losses = [h['loss'] for h in tr.history]
    if not abs(losses[0] - loss0_cpu) <= LOSS0_RTOL * abs(loss0_cpu):
        fail(f'trainer: initial loss {losses[0]} differs from the CPU '
             f'forward {loss0_cpu}')
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f'trainer: loss not finite and falling: {losses}')
    final = out['final']
    if not final['train_acc'] > TRAIN_ACC_MIN:
        fail(f'trainer: train accuracy {final["train_acc"]} <= '
             f'{TRAIN_ACC_MIN}')

    # one epoch's parts, and the rank kernels of every layer and class
    t0 = time.perf_counter()
    for _ in range(5):
        tr.train_epoch()
    epoch_ms = 1e3 * (time.perf_counter() - t0) / 5
    model, X, g = tr.model, tr.X, tr.compute_graph

    def loss_of(logits):
        s, c = masked_softmax_cross_entropy(logits, tr.labels, tr.train_mask)
        return s / torch.clamp(c, min=1.0)
    parts = step_parts_ms(torch, lambda: model(X, g, generator=tr.generator),
                          loss_of, tr.opt)
    gen = torch.Generator(device=dev).manual_seed(3)
    kern, rows = time_rank_kernels(torch, calls, n_classes, gen, n=3)
    res = {
        'dataset': data.name, 'nodes': data.num_nodes,
        'features': int(data.features.shape[1]),
        'classes': data.num_classes, 'edges': int(tr.graph.num_edges),
        'layers': n_layers, 'degree_classes': n_classes,
        'launches_k1f': n_f, 'launches_k1b': n_b,
        'epochs': out['epochs_run'],
        'seconds_per_epoch_fit': out['seconds'] / out['epochs_run'],
        'epoch_ms_train_only': epoch_ms,
        'loss_first': losses[0], 'loss_first_cpu': loss0_cpu,
        'loss_last': losses[-1], **{k: v for k, v in final.items()},
        **parts,
        'device_idle_share': 1.0 - parts['step_device_ms'] / epoch_ms,
        'k1f_ms_per_epoch': kern['fwd'], 'k1b_ms_per_epoch': kern['bwd'],
        'k1b_bound_ms_per_epoch': kern['bwd_bound'],
        'per_layer_class': rows,
    }
    print('trainer: ' + json.dumps(res), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs an '
             'NVIDIA GPU')
    sys.path.insert(0, ROOT)
    import fsw_gnn_tpu_torch as T
    from fsw_gnn_tpu_torch import kernels

    # ---- 1. device -------------------------------------------------------
    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f'device: {kind} (count {torch.cuda.device_count()}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda})')
    print(smi_line, flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build(kernels.sources())
    print(f'build: {sorted(logs) or "(already built)"} in '
          f'{time.perf_counter() - t0:.2f} s')
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'smem' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')
    sys.stdout.flush()

    counts = {'fsw_rank_fwdp': 0, 'fsw_rank_bwdp': 0}
    errs = {'fsw_rank_fwdp': 0.0, 'fsw_rank_bwdp': 0.0}

    # ---- 3., 4. K1f and serving -------------------------------------------
    torch.manual_seed(0)
    model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                      minimize_slice_coherence=False, dtype=torch.float32,
                      device=dev, generator=torch.Generator().manual_seed(0))
    k1f = serve_and_check_k1f(torch, T, dev, model, counts, errs)

    # ---- 5., 6. the kernels on the bench graph, the bench training step ----
    k1b_times = bench_step(torch, T, dev, counts, errs)

    # ---- 7. the Trainer -----------------------------------------------------
    trainer_phase(torch, T, dev, counts, errs)

    # ---- 8. kernels line, 9. last line --------------------------------------
    line = {'kernels': [
        dict(k1f, launches=counts['fsw_rank_fwdp'],
             max_abs_err=errs['fsw_rank_fwdp']),
        {'name': 'fsw_rank_bwdp', 'route': 'cuda',
         'source': 'fsw_gnn_tpu_torch/csrc/fsw_rank_bwdp.cu',
         'replaces': 'fsw_gnn_tpu/ops/fsw_rank_pallas.py:605',
         'launches': counts['fsw_rank_bwdp'],
         'max_abs_err': errs['fsw_rank_bwdp'],
         'ms': k1b_times['bwd'], 'plain_ms': k1b_times['bwd_plain'],
         'bound_ms': k1b_times['bwd_bound'],
         'bound_by': k1b_times['bwd_bound_by'], 'library_ms': None}]}
    print(json.dumps(line))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
