#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. the card's name, and its name and power limit from nvidia-smi;
  2. build every CUDA kernel of the package from its sources (nvcc,
     sm_90a), with the seconds it took and ptxas' resource report;
  3. hold each kernel against its plain PyTorch version on the card, at
     every degree-class shape of the served envelope, and time both;
  4. the main path: the bench FSWConv (in = out = 64 channels, 127 slices,
     3-layer MLP head, float32, random weights from seed 0) behind a
     GraphServer with a degree-class envelope sized from an 8192-node,
     average-degree-16 simple random graph, serving requests of 4096 to
     8192 nodes through `predict` and `predict_many`; every output is
     checked finite, one full-size request against the same model on the
     CPU, and the kernels' launch counts against the path's classes;
  5. one JSON line listing the kernels with their launches, errors, times
     and bounds;
  6. the last line: {"ok": true, "device": {...}}.

Tolerances:
  * kernel against plain version, both on the card in float32:
    |kernel - plain| <= 2e-5 * max|plain| + 1e-5 * |plain|.  The weighted
    ranks agree to the bit wherever the projections do; the projections
    differ by summation order (sequential FMAs against cuBLAS) and the
    trig by sincospi against the plain version's libm-style sin/cos.
  * served output against the CPU: |gpu - cpu| <= 1e-4 * max|cpu|.
    The CPU runs the plain versions (MKL products, another summation
    order); three Linear layers follow the embedding.

Bounds: the least time the card could take for a kernel's work, the
larger of (bytes that must move) / 3.35 TB/s and (float32 operations) /
67 TFLOP/s, the H100 SXM's published peaks at 700 W.  Bytes: every input
tensor read once and the output written once.  Operations: what this run's
data needs.  Zero-weight (padding) entries and rows contribute exactly 0,
so a row with d real entries needs S * d * (2 D + 3 d + 20) operations:
2 D for the projection, 3 d for the rank loop (compare, select, add) and
about 20 for the trig of one entry-slice.  The bound of the padded shapes,
R * B * S * (2 D + 3 B + 20) operations, is printed beside it.

Latency is reported as the median and the 90th percentile of the
`predict` requests (100 samples, so 10 lie beyond the 90th percentile).
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
SERVE_ATOL_REL = 1e-4
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
TRIG_OPS = 20


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


def device_ms(torch, fn, n, reps=5):
    """(device ms per call, host ms per call) of `fn`.  The device time is
    the median over `reps` of the mean over `n` back-to-back calls between
    two CUDA events.  A sleep kernel queued first keeps the card busy while
    the host enqueues the calls, so the Python cost of each call (the host
    time, measured alone) does not leave the card idle inside the timed
    region."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * max(2e-3, 3 * n * host))   # >= 2 GHz SM clock
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


def rank_bound_ms(weight, D, S):
    """(bound ms, 'operations' or 'bytes', padded-shape bound ms) of one
    rank-kernel call on an (R, B) weight table (see the module docstring)."""
    R, B = weight.shape
    deg = (weight > 0).sum(dim=1).double()
    ops = S * float((deg * (2 * D + 3 * deg + TRIG_OPS)).sum())
    ops_padded = R * B * S * (2 * D + 3 * B + TRIG_OPS)
    nbytes = 4 * (R * B * D + R * B + R + S + D * S + R * S)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes',
            1e3 * max(ops_padded / PEAK_F32_OPS, t_bytes))


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs an '
             'NVIDIA GPU')
    sys.path.insert(0, ROOT)
    import fsw_gnn_tpu_torch as T
    from fsw_gnn_tpu_torch import kernels
    from fsw_gnn_tpu_torch.embedding import gather_rows, table_weights
    from fsw_gnn_tpu_torch.ops.fsw_rank import (
        fsw_rank_aggregate_proj, fsw_rank_aggregate_proj_plain)

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

    # ---- model, envelope, server -----------------------------------------
    torch.manual_seed(0)
    model = T.FSWConv(D_IN, D_OUT, mlp_layers=3,
                      minimize_slice_coherence=False, dtype=torch.float32,
                      device=dev, generator=torch.Generator().manual_seed(0))
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

    # ---- 3. kernel check at every served class shape ----------------------
    ei0, X0 = request(1, N_NODES)
    g0 = T.from_edge_index(ei0, N_NODES, pad_to=MAX_EDGES)
    mt0 = T.to_multi_table(g0, classes=classes,
                           class_rows=class_rows).to(dev)
    X0d = torch.from_numpy(X0).to(dev)
    V = model.fsw_embed.proj_vecs.detach().t().contiguous()
    freqs = model.fsw_embed.freqs.detach().contiguous()
    f_zero = freqs.clone()
    f_zero[0] = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err, worst_rel = 0.0, 0.0
    k_ms = p_ms = b_ms = bp_ms = 0.0
    bound_by = set()
    with torch.inference_mode():
        for tbl in mt0.tables:
            _, wn, pad = table_weights(tbl.weight, cfg)
            Z = gather_rows(X0d, tbl, cfg).contiguous()
            R, B, D = Z.shape
            # ties: every odd entry repeats the even one before it
            Zt = Z.clone()
            Zt[:, 1::2] = Zt[:, 0::2]
            w = torch.rand((R, B), generator=gen, device=dev) * (tbl.weight
                                                                  > 0)
            _, wn_r, pad_r = table_weights(w, cfg)
            variants = [
                ('served', Z, wn, pad, freqs, True),
                ('served, uniform_w off', Z, wn, pad, freqs, False),
                ('ties, f=0', Zt, wn, pad, f_zero, True),
                ('ties, f=0, random weights', Zt, wn_r.contiguous(),
                 pad_r.contiguous(), f_zero, False)]
            for label, z, a, p, f, unif in variants:
                got = fsw_rank_aggregate_proj(z, a, p, f, V, uniform_w=unif)
                torch.cuda.synchronize()
                want = fsw_rank_aggregate_proj_plain(z, a, p, f, V,
                                                     uniform_w=unif)
                err = (got - want).abs()
                scale = want.abs().max().item()
                ok = bool(torch.all(err <= KERNEL_ATOL_REL * scale
                                    + KERNEL_RTOL * want.abs()))
                max_err = max(max_err, err.max().item())
                worst_rel = max(worst_rel, err.max().item() / scale)
                if not (ok and torch.isfinite(got).all()):
                    fail(f'kernel disagrees at B={B} R={R} ({label}): max '
                         f'abs err {err.max().item():.3e}, scale '
                         f'{scale:.3e}')
            km, kh = device_ms(torch, lambda: fsw_rank_aggregate_proj(
                Z, wn, pad, freqs, V, uniform_w=True), 20)
            pm, _ = device_ms(torch, lambda: fsw_rank_aggregate_proj_plain(
                Z, wn, pad, freqs, V, uniform_w=True), 3)
            bm, by, bpm = rank_bound_ms(tbl.weight, D, V.shape[1])
            bound_by.add(by)
            k_ms, p_ms = k_ms + km, p_ms + pm
            b_ms, bp_ms = b_ms + bm, bp_ms + bpm
            print(f'  class B={B:3d} R={R:5d} ({int((tbl.weight > 0).sum())}'
                  f' real entries): kernel {km:.4f} ms (host {kh:.4f} ms a '
                  f'call), plain {pm:.4f} ms, bound {bm:.5f} ms ({by}), '
                  f'padded-shape bound {bpm:.5f} ms')
    print(f'kernel check: ok, max abs err {max_err:.3e} (max '
          f'{worst_rel:.3e} of the output scale); per request: kernel '
          f'{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms, '
          f'padded-shape bound {bp_ms:.5f} ms', flush=True)

    # ---- 4. main path ------------------------------------------------------
    server.warmup(D_IN)
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
        fail(f'rank kernel launched {launches} times for {n_req} requests '
             f'of {len(classes)} classes')
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
    print('main path: ' + json.dumps(main), flush=True)

    # ---- 5. kernels line, 6. last line --------------------------------------
    line = {'kernels': [{
        'name': 'fsw_rank_fwdp',
        'route': 'cuda',
        'source': 'fsw_gnn_tpu_torch/csrc/fsw_rank_fwdp.cu',
        'replaces': 'fsw_gnn_tpu/ops/fsw_rank_pallas.py:588',
        'launches': launches,
        'max_abs_err': max_err,
        'ms': k_ms,
        'plain_ms': p_ms,
        'bound_ms': b_ms,
        'bound_by': ('operations' if 'operations' in bound_by
                     else 'bytes'),
        'library_ms': None,
    }]}
    print(json.dumps(line))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
