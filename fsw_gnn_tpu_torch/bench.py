"""The headline benchmark: FSWConv forward + backward + SGD step, in real
edges a second on one card.

Counterpart of the repository's bench.py, on its workload: a simple random
graph of FSW_BENCH_NODES nodes (FSW_BENCH_DEG draws an edge a node, seed 0,
self loops and duplicate pairs dropped), FSW_BENCH_DIN features drawn from
the same generator, FSWConv(DIN, DOUT, mlp_layers=3,
minimize_slice_coherence=False) from seed 0 (embed_dim 2 max(DIN, DOUT):
127 slices at the defaults), a full forward, backward and SGD(1e-3) step,
in the degree-bucketed MultiTable layout (FSW_BENCH_LAYOUT=table: one
NeighborTable; any other value: the CSR Graph).  Two departures:

  * The loss is sum(out**2) / N, bench.py's sum(out**2) a node.  On the
    plain sum, SGD(1e-3) diverges from this model's initial weights within
    three steps (in the JAX package too; the smoke's phase 42 prints the
    losses), so most of a timed run of up to CALLS x STEPS steps would run
    on NaN parameters, which the rank kernels treat as padding.  The work
    of a step is the same, and its update is bench.py's divided by N.
  * bench.py loops its steps inside one compiled program so that dispatch
    does not pollute the measurement.  Here a run replays one CUDA graph of
    the whole step (the forward, `loss.backward()` and `opt.step()` over
    static parameter, gradient and input buffers) `length` times.  It is
    captured once a `build`, after one eager step on a side stream, as
    `utils.cache.CountingGraph` captures a route.  A capture that fails
    raises: nothing falls back to running eagerly.  A capture also proves
    that the step holds no host synchronisation.  On the CPU a run is the
    eager loop.

Protocol (bench.py's): a warm-up call of each run; REPS reps of
timed(run_n) - timed(run_1), each the host clock over CALLS calls from the
initial parameters (`reset`), ended by reading the last call's probe (the
sum of the first parameter); the headline is the median rep, in real
edges a second.  On the card the line also gives the same protocol with
the eager step (`eager_edges_per_sec`), the graph's step on the device
(`step_device_ms`: CUDA events around STEPS replays behind a sleep kernel,
the median of CALLS windows), `card` (nvidia-smi's name and power limit)
and two checks, either of which failing raises after the line is
printed: the parameters after STEPS graph steps against those after as
many eager steps (`graph_vs_eager_max_abs_diff`, within GRAPH_ATOL: the
same kernels run in the same order), and every probe finite
(`probes_finite`).  On the CPU the line names the CPU, says that the plain
versions ran, and carries no device metric.

`vs_baseline` divides by `edges_per_sec` of fsw_gnn_tpu_torch/
bench_baseline.json, an H100 measurement (1.0 where the file is absent,
None on the CPU).  `roofline_edges_per_sec` (the `multi` layout) is the
real edges over `speed_of_light_step`, the H100's floor of one step's K1f
and K1b calls (`utils.bounds`).

    python -m fsw_gnn_tpu_torch.bench [--device cpu]
    python -m fsw_gnn_tpu_torch.cli bench [--device cpu]

Knobs (bench.py's, with its defaults): FSW_BENCH_NODES 8192,
FSW_BENCH_DEG 16, FSW_BENCH_DIN 64, FSW_BENCH_DOUT 64, FSW_BENCH_STEPS 60,
FSW_BENCH_WARMUP 1, FSW_BENCH_CALLS 3, FSW_BENCH_REPS 5, FSW_BENCH_DTYPE
float32 | bfloat16 (the model's parameters and the features in bfloat16,
as the JAX model's dtype; the graph built in float32 and its weights
rounded to bfloat16, as the port's bfloat16 server rounds them),
FSW_BENCH_LAYOUT multi | table | csr (read at `build`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .benchmarks import _timing
from .conv import FSWConv
from .device import resolve_device
from .graph import from_edge_index, to_multi_table, to_neighbor_table
from .utils.bounds import (PEAK_BYTES, PEAK_F32_OPS, PEAK_TF32_OPS, bound,
                           rank_bwd_work, rank_work)
from .utils.cache import _Captured


def _env_int(name, default):
    return int(os.environ.get(name, default))


N_NODES = _env_int('FSW_BENCH_NODES', 8192)
AVG_DEG = _env_int('FSW_BENCH_DEG', 16)
D_IN = _env_int('FSW_BENCH_DIN', 64)
D_OUT = _env_int('FSW_BENCH_DOUT', 64)
STEPS_PER_CALL = _env_int('FSW_BENCH_STEPS', 60)
WARMUP_CALLS = _env_int('FSW_BENCH_WARMUP', 1)
TIMED_CALLS = _env_int('FSW_BENCH_CALLS', 3)
REPS = _env_int('FSW_BENCH_REPS', 5)
DTYPE = os.environ.get('FSW_BENCH_DTYPE', 'float32')  # float32 | bfloat16
LR = 1e-3
# graph against eager steps: the same kernels in the same order, so the
# same bits are expected
GRAPH_ATOL = 0.0
METRIC = 'fsw_conv_fwd_bwd_edges_per_sec'
BASELINE = Path(__file__).resolve().parent / 'bench_baseline.json'


def speed_of_light_step(graph, n_slices: int, n_nodes: int, d_in: int):
    """The H100's floor (seconds) of one training step of the MultiTable
    design: for each degree class, the bound of its K1f call plus that of
    its K1b call (`utils.bounds`: bytes at 3.35 TB/s, float32 operations at
    67 TFLOP/s, the projections' products at 495 / 3 TFLOP/s; each of
    the step's rank calls in series on one stream), summed over the
    classes.  The gathers, the MLP head and the optimizer are not
    modelled, nor is launch latency.  `n_nodes` is bench.py's argument,
    which its model does not use either.

    Returns (seconds, detail).  detail keeps bench.py's `table_entries`
    (every table entry, the padding included) and adds the real entries,
    the float32 operations, the 3xTF32 product operations and the bytes of
    all the calls, and each of those at its peak (`t_ops_ms`,
    `t_tf32_ms`, `t_bytes_ms`)."""
    t_ms = 0.0
    entries = real = 0
    ops = mma = nbytes = 0.0
    for t in graph.tables:
        wn = torch.as_tensor(t.weight)        # zero at the padding
        entries += wn.numel()
        real += int((wn > 0).sum())
        for work in (rank_work, rank_bwd_work):
            o, m, b = work(wn, d_in, n_slices)
            t_ms += bound(o, b, m)[0]
            ops, mma, nbytes = ops + o, mma + m, nbytes + b
    return 1e-3 * t_ms, {
        'table_entries': entries, 'real_entries': real, 'ops': ops,
        'tf32_product_ops': mma, 'bytes': nbytes,
        't_ops_ms': 1e3 * ops / PEAK_F32_OPS,
        't_tf32_ms': 1e3 * 3 * mma / PEAK_TF32_OPS,
        't_bytes_ms': 1e3 * nbytes / PEAK_BYTES}


def simple_edges(rng, n_nodes, avg_deg):
    """bench.py's graph: n * avg_deg (src, dst) draws, self loops dropped,
    duplicate pairs merged (so every weight is 1 and the rank kernels'
    row-constant trig applies); (2, E) sorted by src * n + dst."""
    E = n_nodes * avg_deg
    src = rng.integers(0, n_nodes, E)
    dst = rng.integers(0, n_nodes, E)
    keep = src != dst
    pairs = np.unique(src[keep].astype(np.int64) * n_nodes + dst[keep])
    return np.stack([pairs // n_nodes, pairs % n_nodes])


def floats_to(obj, dtype):
    """A device layout (a Graph, NeighborTable or MultiTable), a tuple of
    them or a tensor, with every floating tensor rounded to `dtype`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, tuple):
        return tuple(floats_to(o, dtype) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: floats_to(getattr(obj, f.name), dtype)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))})
    return obj


def build(steps_per_call=None, device=None):
    """Construct the benchmark workload on `device` (None: the card).
    Returns bench.py's keys that mean something here: `run_n` and `run_1`
    (runs of steps_per_call and 1 steps), `make_run`, `E_real`,
    `steps_per_call`, `graph` (the layout), `layout`, `d_in`, `d_out`,
    `n_nodes`; and in place of JAX's immutable initial parameters and
    optimizer state, `reset()`, which copies the initial parameters back
    into the model's (the SGD step keeps no state).  Also `model`, `X`,
    `edge_index`, `dtype`, `device`, `cuda_graph` (the captured step on
    the card, else None) and `counts` ({'eager_steps': eager steps run so
    far, the capture's warm-up included}).

    `make_run(length, eager=False)` returns a function of no argument that
    runs `length` SGD steps from the current parameters (so calls chain as
    JAX's `run(p, s)` calls do) and returns the probe, a 0-d tensor on the
    device: the sum of the first parameter; the caller's float(probe) is
    the readback barrier.  On the card a run replays the captured step,
    with eager=True it runs the eager step; on the CPU it is always the
    eager step."""
    dev = resolve_device(device)
    steps_per_call = steps_per_call or STEPS_PER_CALL
    n_nodes, d_in, d_out = N_NODES, D_IN, D_OUT
    dt = torch.bfloat16 if DTYPE == 'bfloat16' else torch.float32
    rng = np.random.default_rng(0)
    edge_index = simple_edges(rng, n_nodes, AVG_DEG)
    g = from_edge_index(edge_index, n_nodes)
    E_real = g.num_edges
    layout = os.environ.get('FSW_BENCH_LAYOUT', 'multi')
    if layout == 'table':
        g = to_neighbor_table(g)
    elif layout == 'multi':
        g = to_multi_table(g)
    g = floats_to(g.to(dev), dt)
    X = torch.from_numpy(rng.standard_normal((n_nodes, d_in))).to(dt).to(dev)

    model = FSWConv(d_in, d_out, mlp_layers=3,
                    minimize_slice_coherence=False, dtype=dt, device=dev,
                    generator=torch.Generator().manual_seed(0))
    params = list(model.parameters())
    init = [p.detach().clone() for p in params]
    opt = torch.optim.SGD(params, lr=LR)
    counts = {'eager_steps': 0}

    def step():
        # zero in place, so the gradients stay in the buffers the captured
        # step accumulates into
        opt.zero_grad(set_to_none=False)
        out = model(X, g)
        loss = (out * out).sum() / n_nodes
        loss.backward()
        opt.step()
        if not (dev.type == 'cuda'
                and torch.cuda.is_current_stream_capturing()):
            counts['eager_steps'] += 1
        return loss.detach()

    def reset():
        with torch.no_grad():
            for p, p0 in zip(params, init):
                p.copy_(p0)

    # the warm-up step creates the gradients' buffers and sets up the
    # kernels' libraries and cuBLAS's handles outside the capture
    captured = (_Captured(step, (), dev, torch.cuda.Stream(dev))
                if dev.type == 'cuda' else None)
    cuda_graph = None if captured is None else captured.graph
    reset()

    def make_run(length, eager=False):
        one = step if eager or cuda_graph is None else cuda_graph.replay

        def run():
            for _ in range(length):
                one()
            return params[0].detach().sum()
        return run

    return dict(run_n=make_run(steps_per_call), run_1=make_run(1),
                make_run=make_run, reset=reset, E_real=E_real,
                steps_per_call=steps_per_call, graph=g, layout=layout,
                d_in=d_in, d_out=d_out, n_nodes=n_nodes, model=model, X=X,
                edge_index=edge_index, dtype=dt, device=dev,
                cuda_graph=cuda_graph, counts=counts)


def timed(b, run, calls, probes):
    """Host seconds of `calls` calls of `run` from the initial parameters
    (the work queued before it drained first), ended by reading the last
    probe back; every call's probe is appended to `probes`."""
    b['reset']()
    _timing.drain(b['device'])
    t0 = time.perf_counter()
    for _ in range(calls):
        probe = run()
        probes.append(probe)
    float(probe)                                  # readback barrier
    return time.perf_counter() - t0


def differenced(b, run_n, run_1, probes):
    """bench.py's protocol on two runs: WARMUP_CALLS calls of each, then
    REPS samples of the real edges a second of the n - 1 steps a call that
    run_n makes beyond run_1, sorted."""
    for run in (run_n, run_1):
        for _ in range(WARMUP_CALLS):
            b['reset']()
            probes.append(run())
            float(probes[-1])                     # drain the pipeline
    steps = (b['steps_per_call'] - 1) * TIMED_CALLS
    return sorted(
        b['E_real'] * steps / max(timed(b, run_n, TIMED_CALLS, probes)
                                  - timed(b, run_1, TIMED_CALLS, probes),
                                  1e-9)
        for _ in range(REPS))


def all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def graph_vs_eager(b) -> float:
    """Max abs difference of the parameters after steps_per_call replays
    of the captured step and after as many eager steps, both from the
    initial parameters."""
    def after(run):
        b['reset']()
        run()
        return [p.detach().clone() for p in b['model'].parameters()]
    got = after(b['run_n'])
    want = after(b['make_run'](b['steps_per_call'], eager=True))
    if not all_finite(got + want):
        return float('inf')
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(got, want))


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    b = build(device=dev)
    E_real, spc, layout = b['E_real'], b['steps_per_call'], b['layout']
    card = dev.type == 'cuda'
    probes = []
    samples = differenced(b, b['run_n'], b['run_1'], probes)
    edges_per_sec = float(np.median(samples))
    spread_pct = (100.0 * (samples[-1] - samples[0]) / edges_per_sec
                  if edges_per_sec else 0.0)

    vs = None
    if card:
        vs = 1.0
        if BASELINE.exists():
            base = json.loads(BASELINE.read_text()).get('edges_per_sec')
            if base:
                vs = edges_per_sec / base
    out = {
        'metric': METRIC,
        'value': round(edges_per_sec, 1),
        'unit': 'edges/s/chip' if card else 'edges/s on the CPU',
        'vs_baseline': None if vs is None else round(vs, 4),
        'n_reps': REPS,
        'spread_pct': round(spread_pct, 1),
        'min': round(samples[0], 1),
        'max': round(samples[-1], 1),
    }
    if layout == 'multi':
        t_floor, detail = speed_of_light_step(
            b['graph'], 2 * max(b['d_in'], b['d_out']) - 1, b['n_nodes'],
            b['d_in'])
        roofline_eps = E_real / t_floor
        out['roofline_edges_per_sec'] = round(roofline_eps, 1)
        out['pct_of_roofline'] = (round(100.0 * edges_per_sec / roofline_eps,
                                        1) if card else None)
        out['roofline_detail'] = detail
    out.update(layout=layout, dtype=str(b['dtype']).replace('torch.', ''),
               edges=E_real, steps_per_call=spc)
    diff = None
    if card:
        eager = differenced(b, b['make_run'](spc, eager=True),
                            b['make_run'](1, eager=True), probes)
        replay = b['cuda_graph'].replay
        windows = []
        for _ in range(TIMED_CALLS):
            b['reset']()
            windows += _timing.windows_ms(replay, dev, iters=spc, reps=1)
        diff = graph_vs_eager(b)
        out.update(eager_edges_per_sec=float(np.median(eager)),
                   step_device_ms=_timing.median(windows),
                   step_device_windows_ms=windows,
                   graph_vs_eager_max_abs_diff=diff,
                   card=_timing.smi_line(), torch=torch.__version__,
                   cuda=torch.version.cuda)
    else:
        out['runs'] = ('the plain PyTorch versions on the CPU (no kernel); '
                       'the rate is the host clock of the CPU')
    finite = all_finite(probes) and all_finite(b['model'].parameters())
    out.update(probes=len(probes), probes_finite=finite,
               eager_steps=b['counts']['eager_steps'],
               classes=(len(b['graph'].tables) if layout == 'multi'
                        else None),
               **_timing.card(dev))
    print(json.dumps(out), flush=True)
    if not finite:
        raise RuntimeError('bench: a probe or a parameter is not finite')
    if diff is not None and not diff <= GRAPH_ATOL:
        raise RuntimeError(f'bench: the captured step differs from the eager '
                           f'step by {diff} after {spc} steps')
    return out


if __name__ == '__main__':
    main()
