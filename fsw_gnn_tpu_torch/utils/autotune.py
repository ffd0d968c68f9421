"""Opt-in one-shot autotune of the routing rules, measured on the card.

Counterpart of `fsw_gnn_tpu/utils/autotune.py`, retargeted to the rule
the port's `embedding._resolve_aggregate` decides on.  The measured table
(`embedding._RANK_RULES_BY_KIND`) covers the H100; on any other card
'auto' takes the sort route unless this module has cached rules for the
card's kind.  `autotune_rank_rules()` measures on the current card:

  * 'dw', 'nodw': K2 (`'rank'`) against the sort route through
    `bucket_quadrature` at the widths PROBE_BUCKETS, 2^17 entries, 128
    slices, forward + backward of sum(sin(out)), P taking the gradient
    (with 'dw' the weights too, so that K2b computes their gradient);
  * 'cart': K4 against the sort route at CART_BUCKETS, 8 frequencies;
  * 'k1': K1 (the fused route) against the unfused route (X V, the
    gather of P, K2) on synthetic degree classes of K1_NODES nodes, at the
    feature widths K1_DS (S = 2 max(D, 64) - 1 slices) and the entries per
    node K1_RHOS (table entries, padding included, over the nodes),
    forward + backward with the slice vectors taking the gradient
    (`chip_smoke.py`'s routing phase);
  * 'k1_fwd': the same ladder, forward only (measured and cached, read by
    no route yet).

Each margin is t_other / t_rank (> 1: the rank kernel wins).  The caps
and `waste_*` keys come from the JAX package's `derive_rules`, K1's
crossover from `fit_k1_rule`; the rules are cached by the card's kind.

Usage:
    python -m fsw_gnn_tpu_torch.cli autotune        # measure + cache
or  from fsw_gnn_tpu_torch.utils.autotune import autotune_rank_rules

Cache: FSW_AUTOTUNE_CACHE (default
~/.cache/fsw_gnn_tpu_torch/autotune.json), a JSON object keyed by kind.

Timing: a cell's time is the median over `calls` windows of `steps`
back-to-back passes between two CUDA events, a sleep kernel queued first
so the card never waits for the host (the device's time, not the
host's); on the CPU the host clock.  Before a cell is timed its rank
route's forward is held against the other route's on the same inputs
(weights on multiples of 2^-20, K1's inputs on a dyadic grid, so both
routes rank alike and sum exactly); a disagreement raises.  A width whose
kernel cannot hold its row (`ops.fsw_rank.misfit`) and a card out of
memory lose (margin 0.0).  A kernel that cannot be built or launched
raises out of the autotune: it is neither a margin nor a transient
failure.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

SAFETY = 1.1          # a config must win by >10% to qualify
PROBE_BUCKETS = (32, 64, 128, 256)
PROBE_ENTRIES = 1 << 17
CART_BUCKETS = (32, 64)
K1_DS = (64, 128, 256, 512, 1024, 1433)
K1_RHOS = (0.05, 0.2, 0.7, 2.0, 9.0)
K1_NODES, K1_BUCKET = 8192, 16
MODES = ('dw', 'nodw', 'cart', 'k1', 'k1_fwd')
# the smoke's kernel tolerance: |rank - other| <= ATOL_REL max|other| +
# RTOL |other|
RTOL, ATOL_REL = 1e-5, 2e-5


def cache_path() -> str:
    return os.environ.get(
        'FSW_AUTOTUNE_CACHE',
        os.path.join(os.path.expanduser('~'), '.cache',
                     'fsw_gnn_tpu_torch', 'autotune.json'))


def cached_rules(kind: str) -> Optional[dict]:
    """Rules cached for this device kind, or None."""
    path = cache_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            all_rules = json.load(f)
    except (OSError, ValueError):
        return None
    return all_rules.get(kind)


def _write_cache(kind: str, rules: dict) -> None:
    """Put `rules` under `kind` in the cache file, written whole to a
    temporary file and renamed over it."""
    path = cache_path()
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    all_rules = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                all_rules = json.load(f)
        except (OSError, ValueError):
            all_rules = {}
    all_rules[kind] = rules
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'w') as f:
        json.dump(all_rules, f, indent=1)
    os.replace(tmp, path)


def derive_rules(margins: Dict[str, Dict[int, float]]) -> dict:
    """Crossover rules from measured margins (t_sort / t_rank), as the JAX
    package derives them.

    `margins` maps mode ('dw' | 'nodw' | 'cart') -> {bucket: margin}
    (other modes are ignored).  Caps: the largest probed bucket that
    still wins by >SAFETY (the last probed bucket needs >= 1.25: there is
    no data beyond it).  Waste thresholds: margin / SAFETY, 0.0 where the
    mode does not win; the port's route reads only the caps.
    """
    def cap(mode):
        bs = sorted(margins.get(mode, {}))
        c = 0
        for b in bs:
            need = 1.25 if b == bs[-1] else SAFETY
            if margins[mode][b] >= need:
                c = b
        return c

    def waste(mode, b):
        m = margins.get(mode, {}).get(b)
        if not m or m < SAFETY:
            return 0.0
        return round(m / SAFETY, 2)

    cap_dw, cap_nodw = cap('dw'), cap('nodw')
    return dict(
        cap_dw=cap_dw,
        cap_nodw=cap_nodw,
        waste_cart=waste('cart', min(margins.get('cart') or {32: None})),
        waste_nodw=round(max(1.0, min(
            [m for b, m in margins.get('nodw', {}).items()
             if b <= cap_nodw] or [1.0]) / SAFETY), 2),
        waste_dw_narrow=waste('dw', 32),
        waste_dw_wide=waste('dw', 64),
    )


def _k1_rule(D, rho, rho0, d0) -> bool:
    """`embedding._k1_faster`'s inequality: K1 at (D, rho)."""
    return rho <= rho0 or D * (rho - rho0) < rho * d0


def _verdict(p) -> int:
    """+1 where K1 wins by more than SAFETY, -1 where the unfused route
    does, 0 in between."""
    m = p['unfused_ms'] / p['fused_ms']
    return 1 if m >= SAFETY else -1 if m <= 1.0 / SAFETY else 0


def fit_k1_rule(points) -> dict:
    """K1's crossover, `k1_rho0` and `k1_d0`, from measured points.

    Each point is a dict with D, rho (entries per node), nodes, slices,
    fused_ms and unfused_ms.  The cost model is the one behind
    `embedding.K1_RHO0`: per node and slice, K1 costs a rho D and the
    unfused route b D + c rho, so K1 is faster where rho <= rho0 or
    D (rho - rho0) < rho d0, with rho0 = b / a and d0 = c / a.

    Method: a least-squares fit of the time difference, each point's
    equation (a rho D - b D - c rho) nodes slices / (t_f + t_u) =
    (t_f - t_u) / (t_f + t_u) (scaled by its total time, so a small cell
    weighs as much as a large one).  The fit is then checked on every
    decisive point (a margin beyond SAFETY either way); if it misjudges
    one, the rule of the same form with the widest relative gap between
    the two sides is searched instead (over the rho0 where two points'
    bounds on d0 cross).  Returns
    dict(k1_rho0, k1_d0, k1_fit ('least squares' or 'search'),
    k1_misjudged: the decisive points the rule misjudges, empty whenever
    a rule of this form separates them)."""
    pts = [p for p in points if p['fused_ms'] and p['unfused_ms']]
    decisive = [(p, _verdict(p)) for p in pts if _verdict(p)]

    def misjudged(rho0, d0):
        return [dict(D=p['D'], rho=p['rho'],
                     margin=round(p['unfused_ms'] / p['fused_ms'], 3))
                for p, v in decisive
                if _k1_rule(p['D'], p['rho'], rho0, d0) != (v > 0)]

    rho0 = d0 = None
    if len(pts) >= 3:
        rows, rhs = [], []
        for p in pts:
            tot = p['fused_ms'] + p['unfused_ms']
            k = p['nodes'] * p['slices'] / tot
            rows.append([p['rho'] * p['D'] * k, -p['D'] * k, -p['rho'] * k])
            rhs.append((p['fused_ms'] - p['unfused_ms']) / tot)
        (a, b, c), *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs),
                                        rcond=None)
        if a > 0:
            rho0, d0 = max(float(b / a), 0.0), max(float(c / a), 0.0)
    if rho0 is not None and not misjudged(rho0, d0):
        return dict(k1_rho0=rho0, k1_d0=d0, k1_fit='least squares',
                    k1_misjudged=[])

    # for a given rho0 a point asks d0 above (K1 wins) or at most (it
    # loses) g(rho0) = D (1 - rho0 / rho), a line in rho0: the widest
    # feasible gap between the two sides lies where two such lines (or a
    # line and 0) cross, so those crossings are the candidates
    wins = [p for p, v in decisive if v > 0]
    losses = [p for p, v in decisive if v < 0]
    lines = [(p['D'], p['D'] / p['rho']) for p, _ in decisive] + [(0.0, 0.0)]
    top = max([p['rho'] for p in pts] or [0.0])
    cands = {0.0} | {p['rho'] for p in pts}
    for i, (a1, s1) in enumerate(lines):
        for a2, s2 in lines[i + 1:]:
            if s1 != s2 and 0.0 <= (a1 - a2) / (s1 - s2) <= top:
                cands.add((a1 - a2) / (s1 - s2))
    best = None
    for r0 in sorted(cands):
        if any(p['rho'] <= r0 for p in losses):
            continue                 # a loss would take K1 below rho0
        lo = max([p['D'] * (p['rho'] - r0) / p['rho'] for p in wins
                  if p['rho'] > r0] or [0.0])
        hi = min([p['D'] * (p['rho'] - r0) / p['rho'] for p in losses]
                 or [math.inf])
        if not lo < hi:
            continue
        gap = hi / lo if lo > 0 else math.inf
        d = (math.sqrt(lo * hi) if 0 < lo and hi < math.inf
             else 2 * lo if hi == math.inf else hi / 2)
        if best is None or gap > best[0]:
            best = (gap, r0, d)
    if best is not None:
        return dict(k1_rho0=best[1], k1_d0=best[2], k1_fit='search',
                    k1_misjudged=[])
    if rho0 is None:
        rho0, d0 = 0.0, 0.0
    return dict(k1_rho0=rho0, k1_d0=d0, k1_fit='least squares',
                k1_misjudged=misjudged(rho0, d0))


def _is_compile_error(e: Exception) -> bool:
    """True for DETERMINISTIC failures, where the config loses by
    definition (margin 0.0): the JAX package's string classification of
    compile, lowering and memory failures, and the port's own: the
    ValueError of a width whose kernel cannot hold its row in shared
    memory (`ops.fsw_rank._fits`, `embedding._resolve_aggregate`) and
    `torch.cuda.OutOfMemoryError`.  Transient errors (connection
    reset/timeout/unavailable, a busy device) must NOT be recorded as
    margin 0.0: that verdict is cached per device kind and would withhold
    a winning kernel for good."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(e, ValueError) and 'shared memory' in str(e):
        return True
    msg = f'{type(e).__name__}: {e}'.lower()
    transient = ('unavailable', 'deadline', 'timed out', 'timeout',
                 'connection reset', 'connection refused', 'broken pipe',
                 'aborted', 'already in use', 'busy')
    if any(k in msg for k in transient):
        return False
    compile_class = ('resource_exhausted', 'out of memory', 'oom', 'vmem',
                     'mosaic', 'lower', 'unsupported', 'unimplemented',
                     'invalid_argument', '413', 'payload')
    return any(k in msg for k in compile_class)


def _kernel_failed(e: Exception) -> bool:
    """A kernel that did not build or launch, or a CUDA error: raised out
    of the autotune, never a margin."""
    from ..kernels import KernelError
    return isinstance(e, KernelError) or 'cuda error' in str(e).lower()


def _dyadic(Z, V):
    """Z (..., D) and V (D, S) rounded to dyadic grids 2^-p and 2^-q, the
    finest for which every partial sum of Z V is an integer multiple of
    2^-(p+q) below 2^24 of them: every projection is then exact in float32
    in any summation order, so both routes rank the entries alike."""
    def bound(z, v):
        return float((z.abs().reshape(-1, z.shape[-1]).double()
                      @ v.abs().double()).max())
    bits = int(np.floor(np.log2(2.0 ** 23 / bound(Z, V))))
    p = bits // 2
    q = bits - p
    return (torch.round(Z * 2.0 ** p) / 2.0 ** p,
            torch.round(V * 2.0 ** q) / 2.0 ** q)


def _ms(fn, steps, calls, dev):
    """Milliseconds a pass of `fn` (see the module docstring): the median
    over `calls` windows of `steps` passes."""
    fn()                                        # warm-up
    if dev.type != 'cuda':
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / steps)
        return float(np.median(times))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    cycles = int(2e9 * max(2e-3, 1.5 * enqueue * steps))
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / steps)
    return float(np.median(times))


def _agree(label, got, want):
    """Raise where the rank route's forward departs from the other's."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    if not (bool(torch.isfinite(got).all()) and bool(
            torch.all(err <= ATOL_REL * scale + RTOL * want.abs()))):
        raise RuntimeError(f'autotune: the routes disagree at {label}: max '
                           f'abs err {float(err.max()):.3e}, scale '
                           f'{scale:.3e}')


def _log(obj):
    print(json.dumps(obj), file=sys.stderr, flush=True)


def _rank_ms(label, names, fn, steps, calls, dev, B, F=1, with_dw=False):
    """The rank route's ms; None where it loses by definition (margin
    0.0), or 'transient' after a transient failure and one retry."""
    from ..ops.fsw_rank import misfit
    if misfit(names, B, F, with_dw) is not None:
        _log({'autotune': label, 'rank_misfit': True})
        return None
    for attempt in (0, 1):
        try:
            return _ms(fn, steps, calls, dev)
        except Exception as e:  # noqa: BLE001
            if _kernel_failed(e):
                raise
            if _is_compile_error(e):
                _log({'autotune': label, 'rank_failed': type(e).__name__})
                return None
            if attempt == 1:
                _log({'autotune': label,
                      'transient_failure': type(e).__name__})
    return 'transient'


def _measure_margins(buckets=PROBE_BUCKETS, entries=PROBE_ENTRIES, s=128,
                     f_cart=8, cart_buckets=CART_BUCKETS, k1_ds=K1_DS,
                     k1_rhos=K1_RHOS, k1_nodes=K1_NODES,
                     k1_bucket=K1_BUCKET, steps=3, calls=3, device=None):
    """Measure the margins of every mode on `device` (None: the card).

    Returns (margins, transient failures, cells): margins maps mode ->
    {bucket: margin} ('k1', 'k1_fwd': {(D, rho): margin}, rho as probed),
    and each cell is a dict of its shape, both routes' ms and its margin.
    """
    from ..device import resolve_device
    from ..embedding import FSWConfig, bucket_quadrature
    from ..ops.fsw_rank import misfit
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    margins = {m: {} for m in MODES}
    transient, cells = [], []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for B in sorted(set(buckets) | set(cart_buckets)):
        todo = (['dw', 'nodw'] if B in buckets else []) + (
            ['cart'] if B in cart_buckets else [])
        R = max(8, entries // B)
        P = rand(R, B, s)
        w = rand(R, B).abs() * (torch.rand((R, B), generator=gen,
                                           device=dev) < 0.8)
        wn = w / torch.clamp(w.sum(1, keepdim=True), min=1.0)
        wn = torch.floor(wn * 2.0 ** 20) / 2.0 ** 20     # exact sums
        pad = torch.clamp(1.0 - wn.sum(1), min=0.0)
        for mode in todo:
            cart = mode == 'cart'
            if cart:
                freqs = rand(s, f_cart).abs() + 0.1
                cfg = FSWConfig(d_in=4, n_slices=s, n_freqs=f_cart,
                                enable_bias=False)
                names = ('fsw_rank_cart_fwd', 'fsw_rank_cart_bwd')
            else:
                freqs = rand(s).abs() + 0.1
                cfg = FSWConfig(d_in=4, d_out=s + 1, enable_bias=False)
                names = ('fsw_rank_fwd', 'fsw_rank_bwd')
            wg = mode == 'dw'
            Pg = P.detach().requires_grad_(True)
            wng, padg = ((wn.detach().requires_grad_(True),
                          pad.detach().requires_grad_(True)) if wg
                         else (wn, pad))
            leaves = [Pg, wng, padg] if wg else [Pg]
            label = f'{mode} B={B}'

            def run(impl, cfg=cfg, freqs=freqs, wg=wg, leaves=leaves,
                    Pg=Pg, wng=wng, padg=padg):
                out = bucket_quadrature(Pg, wng, padg, freqs, cfg, impl,
                                        weights_grad=wg)
                torch.autograd.grad(torch.sum(torch.sin(out)), leaves)

            if misfit(names, B, f_cart if cart else 1, wg) is None:
                with torch.no_grad():
                    _agree(label, bucket_quadrature(P, wn, pad, freqs, cfg,
                                                    'rank', weights_grad=wg),
                           bucket_quadrature(P, wn, pad, freqs, cfg, 'sort',
                                             weights_grad=wg))
            t_rank = _rank_ms(label, names, lambda: run('rank'), steps,
                              calls, dev, B, f_cart if cart else 1, wg)
            if t_rank == 'transient':
                transient.append(label)
                continue
            t_sort = _ms(lambda: run('sort'), steps, calls, dev)
            m = 0.0 if t_rank is None else t_sort / t_rank
            margins[mode][B] = m
            cells.append(dict(mode=mode, B=B, R=R, S=s,
                              F=f_cart if cart else 1, rank_ms=t_rank,
                              sort_ms=t_sort, margin=m))
            _log({'autotune': label, 'margin': round(m, 3),
                  'rank_ms': t_rank, 'sort_ms': t_sort})
        del P, w, wn, pad

    for D in k1_ds:
        for rho in k1_rhos:
            out = _k1_cell(D, rho, k1_nodes, k1_bucket, steps, calls, dev,
                           gen, transient)
            for mode, cell in out.items():
                cells.append(cell)
                margins[mode][(D, rho)] = cell['margin']
    return margins, transient, cells


def _k1_cell(D, rho, N, B, steps, calls, dev, gen, transient):
    """The 'k1' and 'k1_fwd' cells at feature width D and rho entries per
    node: a table of round(rho N / B) rows of width B over N nodes, laid
    out as a degree class of `graph.to_multi_table` is (each row's
    in-degree drawn from B/2 + 1 .. B, unit weights, the rest padding:
    sender 0, weight 0) with its gather order built once, as the layout
    builds it, S = 2 max(D, 64) - 1 slices, the route forced through the
    functions `fsw_embed_table` calls for it."""
    from .. import embedding as E
    from ..graph import NeighborTable
    from ..ops.gather_bwd import gather_order
    S = 2 * max(D, 64) - 1
    R = max(1, round(rho * N / B))
    cfg = E.FSWConfig(d_in=D, d_out=S, enable_bias=False)
    deg = torch.randint(B // 2 + 1, B + 1, (R, 1), generator=gen, device=dev)
    real = torch.arange(B, device=dev)[None, :] < deg
    idx = torch.randint(0, N, (R, B), generator=gen, device=dev) * real
    table = NeighborTable(idx=idx, weight=real.float(),
                          in_degrees=deg[:, 0].float(), num_nodes=N,
                          num_recipients=R, num_edges=int(real.sum()),
                          uniform_w=True, gather_order=gather_order(idx, N))
    X0 = torch.randn((N, D), generator=gen, device=dev)
    V0 = torch.randn((S, D), generator=gen, device=dev)
    X, Vt = _dyadic(X0, V0.t())
    V = Vt.t().contiguous().requires_grad_(True)
    freqs = torch.rand((S,), generator=gen, device=dev) * 4.0 + 0.1
    G = torch.randn((R, S), generator=gen, device=dev)
    _, wn, pad = E.table_weights(table.weight, cfg)
    names = ('fsw_rank_fwdp', 'fsw_rank_bwdp')

    def run(fused, bwd):
        with torch.set_grad_enabled(bwd):
            if fused:
                out = E._fused_block(E._fused_inputs(X, table, wn, pad, cfg),
                                     V, freqs, True, False)
            else:
                out = E._unfused_block(X, table, wn, pad, V, freqs, cfg,
                                       'rank', False, True)
            if bwd:
                torch.autograd.grad(out, V, G)
        return out

    label = f'D={D} rho={rho}'
    from ..ops.fsw_rank import misfit
    if misfit(names, B) is None:
        with torch.no_grad():
            _agree(f'k1 {label}', run(True, False), run(False, False))
    res = {}
    for mode in ('k1', 'k1_fwd'):
        bwd = mode == 'k1'
        t_f = _rank_ms(f'{mode} {label}', names, lambda: run(True, bwd),
                       steps, calls, dev, B)
        if t_f == 'transient':
            transient.append(f'{mode} {label}')
            continue
        t_u = _ms(lambda: run(False, bwd), steps, calls, dev)
        m = 0.0 if t_f is None else t_u / t_f
        res[mode] = dict(mode=mode, D=D, rho=R * B / N, rho_probe=rho,
                         nodes=N, slices=S, B=B, R=R, fused_ms=t_f,
                         unfused_ms=t_u, margin=m)
        _log({'autotune': f'{mode} {label}', 'margin': round(m, 3),
              'fused_ms': t_f, 'unfused_ms': t_u})
    return res


def _card_kind(dev) -> str:
    """The lower-cased name of the card (`embedding._device_kind`), or
    'cpu'."""
    if dev.type != 'cuda':
        return 'cpu'
    from ..embedding import _device_kind
    return _device_kind(dev)


def _margin_key(b) -> str:
    return f'{b[0]},{b[1]}' if isinstance(b, tuple) else str(b)


def autotune_rank_rules(write_cache: bool = True, measure_fn=None,
                        device=None) -> dict:
    """Measure the rules on the current card (`device`; None: the card)
    and (optionally) cache them under its kind.

    Returns the rules (`embedding._rank_rules`'s format): the caps and
    waste keys of `derive_rules`, K1's crossover `k1_rho0`/`k1_d0` from
    the 'k1' cells and the forward-only `k1_fwd_rho0`/`k1_fwd_d0` from the
    'k1_fwd' cells (`fit_k1_rule`), source 'autotune', the margins with
    string keys and the measured cells.  `measure_fn(device=...)` (None:
    `_measure_margins`) returns margins, (margins, transient), or
    (margins, transient, cells).  When
    any cell failed TRANSIENTLY (after one retry) the rules are still
    derived from the cells that did measure, but the cache is NOT
    written."""
    from ..device import resolve_device
    dev = resolve_device(device)
    kind = _card_kind(dev)
    out = (measure_fn or _measure_margins)(device=dev)
    if not isinstance(out, tuple):
        out = (out,)
    margins, transient, cells = (tuple(out) + ([], []))[:3]
    rules = derive_rules(margins)
    for mode, prefix in (('k1', 'k1_'), ('k1_fwd', 'k1_fwd_')):
        pts = [c for c in cells if c.get('mode') == mode]
        if pts:
            fit = fit_k1_rule(pts)
            rules[prefix + 'rho0'] = fit['k1_rho0']
            rules[prefix + 'd0'] = fit['k1_d0']
            rules[prefix + 'fit'] = fit['k1_fit']
            rules[prefix + 'misjudged'] = fit['k1_misjudged']
    rules['source'] = 'autotune'
    rules['margins'] = {m: {_margin_key(b): round(v, 3)
                            for b, v in d.items()}
                        for m, d in margins.items()}
    if cells:
        rules['cells'] = list(cells)
    if transient:
        rules['transient_failures'] = list(transient)
    if write_cache and not transient:
        _write_cache(kind, rules)
    return rules
