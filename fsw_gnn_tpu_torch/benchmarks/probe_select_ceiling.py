"""Probe P6: the rate the rank loop's compare/select/add mix and the trig
tails reach on the card.

Counterpart of benchmarks/probe_select_ceiling.py.  Kernels that are
nothing but one loop body or one tail of the rank kernels, on one table row
of B entries a block (csrc/probe_select.cu, one template instance a body),
run as the TPU probe's `make_kernel` runs them: REP repeats of
c = body(P, wn), acc += sum_b c, P = P + 1e-30 c; out (R, S) = acc.  Per
body it prints the ms, the modeled operations per element-step (the TPU
probe's `BODIES` column), the rate in Gops/s and its share of the H100's
float32 rate (67 TFLOP/s, a fused multiply-add counted as two operations,
as the model counts it), then what the compare and select bodies compiled
to (`cuobjdump -sass` on the built library: FSETP, FSEL, FSET and the
other opcodes of each instance).  Two bodies that are not the TPU probe's,
`PIPE_BODIES`, then price one pipe each (NI = 8 chains in registers, 64
steps an element, of one FFMA or of one FSETP + FSEL): their instruction
rates, against the FFMA issue rate (half of 67 TFLOP/s), say whether
compares and selects issue as fast as fused multiply-adds.  A body that
differs from its plain version by more than 1e-5 of max |plain| on any of
the R rows raises after its line.

    python -m fsw_gnn_tpu_torch.benchmarks.probe_select_ceiling [--device cpu]

Knobs (the TPU probe's, with its defaults): FSW_PROBE_R 8192,
FSW_PROBE_B 32, FSW_PROBE_S 128, FSW_PROBE_REP 4, FSW_PROBE_ITERS 10 (the
calls a timing window), FSW_PROBE_TILE 64 (read; a block here is always
one row and 64 slices), FSW_PROBE_ONLY (a comma list of bodies).

`probe_select` runs a body's kernel on CUDA tensors (counting launches in
`probe_select.launches`) and its plain PyTorch version (`BODIES`,
the TPU probe's bodies term for term) on CPU tensors.
"""
from __future__ import annotations

import math
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..ops.fsw_rank import _check, _count, _kernel, _launch
from ..utils.bounds import PEAK_F32_OPS
from . import _timing

R = int(os.environ.get('FSW_PROBE_R', 8192))
B = int(os.environ.get('FSW_PROBE_B', 32))
S = int(os.environ.get('FSW_PROBE_S', 128))
REP = int(os.environ.get('FSW_PROBE_REP', 4))
ITERS = int(os.environ.get('FSW_PROBE_ITERS', 10))
TILE_R = int(os.environ.get('FSW_PROBE_TILE', 64))

TWO_PI = 2.0 * math.pi
S_COEF = tuple((-1.0) ** k * (2 * math.pi) ** (2 * k + 1)
               / math.factorial(2 * k + 1) for k in range(7))
MAGIC = float(1.5 * 2 ** 23)


def _f(P):
    """f = 0.7 + 0.001 s over the slices, as the probe's float32 iota."""
    s = torch.arange(P.shape[2], device=P.device, dtype=torch.int32)
    return (0.7 + 0.001 * s.to(P.dtype)).view(1, 1, -1)


def _ws(P, wn):
    return wn[:, :, None].expand_as(P)


def body_rank(P, wn, pos):
    """The JAX rank kernels' `_rank_c` loop."""
    c = torch.zeros_like(P)
    for j in range(P.shape[1]):
        pj = P[:, j:j + 1, :]
        wj = wn[:, j:j + 1][:, :, None]
        cond = (pj < P) | ((pj == P) & (pos >= j))
        c = c + torch.where(cond, wj, torch.zeros_like(P))
    return c


def body_select_add(P, wn, pos):
    c = torch.zeros_like(P)
    for j in range(P.shape[1]):
        pj = P[:, j:j + 1, :]
        wj = wn[:, j:j + 1][:, :, None]
        c = c + torch.where(pj < P, wj, torch.zeros_like(P))
    return c


def body_fma_anchor(P, wn, pos):
    c = torch.zeros_like(P)
    for j in range(P.shape[1]):
        c = c + P * wn[:, j:j + 1][:, :, None]
    return c


def _trig_r2(ws, c, f):
    """(sinc_t, cos_t, sin_t, cos_fw): sin/cos after a round-half-even
    range reduction, the per-element sinc divide."""
    u_cos = 0.5 * f * (2.0 * c - ws)
    u_cos = u_cos - torch.round(u_cos)
    ang = TWO_PI * u_cos
    sin_t, cos_t = torch.sin(ang), torch.cos(ang)
    x = f * ws
    u_sin = 0.5 * x
    u_sin = u_sin - torch.round(u_sin)
    ang2 = TWO_PI * u_sin
    sin_fw, cos_fw = torch.sin(ang2), torch.cos(ang2)
    safe = torch.where(x == 0.0, torch.ones_like(x), x)
    sinc_t = torch.where(x == 0.0, torch.ones_like(x),
                         sin_fw / (math.pi * safe))
    return sinc_t, cos_t, sin_t, cos_fw


def _bwd_arith(P, ws, c, f, sinc_t, cos_t, sin_t, cos_fw):
    g1 = 1.0 + f
    sd = 2.0 * ws * sinc_t * cos_t
    dp = g1 * sd
    dc = g1 * P * (-2.0 * TWO_PI) * f * ws * sinc_t * sin_t
    fsafe = torch.where(f == 0.0, torch.ones_like(f), f)
    phi_f = 2.0 * ws * (
        torch.where(f == 0.0, torch.zeros_like(f), (cos_fw - sinc_t) / fsafe)
        * cos_t
        - math.pi * (2.0 * c - ws) * sinc_t * sin_t)
    return dp + dc + P * sd + P * phi_f


def _tail_inputs(P, wn):
    ws = _ws(P, wn)
    return ws, 0.3 * P + ws, _f(P)


def body_fwd_tail(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    sinc_t, cos_t, _, _ = _trig_r2(ws, c, f)
    return (1.0 + f) * (P * (2.0 * ws * sinc_t * cos_t))


def body_bwd_tail(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _bwd_arith(P, ws, c, f, *_trig_r2(ws, c, f))


def _sin2pi(u):
    a = torch.abs(u)
    t = torch.minimum(a, 0.5 - a)
    t2 = t * t
    p = torch.full_like(u, S_COEF[-1])
    for coef in S_COEF[-2::-1]:
        p = p * t2 + coef
    return torch.sign(u) * (p * t)


def _sincos_poly(u):
    s = _sin2pi(u)
    uc = u + 0.25
    uc = uc - torch.round(uc)
    return s, _sin2pi(uc)


def _trig_poly(ws, c, f):
    u_cos = 0.5 * f * (2.0 * c - ws)
    u_cos = u_cos - torch.round(u_cos)
    sin_t, cos_t = _sincos_poly(u_cos)
    x = f * ws
    u_sin = 0.5 * x
    u_sin = u_sin - torch.round(u_sin)
    sin_fw, cos_fw = _sincos_poly(u_sin)
    safe = torch.where(x == 0.0, torch.ones_like(x), x)
    sinc_t = torch.where(x == 0.0, torch.ones_like(x),
                         sin_fw / (math.pi * safe))
    return sinc_t, cos_t, sin_t, cos_fw


def body_fwd_tail_poly(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    sinc_t, cos_t, _, _ = _trig_poly(ws, c, f)
    return (1.0 + f) * (P * (2.0 * ws * sinc_t * cos_t))


def body_bwd_tail_poly(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _bwd_arith(P, ws, c, f, *_trig_poly(ws, c, f))


def body_sin_only(P, wn, pos):
    return torch.sin(P)


def _wrap_magic(u):
    return u - ((u + MAGIC) - MAGIC)


def body_magic_round_only(P, wn, pos):
    return _wrap_magic(P)


def _sincos_poly_magic(u):
    return _sin2pi(u), _sin2pi(_wrap_magic(u + 0.25))


def _trig_poly_magic(ws, c, f):
    u_cos = _wrap_magic(0.5 * f * (2.0 * c - ws))
    sin_t, cos_t = _sincos_poly_magic(u_cos)
    x = f * ws
    u_sin = _wrap_magic(0.5 * x)
    sin_fw, cos_fw = _sincos_poly_magic(u_sin)
    safe = torch.where(x == 0.0, torch.ones_like(x), x)
    sinc_t = torch.where(x == 0.0, torch.ones_like(x),
                         sin_fw / (math.pi * safe))
    return sinc_t, cos_t, sin_t, cos_fw


def body_fwd_tail_poly2(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    sinc_t, cos_t, _, _ = _trig_poly_magic(ws, c, f)
    return (1.0 + f) * (P * (2.0 * ws * sinc_t * cos_t))


def body_bwd_tail_poly2(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _bwd_arith(P, ws, c, f, *_trig_poly_magic(ws, c, f))


# the JAX rank kernels' production trig (float32): `_round_wrap`,
# `_poly_quarter`, `_sincos2pi`, `_trig`, `_trig_unif`, `_freq_consts`, `_sd`

def _round_wrap(u):
    return u - torch.floor(u + 0.5)


def _poly_quarter(t):
    t2 = t * t
    p = torch.full_like(t, S_COEF[-1])
    for coef in S_COEF[-2::-1]:
        p = p * t2 + coef
    return p * t


def _sincos2pi(u):
    a = torch.abs(u)
    cos = _poly_quarter(0.25 - a)
    sin_mag = _poly_quarter(0.25 - torch.abs(a - 0.25))
    return torch.where(u < 0.0, -sin_mag, sin_mag), cos


def _trig_prod(ws, c, f):
    sin_t, cos_t = _sincos2pi(_round_wrap(0.5 * f * (2.0 * c - ws)))
    sin_fw, cos_fw = _sincos2pi(_round_wrap(0.5 * f * ws))
    return sin_fw, cos_fw, sin_t, cos_t


def _trig_unif_prod(ws, wn, c, f):
    sin_t, cos_t = _sincos2pi(_round_wrap(0.5 * f * (2.0 * c - ws)))
    wr = torch.max(wn, dim=1, keepdim=True).values[:, None, :]
    sin_r, cos_r = _sincos2pi(_round_wrap(0.5 * f * wr))
    sin_fw = torch.where(ws == 0.0, torch.zeros_like(ws),
                         sin_r.expand_as(ws))
    return sin_fw, cos_r.expand_as(ws), sin_t, cos_t


def _freq_consts(f):
    fz = f == 0.0
    fsafe = torch.where(fz, torch.ones_like(f), f)
    inv_f = torch.where(fz, torch.zeros_like(f), 1.0 / fsafe)
    return fz, (2.0 / math.pi) * inv_f, 2.0 * inv_f, (1.0 / math.pi) * inv_f


def _sd(fz, c2f, ws, sin_fw, cos_t):
    return torch.where(fz, 2.0 * ws, c2f * sin_fw) * cos_t


def _fwd_new(P, ws, f, trig):
    sin_fw, _, _, cos_t = trig
    fz, c2f, _, _ = _freq_consts(f)
    return (1.0 + f) * (P * _sd(fz, c2f, ws, sin_fw, cos_t))


def _bwd_new(P, ws, c, f, trig):
    g1 = 1.0 + f
    sin_fw, cos_fw, sin_t, cos_t = trig
    fz, c2f, inv2f, inv_pf = _freq_consts(f)
    sd = _sd(fz, c2f, ws, sin_fw, cos_t)
    dp = g1 * sd
    dc = g1 * P * (-4.0) * sin_fw * sin_t
    phi_f = inv2f * (ws * cos_fw * cos_t
                     - inv_pf * sin_fw * cos_t
                     - (2.0 * c - ws) * sin_fw * sin_t)
    return dp + dc + P * sd + P * phi_f


def body_fwd_tail_new(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _fwd_new(P, ws, f, _trig_prod(ws, c, f))


def body_bwd_tail_new(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _bwd_new(P, ws, c, f, _trig_prod(ws, c, f))


def body_fwd_tail_unif(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _fwd_new(P, ws, f, _trig_unif_prod(ws, wn, c, f))


def body_bwd_tail_unif(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _bwd_new(P, ws, c, f, _trig_unif_prod(ws, wn, c, f))


def body_round_only(P, wn, pos):
    return P - torch.round(P)


def body_floor_only(P, wn, pos):
    return P - torch.floor(P)


def body_cast_round_only(P, wn, pos):
    half = torch.where(P >= 0, 0.5, -0.5).to(P.dtype)
    return P - (P + half).to(torch.int32).to(P.dtype)


def body_floor_wrap_only(P, wn, pos):
    return P - torch.floor(P + 0.5)


def body_sincos_poly_only(P, wn, pos):
    u = P * 0.37
    u = u - torch.round(u)
    s1, c1 = _sincos_poly(u)
    v = P * 0.11 + 0.05
    v = v - torch.round(v)
    s2, c2 = _sincos_poly(v)
    return s1 * c2 + c1 * s2


def body_bwd_arith_only(P, wn, pos):
    ws, c, f = _tail_inputs(P, wn)
    return _bwd_arith(P, ws, c, f, 0.2 * c + 0.1, 0.3 * c - 0.2,
                      0.1 * c + 0.4, 0.25 * c)


# name -> (plain body, modeled operations per element-step, loop bodies run
# B steps an element): the TPU probe's table, in its order, which is also
# csrc/probe_select.cu's `Body` order
BODIES = {'fma_anchor': (body_fma_anchor, 2, True),
          'select_add': (body_select_add, 3, True),
          'rank': (body_rank, 6, True),
          'fwd_tail': (body_fwd_tail, 25, False),
          'bwd_tail': (body_bwd_tail, 60, False),
          'sin_only': (body_sin_only, 1, False),
          'round_only': (body_round_only, 2, False),
          'floor_only': (body_floor_only, 2, False),
          'sincos_poly_only': (body_sincos_poly_only, 40, False),
          'bwd_arith_only': (body_bwd_arith_only, 35, False),
          'fwd_tail_poly': (body_fwd_tail_poly, 25, False),
          'bwd_tail_poly': (body_bwd_tail_poly, 60, False),
          'magic_round_only': (body_magic_round_only, 3, False),
          'fwd_tail_poly2': (body_fwd_tail_poly2, 25, False),
          'bwd_tail_poly2': (body_bwd_tail_poly2, 60, False),
          'fwd_tail_new': (body_fwd_tail_new, 20, False),
          'bwd_tail_new': (body_bwd_tail_new, 45, False),
          'fwd_tail_unif': (body_fwd_tail_unif, 12, False),
          'bwd_tail_unif': (body_bwd_tail_unif, 37, False),
          'cast_round_only': (body_cast_round_only, 5, False),
          'floor_wrap_only': (body_floor_wrap_only, 3, False)}
BODY_NAMES = tuple(BODIES)
# the compare and select bodies, whose SASS answers what they compiled to
SELECT_BODIES = ('select_add', 'rank')


NI, PIPE_STEPS = 8, 64      # csrc/probe_select.cu's chains and steps


def _pipe(P, wn, step):
    """NI chains from P + 0.25 k - 1, PIPE_STEPS steps of `step` each,
    summed in the order k = 0 .. NI-1."""
    ws = _ws(P, wn)
    a, z = 0.5 + 0.25 * ws, ws - P
    total = None
    for k in range(NI):
        v = P + (0.25 * k - 1.0)
        for _ in range(PIPE_STEPS):
            v = step(v, a, z, ws, P)
        total = v if total is None else total + v
    return total


def body_pipe_ffma(P, wn, pos):
    return _pipe(P, wn, lambda v, a, z, ws, P: torch.addcmul(P, v, a))


def body_pipe_select(P, wn, pos):
    return _pipe(P, wn, lambda v, a, z, ws, P: torch.where(v < ws, P, z))


# name -> (plain body, SASS instructions an element): the pipe bodies,
# after the table in csrc/probe_select.cu's `Body` order
PIPE_BODIES = {'pipe_ffma': (body_pipe_ffma, PIPE_STEPS * NI),
               'pipe_select': (body_pipe_select, 2 * PIPE_STEPS * NI)}
KERNEL_BODIES = BODY_NAMES + tuple(PIPE_BODIES)
TOL_REL = 1e-5               # of max |plain|, every body


def probe_select_plain(name, P, wn, rep: int):
    """The plain version of body `name`, as `make_kernel` runs it."""
    body = (BODIES.get(name) or PIPE_BODIES[name])[0]
    pos = torch.arange(P.shape[1], device=P.device).view(1, -1, 1)
    acc = torch.zeros((P.shape[0], P.shape[2]), dtype=P.dtype,
                      device=P.device)
    for _ in range(rep):
        c = body(P, wn, pos)
        acc = acc + torch.sum(c, dim=1)
        P = P + 1e-30 * c
    return acc


def probe_select(name, P, wn, rep: int):
    """Body `name` (of KERNEL_BODIES) on P (R, B, S) and wn (R, B), `rep`
    repeats: out (R, S).  CPU tensors: the plain version.  CUDA tensors: its kernel (float32,
    contiguous), each launch adding one to `probe_select.launches`."""
    if P.device.type == 'cpu':
        return probe_select_plain(name, P, wn, rep)
    Rr, Bb, Ss = P.shape
    _check([('P', P), ('wn', wn)], {'wn': (Rr, Bb)})
    out = torch.empty((Rr, Ss), dtype=torch.float32, device=P.device)
    if Rr == 0 or Ss == 0:
        return out
    _launch('probe_select', _kernel('probe_select')[0],
            KERNEL_BODIES.index(name), P, wn, out, Rr, Bb, Ss, rep)
    _count(probe_select)
    return out


probe_select.launches = 0


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, or None."""
    found = shutil.which('cuobjdump')
    if found:
        return found
    home = Path(os.environ.get('CUDA_HOME') or '/usr/local/cuda')
    path = home / 'bin' / 'cuobjdump'
    return str(path) if path.exists() else None


_OPCODE = re.compile(
    r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)')
SASS_OPS = ('FSETP', 'FSEL', 'FSET', 'FFMA', 'FADD', 'FMUL', 'FMNMX',
            'ISETP', 'SEL', 'LDS', 'PLOP3', 'LOP3')


def sass_counts(names=SELECT_BODIES + tuple(PIPE_BODIES)) -> dict:
    """{body: {opcode: count, 'total': n}} of each named body's kernel
    instance in the built probe_select library (`cuobjdump -sass`); every
    opcode of the instance is counted, the loop and what surrounds it."""
    tool = cuobjdump()
    if tool is None:
        return {'error': 'cuobjdump not found'}
    lib = kernels._target('probe_select')
    text = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out = {}
    for name in names:
        tag = f'probe_select_kernelILi{KERNEL_BODIES.index(name)}E'
        counts, on = {}, False
        for line in text.splitlines():
            if 'Function :' in line:
                on = tag in line
                continue
            m = _OPCODE.search(line) if on else None
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        out[name] = dict({k: counts.get(k, 0) for k in SASS_OPS},
                         total=sum(counts.values()))
    return out


def main(argv=None):
    dev = _timing.parse_device(argv, __doc__.splitlines()[0])
    _timing.announce(dev, 'probe_select_ceiling')
    names = BODY_NAMES
    only = os.environ.get('FSW_PROBE_ONLY')
    if only:
        names = tuple(n for n in names if n in only.split(','))
    # the polynomial against float64 numpy on the host
    uu = np.linspace(-0.5, 0.5, 100001).astype(np.float32)
    tt = np.minimum(np.abs(uu), 0.5 - np.abs(uu)).astype(np.float32)
    p = np.full_like(tt, np.float32(S_COEF[-1]))
    for coef in S_COEF[-2::-1]:
        p = p * (tt * tt) + np.float32(coef)
    err = np.max(np.abs(np.sign(uu) * p * tt
                        - np.sin(2 * np.pi * uu.astype(np.float64))))
    _timing.emit(dev, poly_sin_max_abs_err_f32=float(err))

    gen = np.random.default_rng(0)
    P0 = torch.from_numpy(gen.standard_normal((R, B, S)).astype(
        np.float32)).to(dev)
    wn0 = torch.from_numpy(gen.random((R, B)).astype(np.float32)).to(dev)
    key = _timing.time_key(dev)
    rates = {}

    def checked(name):
        """(ms, max error against the plain version on every row, as a
        share of max |plain|)."""
        got = probe_select(name, P0, wn0, REP)
        want = probe_select_plain(name, P0, wn0, REP)
        err = float((got - want).abs().max()) / (float(want.abs().max())
                                                 or 1.0)
        ms = _timing.median_ms(lambda: probe_select(name, P0, wn0, REP), dev,
                               iters=ITERS, reps=3)
        return ms, err

    def verdict(name, err):
        if not err <= TOL_REL:
            raise RuntimeError(f'P6 body {name}: {err:.3e} of max |plain| '
                               f'from its plain version, above {TOL_REL}')

    for name in names:
        _, ops_per, loop = BODIES[name]
        ms, err = checked(name)
        el_steps = R * B * S * (B if loop else 1) * REP
        fields = {'variant': name, key: ms,
                  'modeled_ops_per_el_step': ops_per,
                  'max_rel_err_vs_plain': err}
        if dev.type == 'cuda':       # rates of the card only
            ops_s = el_steps * ops_per / (ms * 1e-3)
            rates[name] = el_steps / (ms * 1e-3)
            fields.update(el_loop_steps_per_s=rates[name],
                          gops_per_s_at_model=ops_s / 1e9,
                          of_fp32_peak=ops_s / PEAK_F32_OPS)
        _timing.emit(dev, **fields)
        verdict(name, err)
    if 'rank' in rates:
        _timing.emit(dev, summary='measured rank-loop retirement',
                     rank_el_steps_per_s=rates['rank'])
    for name, (_, instr) in PIPE_BODIES.items():
        ms, err = checked(name)
        fields = {'pipe': name, key: ms, 'instructions_per_el': instr,
                  'max_rel_err_vs_plain': err}
        if dev.type == 'cuda':
            ips = R * B * S * REP * instr / (ms * 1e-3)
            rates[name] = ips
            fields.update(instr_per_s=ips,
                          of_ffma_issue=ips / (PEAK_F32_OPS / 2))
        _timing.emit(dev, **fields)
        verdict(name, err)
    if dev.type == 'cuda':
        _timing.emit(dev, select_vs_ffma_instr_rate=rates['pipe_select']
                     / rates['pipe_ffma'], sass=sass_counts())
    return rates


if __name__ == '__main__':
    main()
