#!/usr/bin/env python3
"""Time kernels A1 (csrc/fsw_table_sort.cu), P1 (csrc/probe_matmul.cu), P4
(csrc/probe_stage.cu) and P6 (csrc/probe_select.cu) against an earlier
version of the same sources, in turns on one card.

    git archive <commit> fsw_gnn_tpu_torch/csrc | tar -x -C chip_ab
    python3 scripts/torch_bench_kernels_ab.py \\
        --parent chip_ab/fsw_gnn_tpu_torch/csrc [--cases p4,p6]

The parent's sources of the chosen cases (`--cases`, a comma list of a1,
p1, p4, p6; all by default) are built with the package's nvcc flags into
the parent's directory and bound with the C interfaces they had before
the redesigns: `fsw_table_sort_f32(P, wn, pad, freqs, out, R, B, S,
stream)`, P1's k1 entries (`probe_matmul_{fwd,flat,dxr,dv,dv_loop}_f32`),
`probe_stage_f32` (K2f's arguments) and `probe_select_f32(body, P, wn,
out, R, B, S, rep, stream)`.  Cases, each timed parent, change, change,
parent (device time, CUDA events, the median of 5 windows:
chip_smoke.device_ms):

  A1 on bench_fused_table's graph (8192 nodes, average in-degree 16, B 64,
  S 129): the parent's P entry against the new P entry, the new gathered
  entry (P = Xp[idx] read inside the kernel) and PyTorch's gather followed
  by the new P entry; the gathered entry must give the P entry's bits,
  and both must agree with the parent within 1e-5 |ref| + 2e-5 max |ref|;
  then the sweep widths B = 256, 512, 1024 (S 128, 2^17 entries).
  P1 at K1's headline shape and Cora's layer 0, each contraction: the
  parent's k1 entry against routine 'wgmma' (its default staging:
  `pads_operand`), then 'wgmma' with the operands padded to 16-byte rows
  inside the call (pad=True, TMA) and unpadded (pad=False, cp.async for
  unaligned rows), and `torch.matmul` in float32 and in TF32 on the same
  operands.
  P4 at its script's shape (8192 x 32 x 128) and at a ragged tensor-map
  one (8192 x 32 x 300), K2f timed in the same turns (parent, change,
  K2f, K2f, change, parent); the parent, the change and K2f must give the
  same bits.
  P6's loop bodies fma_anchor, select_add and rank at its script's shape
  (R 8192, B 32, S 128, REP 4), the change within TOL_REL of max |parent|.

With P1, a torch.profiler trace of one call each of the
headline's dxr and Cora's fwd on 'wgmma', padded and not: each kernel's
device ms (the padding copy apart from the product).  With P4 or P6, the
new kernel instances' ptxas registers and spills and their SASS opcodes,
over the whole instance and a pair of the register loop.  Prints one JSON
line with the card's name and power limit (and writes it to --out when
given).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P = ctypes.c_void_p
_I = ctypes.c_int


# case -> the sources it builds
CASE_SOURCES = {'a1': ('fsw_table_sort',), 'p1': ('probe_matmul',),
                'p4': ('probe_stage', 'fsw_rank_fwd'),
                'p6': ('probe_select',)}


def build_parent(csrc, names):
    """{name: library} of the parent's named sources, built in
    parallel."""
    from fsw_gnn_tpu_torch import kernels
    procs = {}
    for name in names:
        out = os.path.join(csrc, f'lib{name}_parent.so')
        procs[name] = (out, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', out,
             os.path.join(csrc, f'{name}.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for the parent {name}:\n{log}')
        libs[name] = ctypes.CDLL(out)
    if 'fsw_table_sort' in libs:
        a1 = libs['fsw_table_sort'].fsw_table_sort_f32
        a1.argtypes, a1.restype = [_P] * 5 + [_I] * 3 + [_P], _I
    if 'probe_matmul' in libs:
        pm = libs['probe_matmul']
        for kind, n_int, ws in (('fwd', 4, False), ('flat', 3, False),
                                ('dxr', 3, False), ('dv', 3, True),
                                ('dv_loop', 4, True)):
            fn = getattr(pm, f'probe_matmul_{kind}_f32')
            fn.argtypes = [_P] * (4 if ws else 3) + [_I] * n_int + [_P]
            fn.restype = _I
        pm.probe_matmul_dv_parts.argtypes = [_I]
        pm.probe_matmul_dv_parts.restype = ctypes.c_longlong
    if 'probe_stage' in libs:
        fn = libs['probe_stage'].probe_stage_f32
        fn.argtypes, fn.restype = [_P] * 5 + [_I] * 4 + [_P], _I
    if 'probe_select' in libs:
        fn = libs['probe_select'].probe_select_f32
        fn.argtypes, fn.restype = [_I] + [_P] * 3 + [_I] * 4 + [_P], _I
    return libs


def call(torch, fn, *args):
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f'parent launch failed: CUDA error {rc}')


def turns(torch, device_ms, parent, change, n):
    """[parent, change, change, parent] device ms."""
    return [device_ms(torch, f, n)[0] for f in (parent, change, change,
                                                 parent)]


def a1_cases(torch, libs, device_ms, dev):
    from fsw_gnn_tpu_torch.benchmarks import bench_fused_table as BFT
    from fsw_gnn_tpu_torch.benchmarks.attic import fsw_table as A1
    fn = libs['fsw_table_sort'].fsw_table_sort_f32

    def parent(P, wn, pad, freqs):
        out = torch.empty((P.shape[0], P.shape[2]), device=dev)
        call(torch, fn, P, wn, pad, freqs, out, *P.shape)
        return out

    def agree(label, got, want):
        tol = 1e-5 * want.abs() + 2e-5 * want.abs().max()
        if not bool(torch.all((got - want).abs() <= tol)):
            raise RuntimeError(f'A1 {label}: the change is '
                               f'{float((got - want).abs().max()):.3e} from '
                               f'the parent')

    res = {}
    g, t, X, cfg, proj, freqs, wn, pad = BFT.setup(dev)
    with torch.no_grad():
        Xp = (X @ proj.t()).contiguous()
        idx = t.idx.to(torch.int32).contiguous()
        P = A1._gather(idx, Xp)
        new_p = A1.fsw_table_sort(P, wn, pad, freqs)
        new_g = A1.fsw_table_forward(idx, wn, pad, Xp, freqs)
        if not torch.equal(new_p, new_g):
            raise RuntimeError('A1: the gathered entry is not the P entry '
                               'bit for bit')
        agree('on the graph', new_p, parent(P, wn, pad, freqs))
        p_turns = turns(torch, device_ms,
                        lambda: parent(P, wn, pad, freqs),
                        lambda: A1.fsw_table_sort(P, wn, pad, freqs), 20)
        g_turns = turns(torch, device_ms,
                        lambda: parent(P, wn, pad, freqs),
                        lambda: A1.fsw_table_forward(idx, wn, pad, Xp,
                                                     freqs), 20)
        torch_gather_p = device_ms(torch, lambda: A1.fsw_table_sort(
            A1._gather(idx, Xp), wn, pad, freqs), 20)[0]
        res['graph'] = {
            'shape': list(P.shape),
            'turns_parent_p_entry': p_turns,
            'turns_parent_gathered_entry': g_turns,
            'parent_ms': (p_turns[0] + p_turns[3] + g_turns[0]
                          + g_turns[3]) / 4,
            'p_entry_ms': (p_turns[1] + p_turns[2]) / 2,
            'gathered_ms': (g_turns[1] + g_turns[2]) / 2,
            'torch_gather_and_p_entry_ms': torch_gather_p}
        for B in BFT.SWEEP_B:
            Pb, wb, pb, fb = BFT.sweep_inputs(B, dev)
            agree(f'at B = {B}', A1.fsw_table_sort(Pb, wb, pb, fb),
                  parent(Pb, wb, pb, fb))
            tb = turns(torch, device_ms, lambda: parent(Pb, wb, pb, fb),
                       lambda: A1.fsw_table_sort(Pb, wb, pb, fb), 5)
            res[f'B={B}'] = {'turns': tb, 'parent_ms': (tb[0] + tb[3]) / 2,
                             'p_entry_ms': (tb[1] + tb[2]) / 2}
            del Pb, wb, pb, fb
    return res


def p1_cases(torch, libs, device_ms, dev):
    from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1
    pm = libs['probe_matmul']

    def parent(kind, a, b):
        TR, B = a.shape[:2]
        D = a.shape[2] if P1.SPEC[kind][0][0] == 'Z' else b.shape[0]
        S = b.shape[-1] if kind != 'dxr' else a.shape[2]
        M = TR * B
        fn = getattr(pm, f'probe_matmul_{kind}_f32')
        if kind in ('fwd', 'flat'):
            out = torch.empty((TR, B, S), device=dev)
            call(torch, fn, a, b, out,
                 *((TR, B, D, S) if kind == 'fwd' else (M, D, S)))
        elif kind == 'dxr':
            out = torch.empty((TR, B, D), device=dev)
            call(torch, fn, a, b, out, M, D, S)
        elif kind == 'dv':
            out = torch.empty((D, S), device=dev)
            ws = torch.empty((pm.probe_matmul_dv_parts(M), D, S), device=dev)
            call(torch, fn, a, b, out, ws, M, D, S)
        else:
            out = torch.empty((D, S), device=dev)
            ws = torch.empty((B, D, S), device=dev)
            call(torch, fn, a, b, out, ws, TR, B, D, S)
        return out

    res = {}
    with torch.no_grad():
        for shape in P1.SHAPES[1:]:
            x = P1.operands(shape, dev)
            for kind in P1.KINDS:
                a, b = (x[n] for n in P1.SPEC[kind][0])
                if not torch.equal(parent(kind, a, b),
                                   P1.kernel_matmul(kind, a, b, 'k1')):
                    raise RuntimeError(f'P1 {kind}: routine k1 is not the '
                                       f'parent bit for bit')
                tk = turns(torch, device_ms, lambda: parent(kind, a, b),
                           lambda: P1.kernel_matmul(kind, a, b, 'wgmma'),
                           10)
                staged = {pad: device_ms(torch, lambda: P1.kernel_matmul(
                    kind, a, b, 'wgmma', pad=pad), 10)[0]
                    for pad in (True, False)}
                ma, mb = P1.matmul_operands(kind, x)
                mm = {}
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    mm[tf32] = device_ms(torch, lambda: torch.matmul(ma, mb),
                                         10)[0]
                torch.backends.cuda.matmul.allow_tf32 = False
                res[f'{shape[0]}/{kind}'] = {
                    'turns_parent_wgmma': tk,
                    'parent_k1_ms': (tk[0] + tk[3]) / 2,
                    'wgmma_ms': (tk[1] + tk[2]) / 2,
                    'wgmma_padded_ms': staged[True],
                    'wgmma_unpadded_ms': staged[False],
                    'pads_by_default': [P1.pads_operand(kind, n, *shape[1:])
                                        for n in P1.SPEC[kind][0]],
                    'matmul_f32_ms': mm[False], 'matmul_tf32_ms': mm[True]}
            del x, a, b
    return res


def p4_cases(torch, libs, device_ms, dev):
    """P4 against the parent's, K2f in the same turns, at the script's
    shape and a ragged tensor-map one."""
    from fsw_gnn_tpu_torch.benchmarks import probe_emit_pipeline as P4
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_aggregate
    fn = libs['probe_stage'].probe_stage_f32

    def parent(P, wn, pad, freqs):
        out = torch.empty((P.shape[0], P.shape[2]), device=dev)
        call(torch, fn, P, wn, pad, freqs, out, *P.shape, 0)
        return out

    res = {}
    with torch.no_grad():
        for S in (P4.S, 300):
            args = P4.inputs(dev, S=S)
            k2f = fsw_rank_aggregate(*args, with_dw=False)
            if not (torch.equal(parent(*args), k2f) and torch.equal(
                    P4.fsw_rank_aggregate_staged(*args), k2f)):
                raise RuntimeError(f'P4 at S = {S}: the parent, the change '
                                   f'and K2f part')
            t = [device_ms(torch, f, 20)[0] for f in (
                lambda: parent(*args),
                lambda: P4.fsw_rank_aggregate_staged(*args),
                lambda: fsw_rank_aggregate(*args, with_dw=False),
                lambda: fsw_rank_aggregate(*args, with_dw=False),
                lambda: P4.fsw_rank_aggregate_staged(*args),
                lambda: parent(*args))]
            R, B, _ = args[0].shape
            res[f'S={S}'] = {
                'shape': list(args[0].shape), 'loop': P4.stage_loop(B, S),
                'turns_parent_change_k2f_k2f_change_parent': t,
                'parent_ms': (t[0] + t[5]) / 2, 'change_ms': (t[1] + t[4]) / 2,
                'k2f_ms': (t[2] + t[3]) / 2,
                'bytes_bound_ms': P4.rank2_bound_ms(args[1], S)[0],
                'pair_floor_ms': P4.pair_floor_ms(R, B, S)}
            del args, k2f
    return res


def p6_cases(torch, libs, device_ms, dev):
    """P6's three loop bodies against the parent's at the script's
    shape."""
    import numpy as np
    from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6
    fn = libs['probe_select'].probe_select_f32

    def parent(name, P, wn):
        out = torch.empty((P.shape[0], P.shape[2]), device=dev)
        call(torch, fn, P6.KERNEL_BODIES.index(name), P, wn, out, *P.shape,
             P6.REP)
        return out

    rng = np.random.default_rng(0)
    P = torch.from_numpy(rng.standard_normal((P6.R, P6.B, P6.S)).astype(
        np.float32)).to(dev)
    wn = torch.from_numpy(rng.random((P6.R, P6.B)).astype(np.float32)).to(dev)
    res = {}
    with torch.no_grad():
        for name in P6.ISSUE_SLOTS:
            want = parent(name, P, wn)
            err = float((P6.probe_select(name, P, wn, P6.REP) - want).abs()
                        .max()) / float(want.abs().max())
            if not err <= P6.TOL_REL:
                raise RuntimeError(f'P6 {name}: {err:.3e} of max |parent| '
                                   f'from the parent')
            t = turns(torch, device_ms, lambda: parent(name, P, wn),
                      lambda: P6.probe_select(name, P, wn, P6.REP), 10)
            res[name] = {'turns_parent_change': t,
                         'parent_ms': (t[0] + t[3]) / 2,
                         'change_ms': (t[1] + t[2]) / 2,
                         'rel_err_vs_parent': err,
                         'loop': P6.loop_of(name, P6.B),
                         'issue_floor_ms': P6.issue_floor(
                             name, P6.R, P6.B, P6.S, P6.REP),
                         'shape': [P6.R, P6.B, P6.S, P6.REP]}
    return res


def instances():
    """{lib: {instance: tag}} of the register loop's kernel instances."""
    from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6
    return {'probe_select': {n: P6.instance_tag(n) for n in P6.ISSUE_SLOTS},
            'probe_stage': {
                f'{"tensor_map" if tm else "bulk"}/uniform_w={bool(u)}':
                f'probe_stage_regs_kernelILb{tm}ELb{u}EE'
                for tm in (0, 1) for u in (0, 1)}}


def compiled(libs_used):
    """ptxas' registers and spills and the SASS opcodes (whole instance,
    and a pair: over the W x W pairs of one pass of the register loop) of
    each register-loop instance of the libraries used."""
    from fsw_gnn_tpu_torch.benchmarks import probe_select_ceiling as P6
    out = {}
    for lib, tags in instances().items():
        if lib not in libs_used:
            continue
        ptx = P6.ptxas_of(lib, tags.values())
        sass = P6.sass_of(lib, tags.values())
        out[lib] = {}
        for name, tag in tags.items():
            rec = {'ptxas': ptx.get(tag)}
            if 'error' in sass:
                rec['sass'] = sass
            else:
                rec['sass'] = sass[tag]
                rec['sass_per_pair'] = {k: v / P6.REGS_W ** 2 for k, v in
                                        sass[tag].items() if v}
            out[lib][name] = rec
    return out


def p1_traces(torch, dev):
    """{case: {kernel name: device ms of one call}} from a torch.profiler
    trace of one call each: K1's headline dxr and Cora's fwd on routine
    'wgmma', padded and not (what the padding copy and the kernel take)."""
    from torch.profiler import ProfilerActivity, profile
    from fsw_gnn_tpu_torch.benchmarks import probe_kernel_matmul as P1
    out = {}
    with torch.no_grad():
        for name, kind in (('headline', 'dxr'), ('cora_layer0', 'fwd')):
            x = P1.operands(dict((s[0], s) for s in P1.SHAPES)[name], dev)
            a, b = (x[n] for n in P1.SPEC[kind][0])
            for pad in (True, False):
                P1.kernel_matmul(kind, a, b, 'wgmma', pad=pad)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    P1.kernel_matmul(kind, a, b, 'wgmma', pad=pad)
                    torch.cuda.synchronize()
                out[f'{name}/{kind}/pad={pad}'] = {
                    e.key[:60]: e.device_time_total / 1e3
                    for e in prof.key_averages() if e.device_time_total > 0}
            del x, a, b
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help="the parent's fsw_gnn_tpu_torch/csrc directory")
    ap.add_argument('--cases', default='a1,p1,p4,p6',
                    help='comma list of a1, p1, p4, p6')
    ap.add_argument('--out', help='also write the JSON line here')
    args = ap.parse_args(argv)
    cases = args.cases.split(',')
    if not set(cases) <= set(CASE_SOURCES):
        ap.error(f'--cases takes {sorted(CASE_SOURCES)}')
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('needs an NVIDIA GPU')
    from chip_smoke import device_ms
    from fsw_gnn_tpu_torch import kernels
    from fsw_gnn_tpu_torch.benchmarks import _timing
    names = sorted({n for c in cases for n in CASE_SOURCES[c]})
    kernels.build(names)
    libs = build_parent(os.path.abspath(args.parent),
                        [n for n in names if n != 'fsw_rank_fwd'])
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    line = {'card': _timing.smi_line()}
    runs = {'a1': a1_cases, 'p1': p1_cases, 'p4': p4_cases, 'p6': p6_cases}
    for case in cases:
        line[case] = runs[case](torch, libs, device_ms, dev)
    if 'p1' in cases:
        line['p1_traces'] = p1_traces(torch, dev)
    if 'p4' in cases or 'p6' in cases:
        line['compiled'] = compiled(names)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(text + '\n')


if __name__ == '__main__':
    main()
