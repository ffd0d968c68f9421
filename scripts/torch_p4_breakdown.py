#!/usr/bin/env python3
"""Where P4's time goes on the card (csrc/probe_stage.cu, rows of B <= 32):
cut-out and alternative builds of its register path, each timed in turns
with K2f.

    python3 scripts/torch_p4_breakdown.py [--out FILE]

Each variant is the package's csrc/probe_stage.cu with one edit, built by
nvcc with the package's flags into the git-ignored chip_ab/p4_breakdown/
and bound by its C interface (`probe_stage_f32`):

  as_built                 the source as it stands;
  no_rank                  c = p w in place of the register rank loop;
  no_quadrature            out = (1 + f) sum c in place of the trig;
  staging_only             both cuts: the ring, the copies and the stores;
  branch_an_entry          the quadrature as a loop over B with a branch
                           on each entry's weight, not unrolled;
  unrolled_from_registers  the quadrature unrolled over the 32 entries
                           from the registers p, w and c (the terms of
                           zero weight selected away);
  tiles_128                the tensor map's tiles 128 slices wide, not 64.

Inputs (`probe_emit_pipeline.inputs`, seed 0): the probe's 8192 x 32 x 128
(one bulk copy a row); 8192 x 32 x 300 (the tensor map, a ragged last
tile); and the probe's rows with entries 20 .. 31 at weight 0 (a table's
padding at the end of each row).  Each variant is timed K2f, variant,
variant, K2f (chip_smoke.device_ms: CUDA events, the median of 5 windows
of 20 calls); those that compute P4's function must give K2f's bits.
Prints one JSON line with the card's name and power limit, and each
variant's ptxas registers and spills.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, 'fsw_gnn_tpu_torch', 'csrc')
BUILD = os.path.join(ROOT, 'chip_ab', 'p4_breakdown')

QUAD = '''#pragma unroll 4
    for (int i = 0; i < end; ++i) {
      const float wi = w_sm[i];
      const float t = fmaf(p_sm[i * ld + tid],
                           fwd_sd(z, wi, c_sm[i * NT + tid], UNIF), acc);
      acc = wi != 0.f ? t : acc;
    }'''
RANK = '    rank_regs::rank(p, w, c);\n'
TILE = 'constexpr int TILE = 64;'
EDITS = {
    'no_rank': [(RANK, '''#pragma unroll
    for (int i = 0; i < W; ++i) c[i] = p[i] * w[i];
''')],
    'no_quadrature': [(QUAD, '''    for (int i = 0; i < end; ++i) acc += c_sm[i * NT + tid];''')],
    'branch_an_entry': [(QUAD, '''#pragma unroll 1
    for (int i = 0; i < B; ++i) {
      const float wi = w_sm[i];
      if (wi != 0.f)
        acc = fmaf(p_sm[i * ld + tid],
                   fwd_sd(z, wi, c_sm[i * NT + tid], UNIF), acc);
    }''')],
    'unrolled_from_registers': [(QUAD, '''#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float t = fmaf(p[i], fwd_sd(z, w[i], c[i] + ((p[i] > 0.f) ? pr
                                                                : 0.f),
                                        UNIF), acc);
      acc = w[i] != 0.f ? t : acc;
    }''')],
    'tiles_128': [(TILE, 'constexpr int TILE = 128;')],
}
EDITS['staging_only'] = EDITS['no_rank'] + EDITS['no_quadrature']
SAME_FUNCTION = ('as_built', 'branch_an_entry', 'unrolled_from_registers',
                 'tiles_128')


def sources():
    """{variant: source text}; every edit must apply to the source as it
    stands."""
    base = open(os.path.join(CSRC, 'probe_stage.cu')).read()
    out = {'as_built': base}
    for name, edits in EDITS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f'{name}: the source no longer holds the '
                                   f'text this variant edits')
            src = src.replace(old, new)
        out[name] = src
    return out


def build(srcs):
    """{variant: (library, registers, spill bytes)}, nvcc in parallel."""
    from fsw_gnn_tpu_torch import kernels
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = os.path.join(BUILD, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(src)
        so = os.path.join(BUILD, f'lib{name}.so')
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-I', CSRC, '-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log[-4000:]}')
        regs = spill = None
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if ('Compiling entry' in line
                    and 'probe_stage_regs_kernelILb0ELb0EE' in line):
                for nxt in lines[i + 1:i + 4]:
                    m = re.search(r'(\d+) bytes spill stores', nxt)
                    spill = int(m.group(1)) if m else spill
                    m = re.search(r'Used (\d+) registers', nxt)
                    regs = int(m.group(1)) if m else regs
        lib = ctypes.CDLL(so)
        lib.probe_stage_f32.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
        lib.probe_stage_f32.restype = ctypes.c_int
        out[name] = (lib, regs, spill)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', help='also write the JSON line here')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('needs an NVIDIA GPU')
    from chip_smoke import device_ms
    from fsw_gnn_tpu_torch import kernels
    from fsw_gnn_tpu_torch.benchmarks import _timing
    from fsw_gnn_tpu_torch.benchmarks import probe_emit_pipeline as P4
    from fsw_gnn_tpu_torch.ops.fsw_rank import fsw_rank_aggregate
    kernels.build(['fsw_rank_fwd'])
    libs = build(sources())
    dev = torch.device('cuda')
    cases = {}
    for label, S, real in (('probe', 128, 32), ('ragged_tensor_map', 300, 32),
                           ('padded_20_of_32', 128, 20)):
        x = list(P4.inputs(dev, S=S))
        x[1][:, real:] = 0.0
        k2f = lambda: fsw_rank_aggregate(*x, with_dw=False)  # noqa: E731
        want = k2f()
        row = {'shape': list(x[0].shape), 'real_entries': real}
        for name, (lib, _, _) in libs.items():
            def run(lib=lib):
                out = torch.empty((x[0].shape[0], S), device=dev)
                rc = lib.probe_stage_f32(
                    *(a.data_ptr() for a in x), out.data_ptr(),
                    *x[0].shape, 0, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f'{name}: CUDA error {rc}')
                return out
            same = bool(torch.equal(run(), want))
            if name in SAME_FUNCTION and not same:
                raise RuntimeError(f'{name} at {label}: not K2f bit for bit')
            t = [device_ms(torch, f, 20)[0] for f in (k2f, run, run, k2f)]
            row[name] = {'turns_k2f_variant_variant_k2f': t,
                         'variant_ms': (t[1] + t[2]) / 2,
                         'k2f_ms': (t[0] + t[3]) / 2, 'k2f_bits': same}
        cases[label] = row
        del x, want
    line = {'card': _timing.smi_line(),
            'ptxas': {n: {'registers': r, 'spill_store_bytes': s}
                      for n, (_, r, s) in libs.items()},
            'cases': cases}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(text + '\n')


if __name__ == '__main__':
    main()
