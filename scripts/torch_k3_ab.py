#!/usr/bin/env python3
"""Time the port's K3 (fsw_gnn_tpu_torch/csrc/segcumsum.cu) against an
earlier version of the same source, in turns on one card.

    git archive <commit> fsw_gnn_tpu_torch/csrc | tar -x -C chip_ab
    python3 scripts/torch_k3_ab.py \\
        --parent chip_ab/fsw_gnn_tpu_torch/csrc/segcumsum.cu

The parent's source is built with the package's nvcc flags into the
parent's directory and bound with its own C interface: the K3 of the
commits before the device-side look-back state took an epoch from the host
each call (`segcumsum_f32(v, ids, end, out, ws, capacity, rows, m,
reverse, epoch, stream)`), later ones do not; which one a source has is
read from its text.  Four cases: the flat scan of 2^24 float32 values over
segments of about 32, by ids and by mask, and the CSR call (127 rows of
the bench graph's 130944 padded edges over its mask, and over its ids).
Each is timed parent, change, change, parent (device time, CUDA events,
the median of 5 windows of 20 calls: chip_smoke.device_ms), and both
outputs must be the same bits.  Where `cuobjdump` is found, each
scan_kernel instance that both libraries have is also compared in its
SASS, the kernel's name aside (`sass_equal`).  Prints one JSON line with
the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_parent(src):
    """(library, whether its entry takes an epoch, its path)."""
    from fsw_gnn_tpu_torch import kernels
    out = os.path.join(os.path.dirname(os.path.abspath(src)),
                       'libsegcumsum_parent.so')
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', out, src],
                   check=True, capture_output=True, text=True)
    with open(src) as f:
        epoch = bool(re.search(r'int reverse,\s*unsigned epoch', f.read()))
    lib = ctypes.CDLL(out)
    fn = lib.segcumsum_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int] + ([ctypes.c_uint] if epoch else []) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.segcumsum_tiles.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.segcumsum_tiles.restype = ctypes.c_longlong
    lib.segcumsum_workspace_bytes.argtypes = [ctypes.c_longlong]
    lib.segcumsum_workspace_bytes.restype = ctypes.c_size_t
    return lib, epoch, out


def sass_by_kernel(path):
    """{scan_kernel instance's mangled template arguments: its SASS with
    names and addresses blanked} of a library, or None without
    cuobjdump."""
    from fsw_gnn_tpu_torch import kernels
    tool = shutil.which('cuobjdump') or os.path.join(
        os.path.dirname(kernels._nvcc()), 'cuobjdump')
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, '-sass', path], capture_output=True,
                          text=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            if name:
                out[name] = '\n'.join(body)
            sym = m.group(1)
            # a bool template argument (Lb1E) named as an int one (Li1E)
            name = re.sub(r'Lb(\d)E', r'Li\1E',
                          sym[sym.find('scan_kernel'):]) \
                if 'scan_kernel' in sym else None
            body = []
        elif name and re.search(r'/\*[0-9a-f]{4}\*/', line):
            body.append(re.sub(r'/\*[0-9a-f]{4}\*/|\S*scan_kernel\S*', '',
                               line).strip())
    if name:
        out[name] = '\n'.join(body)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', required=True,
                    help="the earlier segcumsum.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs an NVIDIA GPU')
    import chip_smoke as C
    import fsw_gnn_tpu_torch as T
    from fsw_gnn_tpu_torch import kernels
    from fsw_gnn_tpu_torch.ops.segcumsum import _run, segment_boundaries
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    lib, takes_epoch, parent_path = build_parent(args.parent)
    state = {'epoch': 0}
    ws_cache = {}

    def parent(values, ids, mask):
        rows, m = values.shape
        tiles = lib.segcumsum_tiles(rows, m)
        if tiles not in ws_cache:
            ws_cache[tiles] = torch.zeros(
                (lib.segcumsum_workspace_bytes(tiles),), dtype=torch.uint8,
                device=dev)
        state['epoch'] += 1
        out = torch.empty_like(values)
        rc = lib.segcumsum_f32(
            values.data_ptr(), None if ids is None else ids.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            ws_cache[tiles].data_ptr(), tiles, rows, m, 0,
            *([state['epoch']] if takes_epoch else []),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'parent K3 failed: CUDA error {rc}')
        return out

    def change(values, ids, mask):
        return _run(values, ids, mask, False)

    rng = np.random.default_rng(0)
    flat_ids = torch.from_numpy(np.sort(rng.integers(
        0, C.K3_N // 32, C.K3_N)).astype(np.int32)).to(dev)
    flat = torch.from_numpy(rng.standard_normal((1, C.K3_N))
                            .astype(np.float32)).to(dev)
    g = T.from_edge_index(C.simple_graph(0, C.N_NODES)[0], C.N_NODES)
    csr_ids = torch.from_numpy(g.dst.astype(np.int32)).to(dev)
    csr = torch.from_numpy(rng.standard_normal((127, csr_ids.shape[0]))
                           .astype(np.float32)).to(dev)
    res = {'device': smi, 'parent_takes_epoch': takes_epoch}
    m = csr_ids.shape[0]
    for label, v, ids, mask in (
            ('flat 2^24 mask', flat, None, segment_boundaries(flat_ids)),
            ('flat 2^24 ids', flat, flat_ids, None),
            (f'CSR call 127 x {m} mask', csr, None,
             segment_boundaries(csr_ids)),
            (f'CSR call 127 x {m} ids', csr, csr_ids, None)):
        if not torch.equal(parent(v, ids, mask), change(v, ids, mask)):
            sys.exit(f'{label}: the parent and the change differ')
        times = []
        for name, fn in (('parent', parent), ('change', change),
                         ('change', change), ('parent', parent)):
            ms, _ = C.device_ms(torch, lambda: fn(v, ids, mask), 20)
            times.append((name, ms))
        p_ms = float(np.mean([t for n, t in times if n == 'parent']))
        c_ms = float(np.mean([t for n, t in times if n == 'change']))
        res[label] = {'turns_ms': times, 'parent_ms': p_ms,
                      'change_ms': c_ms, 'change_over_parent': c_ms / p_ms,
                      'bit_equal': True}
    old = sass_by_kernel(parent_path)
    new = sass_by_kernel(str(kernels._target('segcumsum')))
    if old is not None and new is not None:
        res['sass_equal'] = {k: old[k] == new.get(k) for k in sorted(old)}
    print('k3 ab: ' + json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
