#!/usr/bin/env python3
"""Time the port's K3 (fsw_gnn_tpu_torch/csrc/segcumsum.cu) against an
earlier version of the same source, in turns on one card.

    git archive <commit> fsw_gnn_tpu_torch/csrc | tar -x -C chip_ab
    python3 scripts/torch_k3_ab.py \\
        --parent chip_ab/fsw_gnn_tpu_torch/csrc/segcumsum.cu

The parent's source is built with the package's nvcc flags into the
parent's directory and bound with its own C interface: the K3 of the
commit before the device-side look-back state took an epoch from the host
each call (`segcumsum_f32(v, ids, end, out, ws, capacity, rows, m,
reverse, epoch, stream)`).  Two shapes: the flat scan of 2^24 float32
values over a mask of segments of about 32, and the CSR call (127 rows of
the bench graph's 130944 padded edges over its mask).  Each is timed
parent, change, change, parent (device time, CUDA events, the median of
5 windows of 20 calls: chip_smoke.device_ms), and both outputs must be the
same bits.  Prints one JSON line with the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_parent(src):
    from fsw_gnn_tpu_torch import kernels
    out = os.path.join(os.path.dirname(os.path.abspath(src)),
                       'libsegcumsum_parent.so')
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    fn = lib.segcumsum_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.segcumsum_tiles.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.segcumsum_tiles.restype = ctypes.c_longlong
    lib.segcumsum_workspace_bytes.argtypes = [ctypes.c_longlong]
    lib.segcumsum_workspace_bytes.restype = ctypes.c_size_t
    return lib


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
    from fsw_gnn_tpu_torch.ops.segcumsum import _run, segment_boundaries
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    lib = build_parent(args.parent)
    state = {'epoch': 0}
    ws_cache = {}

    def parent(values, mask):
        rows, m = values.shape
        tiles = lib.segcumsum_tiles(rows, m)
        if tiles not in ws_cache:
            ws_cache[tiles] = torch.zeros(
                (lib.segcumsum_workspace_bytes(tiles),), dtype=torch.uint8,
                device=dev)
        state['epoch'] += 1
        out = torch.empty_like(values)
        rc = lib.segcumsum_f32(
            values.data_ptr(), None, mask.data_ptr(), out.data_ptr(),
            ws_cache[tiles].data_ptr(), tiles, rows, m, 0, state['epoch'],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'parent K3 failed: CUDA error {rc}')
        return out

    def change(values, mask):
        return _run(values, None, mask, False)

    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, C.K3_N // 32, C.K3_N)).astype(np.int32)
    flat_mask = segment_boundaries(torch.from_numpy(ids).to(dev))
    flat = torch.from_numpy(rng.standard_normal((1, C.K3_N))
                            .astype(np.float32)).to(dev)
    g = T.from_edge_index(C.simple_graph(0, C.N_NODES)[0], C.N_NODES)
    csr_mask = segment_boundaries(torch.from_numpy(g.dst).to(dev))
    csr = torch.from_numpy(rng.standard_normal((127, csr_mask.shape[0]))
                           .astype(np.float32)).to(dev)
    res = {'device': smi}
    for label, v, mask in (('flat 2^24', flat, flat_mask),
                           ('CSR call 127 x %d' % csr_mask.shape[0], csr,
                            csr_mask)):
        if not torch.equal(parent(v, mask), change(v, mask)):
            sys.exit(f'{label}: the parent and the change differ')
        times = []
        for name, fn in (('parent', parent), ('change', change),
                         ('change', change), ('parent', parent)):
            ms, _ = C.device_ms(torch, lambda: fn(v, mask), 20)
            times.append((name, ms))
        res[label] = {
            'turns_ms': times,
            'parent_ms': float(np.mean([t for n, t in times
                                        if n == 'parent'])),
            'change_ms': float(np.mean([t for n, t in times
                                        if n == 'change'])),
            'bit_equal': True}
    print('k3 ab: ' + json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
