// Weighted-rank FSW aggregation on projected entries, backward (float32).
//
// Replaces the TPU kernel `_bwd_kernel` (fsw_gnn_tpu/ops/fsw_rank_pallas.py
// :292) behind the backward `_fsw_bwd` (:509) of `fsw_rank_aggregate`.
// Given the forward's inputs P (R, B, S), wn (R, B), pad (R), freqs (S) and
// the output cotangent G (R, S), it recomputes the inclusive weighted rank c
// exactly as the forward kernel does (the same sums in the same order, so
// the gradient is that of the function the forward computed), then
//
//   dP[r,i,s] = (1 + f) g phi_i,  phi_i = (2/(pi f)) sin(pi f w_i) cos A_i,
//               A_i = pi f (2 c_i - w_i)  (exact f == 0 limit 2 w_i cos A_i)
//   df[s]     = sum_r g [ sum_i p_i phi_i + (1 + f) sum_i p_i phi_f,i ]
//   with_dw:  dwn[r,j] = sum_s (1+f) g p_j 2 cos(A_j - pi f w_j)
//                        + sum_{i,s} dc_i M_ij,   dpad[r] = sum_{i,s} dc_i [p_i > 0],
//             dc_i = (1 + f) g p_i (-4) sin(pi f w_i) sin A_i,
//             M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)].
//
// Design: two steps on the caller's stream, both fsw_rank_common.cuh's (K1b,
// fsw_rank_bwdp.cu, runs them on the P it projects):
//   1. the entry kernel (`rank_bwd_entry_kernel` with one frequency), one
//      block per (table row, tile of 32 or 64 slices), up to 4 threads a
//      slice, each ranking its groups of 8 entries against the column in
//      shared memory: the rank loop in the order j = 0 .. B-1, the trig, dP,
//      and this row's df term to an (R, S) workspace.  With with_dw the rank
//      loop also counts each entry's position under the tie rule of M, so
//      the transposed term sum_i dc_i M_ij is a suffix sum of dc in sorted
//      order read at j's position (O(B) a slice, not B^2), and the block
//      sums dwn / dpad over its slices into per-tile partials.
//   2. the column-sum kernel reduces the df terms over the rows (two passes
//      when R > 256) and the dwn / dpad partials over the slice tiles.
// The TPU kernel carries df from one row tile to the next of its sequential
// grid.  Here every cross-block sum is a partial reduced in a fixed order:
// no float atomics, so two calls give the same bits.
//
// Zero-weight entries (JAX pads B to a multiple of 8 with them, and
// multisets have real ones) get exactly dP = 0 and contribute nothing to
// df, dpad or another entry's dwn: see fsw_rank_common.cuh.  The uniform_w
// trig runs only without with_dw, as the TPU kernel does.
//
// What bounds it on an H100: reading P and G once and writing dP.  The
// least work a row with d real entries needs per slice is a sort (about
// d log2 d compares), a cumsum (d adds), the trig and the dp, phi_f and df
// terms (about 45 operations an entry), and with with_dw a reverse cumsum
// of dc (d adds); at the multiset path's widths (2048 rows, d = n = 100,
// S = 1000) that is about 1.1e10 operations for 1.65 GB, so the bytes bound
// it (0.49 ms).  This kernel ranks by the B x B loop instead: a compare
// to 0/1 and a fused multiply-add a pair, one add more with with_dw for the
// positions that replace the previous design's second B x B loop (about 3
// d^2 operations a slice with with_dw, the previous design's about 6 d^2).
// The previous design ran one thread a slice and held P and dc as two
// B x 64 columns, 8 warps an SM at B = 100 with with_dw; this one holds 10
// bytes an entry-slice (4 without with_dw), 4 threads a slice from B = 25
// on with with_dw (see `entry_shape`): 24 warps an SM at B = 100, and B up
// to 705 with with_dw, 1754 without.

#include "fsw_rank_common.cuh"

namespace {

// Workspace layout, in floats; each region starts on a 256-byte boundary.
struct Plan {
  size_t dfr, tmp, dwnp, dpadp, total;
  int n_st;
};

Plan make_plan(int R, int B, int S, int with_dw) {
  Plan p;
  p.n_st = entry_tiles(B, S, 1, with_dw);
  size_t off = 0;
  p.dfr = off;   off += align64((size_t)R * S);
  p.tmp = off;   off += align64((size_t)MAX_SPLIT * S);
  p.dwnp = off;  off += with_dw ? align64((size_t)p.n_st * R * B) : 0;
  p.dpadp = off; off += with_dw ? align64((size_t)p.n_st * R) : 0;
  p.total = off;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of the entry kernel at width B.
size_t fsw_rank_bwd_smem_bytes(int B, int with_dw) {
  return entry_smem_bytes(B, 1, with_dw);
}

// Bytes of device workspace a call at this shape needs (the caller
// allocates it; the kernels allocate nothing).
size_t fsw_rank_bwd_workspace_bytes(int R, int B, int S, int with_dw) {
  return sizeof(float) * make_plan(R, B, S, with_dw).total;
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S,), G (R, S) in; dP (R, B, S),
// df (S,) out, and with with_dw dwn (R, B) and dpad (R,) (else they may be
// null); ws the workspace.  Contiguous float32 on the current device,
// R, B, S > 0.  Launches on `stream` and returns the first CUDA error (0 on
// success); does not synchronise.
int fsw_rank_bwd_f32(const void* P, const void* wn, const void* pad,
                     const void* freqs, const void* G, void* dP, void* dwn,
                     void* dpad, void* df, void* ws, int R, int B, int S,
                     int uniform_w, int with_dw, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(R, B, S, with_dw);
  float* w = (float*)ws;
  const cudaError_t e = launch_rank_bwd_entry(
      EntryArgs{(const float*)P, (float*)dP, (const float*)wn,
                (const float*)pad, (const float*)freqs, (const float*)G,
                w + p.dfr, w + p.dwnp, w + p.dpadp, R, B, S, 1},
      uniform_w, with_dw, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_entry_partials(w + p.dfr, w + p.dwnp, w + p.dpadp,
                                    (float*)df, (float*)dwn, (float*)dpad,
                                    w + p.tmp, R, B, S, p.n_st, with_dw, st);
}

}  // extern "C"
