// Weighted-rank FSW aggregation on projected entries, backward (float32).
//
// Replaces the TPU kernel `_bwd_kernel` behind the backward `_fsw_bwd` of
// `fsw_rank_aggregate` (fsw_gnn_tpu/ops/fsw_rank_pallas.py).  Given the
// forward's inputs P (R, B, S), wn (R, B), pad (R), freqs (S) and the output
// cotangent G (R, S), it recomputes the inclusive weighted rank c exactly as
// the forward kernel does, then
//
//   dP[r,i,s] = (1 + f) g phi_i,  phi_i = (2/(pi f)) sin(pi f w_i) cos A_i,
//               A_i = pi f (2 c_i - w_i)  (exact f == 0 limit 2 w_i cos A_i)
//   df[s]     = sum_r g [ sum_i p_i phi_i + (1 + f) sum_i p_i phi_f,i ]
//   with_dw:  dwn[r,j] = sum_s (1+f) g p_j 2 cos(A_j - pi f w_j)
//                        + sum_{i,s} dc_i M_ij,   dpad[r] = sum_{i,s} dc_i [p_i > 0],
//             dc_i = (1 + f) g p_i (-4) sin(pi f w_i) sin A_i,
//             M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)].
//
// Design: K1b's steps 2, 5 and 6 (fsw_rank_bwdp.cu) with P read from the
// input instead of projected into the workspace, and dp written to the
// output; both kernels are fsw_rank_common.cuh's, the one copy K1b runs.
//   1. the entry kernel, one block per (table row, tile of 64 slices), one
//      thread per slice: its column of P, the rank loop in the order
//      j = 0 .. B-1, the trig, dP, and this row's df term to an (R, S)
//      workspace.  With with_dw it also runs the transposed-mask loop and
//      sums dwn / dpad over the block's slices into per-tile partials.
//   2. the column-sum kernel reduces the df terms over the rows (two passes
//      when R > 256) and the dwn / dpad partials over the slice tiles.
// The TPU kernel carries df from one row tile to the next of its sequential
// grid.  Here every cross-block sum is a partial reduced in a fixed order:
// no float atomics, so two calls give the same bits.
//
// Zero-weight entries (JAX pads B to a multiple of 8 with them, and
// multisets have real ones) get exactly dP = 0 and contribute nothing to
// df, dwn or dpad: see fsw_rank_common.cuh.  The uniform_w trig runs only
// without with_dw, as the TPU kernel does.
//
// What bounds it on an H100: reading P and G once and writing dP.  The
// least work a row with d real entries needs per slice is a sort (about
// d log2 d compares), a cumsum (d adds), the trig and the dp, phi_f and df
// terms (about 45 operations an entry), and with with_dw a reverse cumsum
// of dc (d adds); at the multiset path's widths (2048 rows, d = n = 100,
// S = 1000) that is about 1.1e10 operations for 1.65 GB, so the bytes bound
// it (0.49 ms).  This kernel runs the B x B rank loop instead (3 d
// operations an entry, 3 d more for the transposed loop with with_dw).  The
// entry kernel needs 4 (64 B (2 with with_dw, else 1) + B (3 with with_dw,
// else 1) + 64) bytes of shared memory: B up to 443 with with_dw, 893
// without.

#include "fsw_rank_common.cuh"

namespace {

// Workspace layout, in floats; each region starts on a 256-byte boundary.
struct Plan {
  size_t dfr, tmp, dwnp, dpadp, total;
  int n_st;
};

Plan make_plan(int R, int B, int S, int with_dw) {
  Plan p;
  p.n_st = cdiv(S, TS);
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
  return entry_smem_bytes(B, with_dw);
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
  if (p.n_st > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  float* w = (float*)ws;
  const cudaError_t e = launch_rank_bwd_entry(
      (const float*)P, (float*)dP, (const float*)wn, (const float*)pad,
      (const float*)freqs, (const float*)G, w + p.dfr, w + p.dwnp,
      w + p.dpadp, R, B, S, uniform_w, with_dw, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_entry_partials(w + p.dfr, w + p.dwnp, w + p.dpadp,
                                    (float*)df, (float*)dwn, (float*)dpad,
                                    w + p.tmp, R, B, S, with_dw, st);
}

}  // extern "C"
