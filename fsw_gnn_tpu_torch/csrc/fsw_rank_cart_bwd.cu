// Cartesian-mode weighted-rank FSW aggregation, backward (float32).
//
// Replaces the TPU kernels `_bwdc_kernel` (fsw_gnn_tpu/ops/
// fsw_rank_pallas.py:897) and `_mask_consume_kernel` (:966) behind the
// backward `_fswc_bwd` (:1102) of `fsw_rank_aggregate_cart`.  Given the
// forward's inputs P (R, B, S), wn (R, B), pad (R), freqs F (S, NF) and the
// output cotangent G (R, S, NF), it recomputes the inclusive weighted rank c
// exactly as the forward kernel does, then, with f = F[s, k], g = G[r, s, k],
// A_i = pi f (2 c_i - w_i) and phi_i = (2/(pi f)) sin(pi f w_i) cos A_i
// (the exact f == 0 limit 2 w_i cos A_i):
//
//   dP[r,i,s] = sum_k (1 + f) g phi_i
//   df[s,k]   = sum_r g [ sum_i p_i phi_i + (1 + f) sum_i p_i phi_f,i ]
//   with_dw:  dc_i     = sum_k (1 + f) g p_i (-4) sin(pi f w_i) sin A_i,
//             dwn[r,j] = sum_{s,k} (1+f) g p_j 2 cos(A_j - pi f w_j)
//                        + sum_{i,s} dc_i M_ij,
//             dpad[r]  = sum_{i,s} dc_i [p_i > 0],
//             M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)].
//
// Design: K2b's entry kernel (`rank_bwd_entry_kernel`, fsw_rank_common.cuh)
// with a frequency loop inside the entry loop, then the column sums:
//   1. one block per (table row, tile of 32 or 64 slices); the block stages
//      the row's P columns as [b][slice] and the tile's frequencies and
//      cotangents (a contiguous run of tsb NF floats each) as [k][slice].
//      At NF = 8 (the paths' count) and 1 the instance keeps each slice's q
//      and qf sums of every frequency in registers and splits a slice's
//      entries over up to 4 threads, which fold their sums into the shared
//      [k][slice] arrays once; at other NF one thread a slice accumulates
//      them in shared memory.  Each thread ranks its entries once (NI = 8 a
//      pass, with their positions under the tie rule when with_dw), and for
//      each entry loops over the NF frequencies, summing dp (written once),
//      dc and the direct dwn term in registers.  With with_dw the
//      transposed term is a suffix sum of dc in each slice's sorted order,
//      read at each entry's position, in the same kernel: the TPU split it
//      into a second kernel, with dc through HBM, only because Mosaic took
//      over 40 minutes to compile the two loops together.  The df terms of
//      the row go to an (R, S NF) workspace, written coalesced.
//   2. the column-sum kernel reduces the df terms over the rows (two passes
//      when R > 256) and the dwn / dpad partials over the slice tiles.
// Every cross-block sum is a partial reduced in a fixed order: no float
// atomics, so two calls give the same bits.
//
// Zero-weight entries get exactly dP = 0 and contribute nothing to df, to
// dpad or to another entry's dwn: see fsw_rank_common.cuh.  The uniform_w
// trig runs only without with_dw, as the TPU kernel does.
//
// What bounds it on an H100: the trig.  The least work a row with d real
// entries needs per slice is a sort (about d log2 d compares), a cumsum
// (d adds), and per entry and frequency the two sincospi and the dp, phi_f
// and df terms (about 45 NF d operations), with with_dw a reverse cumsum
// of dc (d adds); at the JAX package's cartesian benchmark shape (8192 rows,
// B = 32 with a fifth of the weights zero, S = 128, NF = 8) that is 9.8e9
// operations (0.147 ms) against 302 MB (0.090 ms).  The previous design
// held P and dc as two B x 64 columns beside five NF x 64 arrays that every
// (entry, frequency) read and wrote, one thread a slice: 4 warps an SM at
// B = 128.  This one holds 10 bytes an entry-slice with with_dw (4
// without), q and qf in registers: B up to 691 with with_dw at NF = 8,
// 1706 without.

#include "fsw_rank_common.cuh"

namespace {

// Workspace layout, in floats; each region starts on a 256-byte boundary.
struct Plan {
  size_t dfr, tmp, dwnp, dpadp, total;
  int n_st;
};

Plan make_plan(int R, int B, int S, int NF, int with_dw) {
  Plan p;
  p.n_st = entry_tiles(B, S, NF, with_dw);
  size_t off = 0;
  p.dfr = off;   off += align64((size_t)R * S * NF);
  p.tmp = off;   off += align64((size_t)MAX_SPLIT * S * NF);
  p.dwnp = off;  off += with_dw ? align64((size_t)p.n_st * R * B) : 0;
  p.dpadp = off; off += with_dw ? align64((size_t)p.n_st * R) : 0;
  p.total = off;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of the entry kernel at width B with NF
// frequencies; without with_dw it holds the uniform-weight trig's arrays
// whether uniform_w is set or not.
size_t fsw_rank_cart_bwd_smem_bytes(int B, int NF, int with_dw,
                                    int uniform_w) {
  (void)uniform_w;
  return entry_smem_bytes(B, NF, with_dw);
}

// Bytes of device workspace a call at this shape needs (the caller
// allocates it; the kernels allocate nothing).
size_t fsw_rank_cart_bwd_workspace_bytes(int R, int B, int S, int NF,
                                         int with_dw) {
  return sizeof(float) * make_plan(R, B, S, NF, with_dw).total;
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S, NF), G (R, S, NF) in;
// dP (R, B, S), df (S, NF) out, and with with_dw dwn (R, B) and dpad (R,)
// (else they may be null); ws the workspace.  Contiguous float32 on the
// current device, R, B, S, NF > 0.  Launches on `stream` and returns the
// first CUDA error (0 on success); does not synchronise.
int fsw_rank_cart_bwd_f32(const void* P, const void* wn, const void* pad,
                          const void* freqs, const void* G, void* dP,
                          void* dwn, void* dpad, void* df, void* ws, int R,
                          int B, int S, int NF, int uniform_w, int with_dw,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(R, B, S, NF, with_dw);
  float* w = (float*)ws;
  const cudaError_t e = launch_rank_bwd_entry(
      EntryArgs{(const float*)P, (float*)dP, (const float*)wn,
                (const float*)pad, (const float*)freqs, (const float*)G,
                w + p.dfr, w + p.dwnp, w + p.dpadp, R, B, S, NF},
      uniform_w, with_dw, st);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_entry_partials(w + p.dfr, w + p.dwnp, w + p.dpadp,
                                    (float*)df, (float*)dwn, (float*)dpad,
                                    w + p.tmp, R, B, (long long)S * NF,
                                    p.n_st, with_dw, st);
}

}  // extern "C"
