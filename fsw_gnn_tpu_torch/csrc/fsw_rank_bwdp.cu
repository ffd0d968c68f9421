// Fused-projection weighted-rank FSW aggregation, backward (float32).
//
// Replaces the TPU kernel `_bwdp_kernel` behind the backward `_fswp_bwd` of
// `fsw_rank_aggregate_proj` (fsw_gnn_tpu/ops/fsw_rank_pallas.py).  Given the
// forward's inputs Z (R, B, D), wn (R, B), pad (R), freqs (S), V (D, S) and
// the output cotangent G (R, S), it recomputes P = Z V and the inclusive
// weighted rank c exactly as the forward kernel does, then
//
//   dp[r,i,s] = (1 + f) g phi_i,  phi_i = (2/(pi f)) sin(pi f w_i) cos A_i,
//               A_i = pi f (2 c_i - w_i)  (exact f == 0 limit 2 w_i cos A_i)
//   dZ        = dP V^T                     (R, B, D)
//   dV        = Z^T dP, summed over every row and entry           (D, S)
//   df[s]     = sum_r g [ sum_i p_i phi_i + (1 + f) sum_i p_i phi_f,i ]
//   with_dw:  dwn[r,j] = sum_s (1+f) g p_j 2 cos(A_j - pi f w_j)
//                        + sum_{i,s} dc_i M_ij,   dpad[r] = sum_{i,s} dc_i [p_i > 0],
//             dc_i = (1 + f) g p_i (-4) sin(pi f w_i) sin A_i,
//             M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)].
//
// Design.  The TPU kernel walks a sequential grid and carries df and dV in
// its output buffers from one row tile to the next.  No CUDA grid is
// sequential, so the work is six launches on the caller's stream, every
// sum in a fixed order (two runs give the same bits; no atomics):
//   1. P = Z V: K1f's projection (`project_block`, fsw_rank_common.cuh) on
//      K1f's blocks, written to the workspace that dp takes later.  Both
//      kernels run the same 3xTF32 tensor-core product on the same row
//      tiles, so P has the forward's bits and both rank alike.
//   2. the entry kernel (`rank_bwd_entry_kernel` with one frequency), one
//      block per (table row, tile of 32 or 64 slices), up to 4 threads a
//      slice: the block's columns of P, the rank loop in the order
//      j = 0 .. B-1, the trig, then dp written over P (the block stages its
//      columns first) and this row's df term to (R, S).  With with_dw the
//      rank loop also counts each entry's position under the tie rule, the
//      transposed term is a suffix sum of dc in sorted order (O(B) a
//      slice), and the block reduces dwn / dpad over its slices into
//      per-tile partials.
//   3. dZ = dP V^T: one 64 x 64 output tile (entries x features) a block,
//      the slice axis walked in chunks, on the same tensor-core routine
//      (`tile_product`, the same split and chunk order).  Each block owns
//      its tile: no cross-block sum, and any D fits.
//   4. dV = Z^T dP: the same routine over (D, S) tiles, with the entry axis
//      split into at most 256 chunks (enough blocks to fill the card when D
//      and S are small); each chunk writes a partial (D, S).
//   5.-6. a column-sum kernel reduces the partials of dV, the (R, S) df
//      terms (two passes when R > 256) and the dwn / dpad tiles.
// The entry kernel and the column sums are fsw_rank_common.cuh's, shared
// with K2b (fsw_rank_bwd.cu), which runs steps 2, 5 and 6 on its input P.
//
// What bounds it on an H100: a row with d real entries needs at least about
// S d (6 D + log2 d + 46) float32 operations (three products of 2 D each:
// the recomputed projection, dZ and dV; a sort and a cumsum to rank; trig
// and the df, dp terms) against reading Z, V, G once and writing dZ, dV.
// The three products run on the tensor cores in 3xTF32 (three TF32
// products for each float32 one), staged by `cp.async` through a two-stage
// ring of 36 KB; the entry kernel ranks by the B x B loop (3 d operations an
// entry, one more with with_dw for the positions) and P and dp make an HBM
// round trip.  Fusing step 1 into the entry
// kernel, so that P never leaves the SM, is the next step.
//
// Padded (zero-weight) entries gather sender 0's row, which is not zero.
// Their dp must be exactly 0, or the scatter-add of dZ into dX corrupts
// sender 0: sin(pi f 0) is exactly 0 from sinpif, the uniform_w row value is
// forced to 0 there, and the f == 0 limit 2 w cos A is 0 at w = 0.  The
// uniform_w trig (cos(pi f w) holds the row value at padded entries) runs
// only without with_dw, where that cosine is always multiplied by w.
//
// Trig accuracy: f reaches 2S - 1 (5729 at S = 2865), where one float32 ulp
// of u = f (2c - w) / 2 is ~5e-4 of a period.  The phase is formed as the
// forward and the plain version form it, and reduced exactly by
// sincospif (no __sinf).

#include "fsw_rank_common.cuh"

namespace {

constexpr int FILL_BLOCKS = 264;  // 2 blocks per SM of an H100

// Workspace layout, in floats; each region starts on a 256-byte boundary.
struct Plan {
  size_t dp, dfr, tmp, dvp, dwnp, dpadp, total;
  int n_st, n_split, chunk;
};

Plan make_plan(int R, int B, int D, int S, int with_dw) {
  Plan p;
  const long long N = (long long)R * B;
  p.n_st = entry_tiles(B, S, 1, with_dw);
  const int tiles = cdiv(D, MT) * cdiv(S, NT);
  int want = cdiv(FILL_BLOCKS, tiles);
  want = want < MAX_SPLIT ? want : MAX_SPLIT;
  const int most = cdiv(N, 256);  // at least 256 entries a chunk
  want = want < most ? want : most;
  want = want > 1 ? want : 1;
  p.chunk = cdiv(cdiv(N, want), KC) * KC;
  p.n_split = cdiv(N, p.chunk);
  size_t off = 0;
  p.dp = off;    off += align64((size_t)N * S);
  p.dfr = off;   off += align64((size_t)R * S);
  p.tmp = off;   off += align64((size_t)MAX_SPLIT * S);
  p.dvp = off;   off += align64((size_t)p.n_split * D * S);
  p.dwnp = off;  off += with_dw ? align64((size_t)p.n_st * N) : 0;
  p.dpadp = off; off += with_dw ? align64((size_t)p.n_st * R) : 0;
  p.total = off;
  return p;
}

// Store one tile product's accumulators (the m16n8k8 layout, see
// tile_product) to out[(i0 + row) * ld + j0 + col] for row < ni, col < nj.
__device__ __forceinline__ void store_tile(const float (&acc)[8][4],
                                           float* out, long long ld,
                                           long long i0, int ni, int j0,
                                           int nj) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * warp + g + (q >> 1) * 8;
      const int col = 8 * j + 2 * t + (q & 1);
      if (row < ni && col < nj)
        out[(i0 + row) * ld + j0 + col] = acc[j][q];
    }
}

// Step 1: P (R * B, S) = Z V on K1f's blocks (`project_block`), so every
// element has K1f's bits.
__global__ void __launch_bounds__(MMA_THREADS)
bwdp_proj_kernel(const float* __restrict__ Z, const float* __restrict__ V,
                 float* __restrict__ P, int R, int B, int D, int S,
                 int n_st) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const int rt = proj_rows(B);
  const int s0 = (blockIdx.x % n_st) * TS;
  const int r0 = (blockIdx.x / n_st) * rt;
  const int E = min(rt, R - r0) * B;
  float* pb = P + (size_t)r0 * B * S + s0;
  project_block(Z + (size_t)r0 * B * D, V, E, D, S, s0, stage,
                [&](int e, int col, float v) { pb[(size_t)e * S + col] = v; });
}

// Step 3: dZ[n, d] = sum_s dp[n, s] V[d, s] (n over the R * B entries), one
// 64 x 64 tile a block, feature tiles first.
__global__ void __launch_bounds__(MMA_THREADS)
bwdp_dz_kernel(const float* __restrict__ dp, const float* __restrict__ V,
               float* __restrict__ dZ, long long N, int D, int S,
               int n_dt) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const int d0 = (blockIdx.x % n_dt) * NT;
  const long long n0 = (long long)(blockIdx.x / n_dt) * MT;
  const int ni = (int)min((long long)MT, N - n0);
  float acc[8][4];
  tile_product<true, true>(Operand{dp + n0 * S, S, ni},
                           Operand{V + (size_t)d0 * S, S, min(NT, D - d0)},
                           S, stage, acc);
  store_tile(acc, dZ, D, n0, ni, d0, min(NT, D - d0));
}

// Step 4: part[k, d, s] = sum over the entries n of chunk k of
// Z[n, d] dp[n, s].
__global__ void __launch_bounds__(MMA_THREADS)
bwdp_dv_kernel(const float* __restrict__ Z, const float* __restrict__ dp,
               float* __restrict__ part, long long N, int D, int S,
               int chunk) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const int s0 = blockIdx.x * NT, d0 = blockIdx.y * MT;
  const long long lo = (long long)blockIdx.z * chunk;
  const int K = (int)(min(N, lo + chunk) - lo);
  float acc[8][4];
  tile_product<false, false>(Operand{Z + lo * D + d0, D, min(MT, D - d0)},
                             Operand{dp + lo * S + s0, S, min(NT, S - s0)},
                             K, stage, acc);
  store_tile(acc, part + (size_t)blockIdx.z * D * S, S, d0,
             min(MT, D - d0), s0, min(NT, S - s0));
}

cudaError_t launch_proj(const float* Z, const float* V, float* P, int R,
                        int B, int D, int S, cudaStream_t st) {
  const int n_st = cdiv(S, TS);
  const long long blocks = (long long)cdiv(R, proj_rows(B)) * n_st;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwdp_proj_kernel<<<(unsigned)blocks, MMA_THREADS, 0, st>>>(Z, V, P, R, B,
                                                             D, S, n_st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of the entry kernel at width B.
size_t fsw_rank_bwdp_smem_bytes(int B, int with_dw) {
  return entry_smem_bytes(B, 1, with_dw);
}

// Bytes of device workspace a call at this shape needs (the caller
// allocates it; the kernels allocate nothing).
size_t fsw_rank_bwdp_workspace_bytes(int R, int B, int D, int S,
                                     int with_dw) {
  return sizeof(float) * make_plan(R, B, D, S, with_dw).total;
}

// Step 1 alone: P (R * B, S) = Z V as K1b recomputes it (R, B, D, S > 0).
int fsw_rank_bwdp_project_f32(const void* Z, const void* V, void* P, int R,
                              int B, int D, int S, void* stream) {
  return (int)launch_proj((const float*)Z, (const float*)V, (float*)P, R, B,
                          D, S, (cudaStream_t)stream);
}

// Z (R, B, D), wn (R, B), pad (R,), freqs (S,), V (D, S), G (R, S) in;
// dZ (R, B, D), df (S,), dV (D, S) out, and with with_dw dwn (R, B) and
// dpad (R,) (else they may be null); ws the workspace.  Contiguous float32
// on the current device, R, B, D, S > 0.  Launches on `stream` and returns
// the first CUDA error (0 on success); does not synchronise.
int fsw_rank_bwdp_f32(const void* Z, const void* wn, const void* pad,
                      const void* freqs, const void* V, const void* G,
                      void* dZ, void* dwn, void* dpad, void* df, void* dV,
                      void* ws, int R, int B, int D, int S, int uniform_w,
                      int with_dw, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(R, B, D, S, with_dw);
  const long long N = (long long)R * B;
  const int n_dt = cdiv(D, NT);
  if (cdiv(S, NT) > 65535 || cdiv(D, MT) > 65535 ||
      (long long)cdiv(N, MT) * n_dt > 0x7fffffffLL ||
      entry_smem_bytes(B, 1, with_dw) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  float* w = (float*)ws;
  float* dp = w + p.dp;

  cudaError_t e = launch_proj((const float*)Z, (const float*)V, dp, R, B, D,
                              S, st);
  if (e != cudaSuccess) return (int)e;

  // P in the workspace becomes dp in place
  if ((e = launch_rank_bwd_entry(
           EntryArgs{dp, dp, (const float*)wn, (const float*)pad,
                     (const float*)freqs, (const float*)G, w + p.dfr,
                     w + p.dwnp, w + p.dpadp, R, B, S, 1},
           uniform_w, with_dw, st)) != cudaSuccess)
    return (int)e;

  bwdp_dz_kernel<<<(unsigned)((long long)cdiv(N, MT) * n_dt), MMA_THREADS, 0,
                   st>>>(dp, (const float*)V, (float*)dZ, N, D, S, n_dt);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  bwdp_dv_kernel<<<dim3((unsigned)cdiv(S, NT), (unsigned)cdiv(D, MT),
                        (unsigned)p.n_split), MMA_THREADS, 0, st>>>(
      (const float*)Z, dp, w + p.dvp, N, D, S, p.chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if ((e = reduce_rows(w + p.dvp, (float*)dV, w + p.tmp, p.n_split,
                       (long long)D * S, st)) != cudaSuccess)
    return (int)e;
  return (int)reduce_entry_partials(w + p.dfr, w + p.dwnp, w + p.dpadp,
                                    (float*)df, (float*)dwn, (float*)dpad,
                                    w + p.tmp, R, B, S, p.n_st, with_dw,
                                    st);
}

}  // extern "C"
