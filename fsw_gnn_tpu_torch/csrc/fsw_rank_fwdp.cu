// Fused-projection weighted-rank FSW aggregation, forward (float32).
//
// Replaces the TPU kernel `_fwdp_kernel` behind `fsw_rank_aggregate_proj`
// (fsw_gnn_tpu/ops/fsw_rank_pallas.py).  For every table row r and slice s:
//
//   P[b]   = sum_d Z[r, b, d] * V[d, s]                      (projection)
//   c[i]   = sum_j wn[r, j] * 1[P[j] < P[i] or (P[j] == P[i] and j <= i)]
//   c[i]  += pad[r] * 1[P[i] > 0]                           (phantom mass)
//   out    = (1 + f) * sum_i P[i] * sd_i,
//   sd_i   = (2 / (pi f)) sin(pi f wn_i) cos(pi f (2 c_i - wn_i)),
//            with the exact f == 0 limit 2 wn_i cos(...).
//
// c is the inclusive cumsum of the weights in stable-sorted projection
// order, without a sort.  It is summed in the order j = 0 .. B-1, as
// `_rank_c` does, so it agrees with the plain version to the bit wherever
// the projections agree.
//
// Design: one block of 128 threads per (tile of table rows, tile of TS = 64
// slices).  The tile holds proj_rows(B) rows (8 at B = 8, so at least 64
// entries up to B = 64; one row above), and the block projects its entries
// onto its slices as one product on the tensor cores (`project_block`,
// fsw_rank_common.cuh: 3xTF32 `mma.sync`, Z and V staged by `cp.async` in
// chunks of 32 features through a two-stage ring; V's chunk serves every
// row of the tile).  The projections go into shared memory laid out
// [entry][slice], so each (row, slice) pair's column is the [b][thread]
// layout that the rank loop and the quadrature read (`rank_fwd_slice`,
// shared with K2f, which also holds the notes on trig accuracy and
// padding); the block's threads take the tile's rows x 64 pairs in turn.
// Shared memory is the staging ring (36 KB), which the tile's projections
// and weights (4 (65 rows B) bytes) reuse when they fit in one pass of 64
// entries (every B <= 64) and sit beside above, whatever the feature width
// D: B up to 752.
// Nothing crosses blocks, so there are no atomics.  Blocks are numbered
// slice tile first, so the blocks that read one tile of Z run together and
// Z comes from device memory about once; V stays in L2.
//
// What bounds it on an H100: per entry-slice 2 D operations for the
// projection, a sort and a cumsum's worth of ranking (log2 B + 1) and a trig
// tail, against reading Z once and writing the (R, S) output.  The
// projection is a product of (R B) x D by D x S, so it runs on the tensor
// cores; 3xTF32 costs three TF32 products (495 TFLOP/s dense) for each
// float32 one.  The rank loop (`rank_core`: about 2.5 B instructions an
// entry, no sort) and the trig stay on the float32 units.  With WRITE_P the
// kernel stores the projections to P (R B, S) instead of ranking them: the
// check that K1b's step 1 gets K1f's bits.

#include "fsw_rank_common.cuh"

namespace {

template <bool WRITE_P>
__global__ void __launch_bounds__(MMA_THREADS)
fsw_rank_fwdp_kernel(const float* __restrict__ Z, const float* __restrict__ wn,
                     const float* __restrict__ pad,
                     const float* __restrict__ freqs,
                     const float* __restrict__ V, float* __restrict__ out,
                     int R, int B, int D, int S, int n_st, int uniform_w) {
  extern __shared__ __align__(16) float smem[];
  const int rt = proj_rows(B);
  float* stage = smem;                       // the staging ring
  // [rt * B][TS] projections, then [rt * B] weights: over the ring when
  // the block projects in one pass (see fwdp_smem_bytes)
  float* p_sm = rt * B <= MT ? smem : smem + STAGE_FLOATS;
  float* w_sm = p_sm + (size_t)rt * B * TS;

  const int st = blockIdx.x % n_st;
  const int r0 = (blockIdx.x / n_st) * rt;
  const int rows = min(rt, R - r0);
  const int E = rows * B;
  const int s0 = st * TS;
  const int tid = threadIdx.x;

  project_block(Z + (size_t)r0 * B * D, V, E, D, S, s0, stage,
                [&](int e, int col, float v) { p_sm[e * TS + col] = v; });
  if constexpr (!WRITE_P) {
    for (int e = tid; e < E; e += MMA_THREADS)
      w_sm[e] = wn[(size_t)r0 * B + e];
  }
  __syncthreads();
  const int ns = min(TS, S - s0);
  if constexpr (WRITE_P) {
    for (int k = tid; k < E * TS; k += MMA_THREADS) {
      const int e = k / TS, col = k % TS;
      if (col < ns) out[((size_t)r0 * B + e) * S + s0 + col] = p_sm[k];
    }
  } else {
    for (int k = tid; k < rows * TS; k += MMA_THREADS) {
      const int rr = k / TS, col = k % TS;
      if (col >= ns) continue;
      const int s = s0 + col;
      out[(size_t)(r0 + rr) * S + s] =
          rank_fwd_slice(p_sm + (size_t)rr * B * TS, w_sm + rr * B, B, col,
                         freqs[s], pad[r0 + rr], uniform_w);
    }
  }
}

template <bool WRITE_P>
cudaError_t launch_fwdp(const float* Z, const float* wn, const float* pad,
                        const float* freqs, const float* V, float* out, int R,
                        int B, int D, int S, int uniform_w,
                        cudaStream_t stream) {
  const size_t smem = fwdp_smem_bytes(B);
  const int n_st = cdiv(S, TS);
  const long long blocks = (long long)cdiv(R, proj_rows(B)) * n_st;
  if (smem > SMEM_LIMIT || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      fsw_rank_fwdp_kernel<WRITE_P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fsw_rank_fwdp_kernel<WRITE_P><<<(unsigned)blocks, MMA_THREADS, smem,
                                  stream>>>(Z, wn, pad, freqs, V, out, R, B,
                                            D, S, n_st, uniform_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at width B needs (at any
// feature width D).
size_t fsw_rank_fwdp_smem_bytes(int B) { return fwdp_smem_bytes(B); }

// Z (R, B, D), wn (R, B), pad (R,), freqs (S,), V (D, S), out (R, S):
// contiguous float32 on the current device, R, B, S > 0.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int fsw_rank_fwdp_f32(const void* Z, const void* wn, const void* pad,
                      const void* freqs, const void* V, void* out, int R,
                      int B, int D, int S, int uniform_w, void* stream) {
  return (int)launch_fwdp<false>(
      (const float*)Z, (const float*)wn, (const float*)pad,
      (const float*)freqs, (const float*)V, (float*)out, R, B, D, S,
      uniform_w, (cudaStream_t)stream);
}

// The same kernel up to its projection, which it writes to P (R * B, S)
// instead of ranking it: P as K1f ranks it, bit for bit.
int fsw_rank_fwdp_project_f32(const void* Z, const void* V, void* P, int R,
                              int B, int D, int S, void* stream) {
  return (int)launch_fwdp<true>((const float*)Z, nullptr, nullptr, nullptr,
                                (const float*)V, (float*)P, R, B, D, S, 0,
                                (cudaStream_t)stream);
}

}  // extern "C"
