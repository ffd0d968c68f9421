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
// Design: one block per (table row, tile of TS slices), one thread per
// slice.  The block stages BC rows of Z[r] at a time in shared memory; each
// thread projects them onto its own slice with sequential full-float32 FMAs
// (no TF32, no tensor cores) and keeps its column of P in shared memory,
// laid out [b][thread] so a warp's accesses fall on consecutive banks.  The
// B x B rank loop and the quadrature then run per thread out of shared
// memory (`rank_fwd_slice` in fsw_rank_common.cuh, shared with K2f, which
// also holds the notes on trig accuracy and padding).  Nothing crosses
// blocks, so there are no atomics.
//
// What bounds it on an H100: per entry-slice about 2D float32 operations
// for the projection, a sort and a cumsum's worth of ranking (log2 B + 1)
// and a trig tail, against reading Z once and writing the (R, S) output.
// At the served shapes (D = 64, B = 8 .. 64) the operations dominate, so the
// design keeps every operand of the two inner loops in shared memory or
// registers, ranks by the B x B loop NI entries a pass (3 B operations an
// entry, no sort) and keeps the trig to one sincospi pair per entry (one
// per row and slice for sin(pi f w) when the weights are row-constant).

#include "fsw_rank_common.cuh"

namespace {

constexpr int BC = 16;  // table entries projected per pass

__global__ void fsw_rank_fwdp_kernel(const float* __restrict__ Z,
                                     const float* __restrict__ wn,
                                     const float* __restrict__ pad,
                                     const float* __restrict__ freqs,
                                     const float* __restrict__ V,
                                     float* __restrict__ out,
                                     int B, int D, int S, int uniform_w) {
  extern __shared__ float smem[];
  float* p_sm = smem;               // [B][TS]   projections, own column
  float* z_sm = p_sm + B * TS;      // [BC][D]   staged rows of Z[r]
  float* w_sm = z_sm + BC * D;      // [B]       wn[r]

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = blockIdx.y * TS + tid;
  const bool live = s < S;
  const float* zr = Z + (size_t)r * B * D;

  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];

  for (int b0 = 0; b0 < B; b0 += BC) {
    const int nb = min(BC, B - b0);
    __syncthreads();  // the previous pass has finished reading z_sm
    for (int k = tid; k < nb * D; k += TS) z_sm[k] = zr[(size_t)b0 * D + k];
    __syncthreads();
    if (live) {
      float acc[BC];
#pragma unroll
      for (int bb = 0; bb < BC; ++bb) acc[bb] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float v = V[(size_t)d * S + s];
#pragma unroll
        for (int bb = 0; bb < BC; ++bb) {
          if (bb < nb) acc[bb] = fmaf(z_sm[bb * D + d], v, acc[bb]);
        }
      }
#pragma unroll
      for (int bb = 0; bb < BC; ++bb) {
        if (bb < nb) p_sm[(b0 + bb) * TS + tid] = acc[bb];
      }
    }
  }
  __syncthreads();
  if (!live) return;
  out[(size_t)r * S + s] =
      rank_fwd_slice(p_sm, w_sm, B, tid, freqs[s], pad[r], uniform_w);
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at this (B, D) needs.
size_t fsw_rank_fwdp_smem_bytes(int B, int D) {
  return sizeof(float) * ((size_t)B * TS + (size_t)BC * D + (size_t)B);
}

// Z (R, B, D), wn (R, B), pad (R,), freqs (S,), V (D, S), out (R, S):
// contiguous float32 on the current device.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int fsw_rank_fwdp_f32(const void* Z, const void* wn, const void* pad,
                      const void* freqs, const void* V, void* out, int R,
                      int B, int D, int S, int uniform_w, void* stream) {
  const size_t smem = fsw_rank_fwdp_smem_bytes(B, D);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fsw_rank_fwdp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)R, (unsigned)((S + TS - 1) / TS));
  fsw_rank_fwdp_kernel<<<grid, TS, smem, (cudaStream_t)stream>>>(
      (const float*)Z, (const float*)wn, (const float*)pad,
      (const float*)freqs, (const float*)V, (float*)out, B, D, S, uniform_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
