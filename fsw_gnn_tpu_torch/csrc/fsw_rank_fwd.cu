// Weighted-rank FSW aggregation on projected entries, forward (float32).
//
// Replaces the TPU kernel `_fwd_kernel` behind `fsw_rank_aggregate`
// (fsw_gnn_tpu/ops/fsw_rank_pallas.py).  It computes what the fused kernel
// K1f (fsw_rank_fwdp.cu) computes after its projection: for every table row
// r and slice s, from P (R, B, S) already projected,
//
//   c[i]   = sum_j wn[r, j] * 1[P[j] < P[i] or (P[j] == P[i] and j <= i)]
//            + pad[r] * 1[P[i] > 0]
//   out    = (1 + f) * sum_i P[i] * sd_i,
//   sd_i   = (2 / (pi f)) sin(pi f wn_i) cos(pi f (2 c_i - wn_i)).
//
// Design: K1f's block layout without the projection.  One block per (table
// row, tile of TS = 64 slices), one thread per slice.  The block stages the
// row's weights, then each thread its column of P at the row's real
// (nonzero-weight) entries only, in their order, as [b][thread] (each load
// of one entry is 64 consecutive floats across the threads, coalesced), and
// the weights are compacted alike (`stage_kept`, fsw_rank_common.cuh): a
// row of d real entries of B loads d columns and ranks d x d pairs.  Every
// thread ranks its own column, NI = 8 entries per pass over the row
// (`rank_core`: a 0/1 compare and a fused multiply-add a pair), and runs the
// quadrature (`rank_fwd_slice`, the one copy K1f uses too).  c and out keep
// the bits of a pass over every entry wherever the padded projections are
// finite: a zero weight adds exactly 0 to every rank, and a padded entry's
// term is exactly 0; a padded entry whose projection is not finite now
// contributes exactly 0 as well.  Nothing crosses blocks, so there are no
// atomics.  A row of width B needs 4 (64 B + B) bytes of shared memory: B
// up to 894.
//
// What bounds it on an H100: reading P's real columns once and writing the
// (R, S) output.  The least work a row with d real entries needs per slice
// is a sort (about d log2 d compares), a cumsum (d adds) and the trig
// (about 20 operations an entry); at the multiset path's widths (2048 rows,
// d = n = 100, S = 1000) that is 5.7e9 operations for 0.82 GB, so the bytes
// bound it (0.25 ms).  This kernel instead runs the d x d rank loop, about
// 2.5 d instructions an entry with the shared loads (5.2e10 in all; 32
// compares, 32 fused multiply-adds and 8 loads for 32 pairs in the SASS):
// it needs no sort and ranks like the TPU kernel, and is held to the
// bytes' bound.

#include "fsw_rank_common.cuh"

namespace {

__global__ void fsw_rank_fwd_kernel(const float* __restrict__ P,
                                    const float* __restrict__ wn,
                                    const float* __restrict__ pad,
                                    const float* __restrict__ freqs,
                                    float* __restrict__ out, int B, int S,
                                    int uniform_w) {
  extern __shared__ float smem[];
  float* p_sm = smem;               // [B][TS]   real entries' projections
  float* w_sm = p_sm + B * TS;      // [B]       wn[r], then the real ones

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = blockIdx.y * TS + tid;
  const bool live = s < S;

  // the slice's frequency and the pad are loaded with the weights: one
  // round trip before the row's columns, not two
  const float f = live ? freqs[s] : 0.f, pr = pad[r];
  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];
  __syncthreads();
  const int d = stage_kept(p_sm, w_sm, P + (size_t)r * B * S + s, B, S, tid,
                           live);
  if (!live) return;
  out[(size_t)r * S + s] = rank_fwd_slice(p_sm, w_sm, d, tid, f, pr,
                                          uniform_w);
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at width B needs.
size_t fsw_rank_fwd_smem_bytes(int B) {
  return sizeof(float) * ((size_t)B * TS + (size_t)B);
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S,), out (R, S): contiguous
// float32 on the current device, R, B, S > 0.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int fsw_rank_fwd_f32(const void* P, const void* wn, const void* pad,
                     const void* freqs, void* out, int R, int B, int S,
                     int uniform_w, void* stream) {
  const size_t smem = fsw_rank_fwd_smem_bytes(B);
  if (smem > SMEM_LIMIT || cdiv(S, TS) > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fsw_rank_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)R, (unsigned)cdiv(S, TS));
  fsw_rank_fwd_kernel<<<grid, TS, smem, (cudaStream_t)stream>>>(
      (const float*)P, (const float*)wn, (const float*)pad,
      (const float*)freqs, (float*)out, B, S, uniform_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
