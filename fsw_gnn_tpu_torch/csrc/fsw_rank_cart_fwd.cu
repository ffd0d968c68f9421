// Cartesian-mode weighted-rank FSW aggregation, forward (float32).
//
// Replaces the TPU kernel `_fwdc_kernel` behind `fsw_rank_aggregate_cart`
// (fsw_gnn_tpu/ops/fsw_rank_pallas.py).  For every table row r, slice s and
// column k of the per-slice frequency matrix F (S, NF), from P (R, B, S)
// already projected:
//
//   c[i]       = sum_j wn[r, j] * 1[P[j] < P[i] or (P[j] == P[i] and j <= i)]
//                + pad[r] * 1[P[i] > 0]
//   out[r,s,k] = (1 + f) * sum_i P[i] * sd_i,   f = F[s, k],
//   sd_i       = (2 / (pi f)) sin(pi f wn_i) cos(pi f (2 c_i - wn_i)),
//                with the exact f == 0 limit 2 wn_i cos(...).
//
// Design: K2f's block layout (fsw_rank_fwd.cu).  One block per (table row,
// tile of TS = 64 slices), one thread per slice; the block stages the row's
// columns P[r, :, s] in shared memory as [b][thread].  Each thread ranks its
// column once (rank_group, NI = 8 entries a pass) into a second shared
// column c[b][thread], then runs the B-entry quadrature once per frequency
// from the two columns: the rank loop is shared by all NF frequencies, which
// is the point of the kernel (the sort route instead builds an
// (R, S, B, NF) trig tensor).  The sums run over i = 0 .. B-1, in K2f's
// order and with K2f's expressions.  The tile's outputs
// out[r, s0 .. s0+63, :] are one contiguous run of 64 NF floats: they are
// staged in shared memory and written coalesced, in the API's (R, S, NF)
// layout (no transpose as the TPU's (R, NF, S) kernel layout needs).  A row
// of width B needs 4 (2 * 64 B + B + 64 NF) bytes of shared memory: B up to
// 446 at NF = 8.
//
// What bounds it on an H100: reading P once and writing the (R, S, NF)
// output, or the trig.  The least work a row with d real entries needs per
// slice is a sort (about d log2 d compares), a cumsum (d adds) and the trig
// of every entry and frequency (about 20 NF d operations); at the JAX
// package's cartesian benchmark shape (8192 rows, B = 32 with a fifth of the
// weights zero, S = 128, NF = 8) that is 4.4e9 operations (0.066 ms at
// 67 TFLOP/s) against 168 MB (0.050 ms), so the operations bound it.  The
// kernel runs the B x B rank loop (3 d operations an entry, once) and the
// B x NF quadrature (sinpif and cospif of every entry and frequency).

#include "fsw_rank_common.cuh"

namespace {

__global__ void fsw_rank_cart_fwd_kernel(const float* __restrict__ P,
                                         const float* __restrict__ wn,
                                         const float* __restrict__ pad,
                                         const float* __restrict__ freqs,
                                         float* __restrict__ out, int B,
                                         int S, int NF, int uniform_w) {
  extern __shared__ float smem[];
  float* p_sm = smem;               // [B][TS]   projections, own column
  float* c_sm = p_sm + B * TS;      // [B][TS]   ranks, own column
  float* w_sm = c_sm + B * TS;      // [B]       wn[r]
  float* o_sm = w_sm + B;           // [TS][NF]  the tile's outputs

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * TS;
  const int s = s0 + tid;
  const bool live = s < S;
  const float* pr = P + (size_t)r * B * S + s;

  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];
  if (live) {
    for (int b = 0; b < B; ++b) p_sm[b * TS + tid] = pr[(size_t)b * S];
  }
  __syncthreads();

  if (live) {
    const float pad_r = pad[r];
    for (int i0 = 0; i0 < B; i0 += NI) {
      float p[NI], c[NI];
      rank_group(p_sm, w_sm, B, tid, i0, pad_r, p, c);
#pragma unroll
      for (int k = 0; k < NI; ++k)
        if (i0 + k < B) c_sm[(i0 + k) * TS + tid] = c[k];
    }
    // uniform_w: every real entry of the row has the same weight, recovered
    // as the row max; sin(pi f w) once per frequency, forced to exactly 0 at
    // the padded (zero-weight) entries, whose projections need not be zero
    float wr = 0.f;
    if (uniform_w) {
      for (int j = 0; j < B; ++j) wr = fmaxf(wr, w_sm[j]);
    }
    for (int k = 0; k < NF; ++k) {
      const float f = freqs[(size_t)s * NF + k];
      const bool fz = f == 0.f;
      const float inv_f = fz ? 0.f : 1.f / f;
      const float c2f = 0.636619772367581343f * inv_f;  // (2 / pi) / f
      const float sin_row = uniform_w ? sinpif(2.f * (0.5f * f * wr)) : 0.f;
      float acc = 0.f;
      for (int i = 0; i < B; ++i) {
        const float w = w_sm[i];
        float sin_fw;
        if (uniform_w) {
          sin_fw = (w == 0.f) ? 0.f : sin_row;
        } else {
          sin_fw = sinpif(2.f * (0.5f * f * w));
        }
        const float u = 0.5f * f * (2.f * c_sm[i * TS + tid] - w);
        const float cos_t = cospif(2.f * u);
        const float sd = (fz ? 2.f * w : c2f * sin_fw) * cos_t;
        acc = fmaf(p_sm[i * TS + tid], sd, acc);
      }
      o_sm[tid * NF + k] = (1.f + f) * acc;
    }
  }
  __syncthreads();
  const int n = min(TS, S - s0) * NF;
  float* ot = out + ((size_t)r * S + s0) * NF;
  for (int e = tid; e < n; e += TS) ot[e] = o_sm[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at width B with NF
// frequencies needs.
size_t fsw_rank_cart_fwd_smem_bytes(int B, int NF) {
  return sizeof(float) *
         (2 * (size_t)B * TS + (size_t)B + (size_t)TS * NF);
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S, NF), out (R, S, NF):
// contiguous float32 on the current device, R, B, S, NF > 0.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int fsw_rank_cart_fwd_f32(const void* P, const void* wn, const void* pad,
                          const void* freqs, void* out, int R, int B, int S,
                          int NF, int uniform_w, void* stream) {
  const size_t smem = fsw_rank_cart_fwd_smem_bytes(B, NF);
  if (smem > SMEM_LIMIT || cdiv(S, TS) > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fsw_rank_cart_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)R, (unsigned)cdiv(S, TS));
  fsw_rank_cart_fwd_kernel<<<grid, TS, smem, (cudaStream_t)stream>>>(
      (const float*)P, (const float*)wn, (const float*)pad,
      (const float*)freqs, (float*)out, B, S, NF, uniform_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
