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
// Design: K2f's block layout (fsw_rank_fwd.cu).  One block per (table
// row, tile of TS = 64 slices), one thread per slice; the block stages the
// row's real (nonzero-weight) entries only, in their order, as [b][thread]
// (`stage_kept`, fsw_rank_common.cuh: d columns of P loaded for d real
// entries of B, the weights compacted alike), and each thread ranks its
// column once (`rank_core`, NI = 8 entries a pass) for all NF frequencies,
// which is the point of the kernel (the sort route instead builds an
// (R, S, B, NF) trig tensor).  NF = 8 (the instance for F = 8): each group
// of NI ranks stays in registers and feeds 8 accumulators, one a
// frequency, whose constants (f, (2/pi)/f, the uniform row's sine) a thread
// loads once.  NF = 0 (any other F): the ranks go to a second shared
// column c[b][thread], then the d-entry quadrature runs once per frequency
// from the two columns.  Either way each output sums i = 0 .. d-1 in
// order, with K2f's expressions, so the two instances give the same bits,
// and those of a pass over every entry wherever the padded projections are
// finite (a padded entry whose projection is not finite now contributes
// exactly 0).  The tile's outputs out[r, s0 .. s0+63, :] are one contiguous
// run of 64 NF floats: they are staged in shared memory and written
// coalesced, in the API's (R, S, NF) layout (no transpose as the TPU's
// (R, NF, S) kernel layout needs).  A row of width B needs 4 (65 B + 64 F)
// bytes of shared memory at F = 8 (B up to 886) and 4 (129 B + 64 F) at
// other F (B up to 448 at F = 5).
//
// What bounds it on an H100: reading P's real columns once and writing the
// (R, S, NF) output, or the trig.  The least work a row with d real entries
// needs per slice is a sort (about d log2 d compares), a cumsum (d adds)
// and the trig of every entry and frequency (about 20 NF d operations); at
// the JAX package's cartesian benchmark shape (8192 rows, B = 32 with a
// fifth of the weights zero, S = 128, NF = 8) that is 4.4e9 operations
// (0.066 ms at 67 TFLOP/s) against about 141 MB (0.042 ms: the real columns
// of P and the output), so the operations bound it.  The kernel runs the
// d x d rank loop (about 2.5 d instructions an entry, once) and the d x NF
// quadrature (sinpif and cospif of every entry and frequency).

#include "fsw_rank_common.cuh"

namespace {

template <int NF>
__global__ void fsw_rank_cart_fwd_kernel(const float* __restrict__ P,
                                         const float* __restrict__ wn,
                                         const float* __restrict__ pad,
                                         const float* __restrict__ freqs,
                                         float* __restrict__ out, int B,
                                         int S, int F, int uniform_w) {
  extern __shared__ float smem[];
  if (NF > 0) F = NF;
  float* p_sm = smem;                         // [B][TS] real projections
  float* c_sm = p_sm + B * TS;                // [B][TS] ranks (NF == 0)
  float* w_sm = c_sm + (NF == 0 ? B * TS : 0);  // [B] wn[r], then real ones
  float* o_sm = w_sm + B;                     // [TS][F] the tile's outputs

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * TS;
  const int s = s0 + tid;
  const bool live = s < S;

  const float pad_r = pad[r];
  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];
  __syncthreads();
  const int d = stage_kept(p_sm, w_sm, P + (size_t)r * B * S + s, B, S, tid,
                           live);

  if (live) {
    // uniform_w: every real entry of the row has the same weight, recovered
    // as the row max; sin(pi f w) once per frequency, forced to exactly 0 at
    // the padded (zero-weight) entries
    float wr = 0.f;
    if (uniform_w) {
      for (int j = 0; j < d; ++j) wr = fmaxf(wr, w_sm[j]);
    }
    const float* fs = freqs + (size_t)s * F;
    if constexpr (NF > 0) {
      FwdFreq z[NF];
      float acc[NF];
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        z[k] = fwd_freq(fs[k], uniform_w, wr);
        acc[k] = 0.f;
      }
      for (int i0 = 0; i0 < d; i0 += NI) {
        float p[NI], c[NI];
        int unused[NI];
        rank_core<false>(p_sm, w_sm, d, TS, tid, i0, pad_r, p, c, unused);
        // entry i uses slot 0 of the arrays, which then shift down: one
        // copy of the frequency loop, and the arrays stay in registers
#pragma unroll 1
        for (int i = i0; i < min(i0 + NI, d); ++i) {
          const float p_i = p[0], c_i = c[0], w = w_sm[i];
#pragma unroll
          for (int k = 0; k + 1 < NI; ++k) {
            p[k] = p[k + 1];
            c[k] = c[k + 1];
          }
#pragma unroll
          for (int k = 0; k < NF; ++k)
            acc[k] = fmaf(p_i, fwd_sd(z[k], w, c_i, uniform_w), acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < NF; ++k)
        o_sm[tid * NF + k] = (1.f + z[k].f) * acc[k];
    } else {
      for (int i0 = 0; i0 < d; i0 += NI) {
        float p[NI], c[NI];
        int unused[NI];
        rank_core<false>(p_sm, w_sm, d, TS, tid, i0, pad_r, p, c, unused);
#pragma unroll
        for (int k = 0; k < NI; ++k)
          if (i0 + k < d) c_sm[(i0 + k) * TS + tid] = c[k];
      }
      for (int k = 0; k < F; ++k) {
        const FwdFreq z = fwd_freq(fs[k], uniform_w, wr);
        float acc = 0.f;
        for (int i = 0; i < d; ++i)
          acc = fmaf(p_sm[i * TS + tid],
                     fwd_sd(z, w_sm[i], c_sm[i * TS + tid], uniform_w),
                     acc);
        o_sm[tid * F + k] = (1.f + z.f) * acc;
      }
    }
  }
  __syncthreads();
  const int n = min(TS, S - s0) * F;
  float* ot = out + ((size_t)r * S + s0) * F;
  for (int e = tid; e < n; e += TS) ot[e] = o_sm[e];
}

// Dynamic shared memory of a launch at width B with NF frequencies: the
// real entries' projections [B][TS], at NF != 8 their ranks [B][TS], the
// weights [B] and the tile's outputs [TS][NF].
inline size_t cart_fwd_need(int B, int NF) {
  const size_t cols = NF == NF_WIDE ? 1 : 2;
  return sizeof(float) * (cols * B * TS + (size_t)B + (size_t)TS * NF);
}

template <int NF>
cudaError_t launch_cart_fwd(const float* P, const float* wn, const float* pad,
                            const float* freqs, float* out, int R, int B,
                            int S, int F, int uniform_w, size_t smem,
                            cudaStream_t stream) {
  const auto kern = fsw_rank_cart_fwd_kernel<NF>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)R, (unsigned)cdiv(S, TS)), TS, smem, stream>>>(
      P, wn, pad, freqs, out, B, S, F, uniform_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at width B with NF
// frequencies needs.
size_t fsw_rank_cart_fwd_smem_bytes(int B, int NF) {
  return cart_fwd_need(B, NF);
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S, NF), out (R, S, NF):
// contiguous float32 on the current device, R, B, S, NF > 0.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
int fsw_rank_cart_fwd_f32(const void* P, const void* wn, const void* pad,
                          const void* freqs, void* out, int R, int B, int S,
                          int NF, int uniform_w, void* stream) {
  const size_t smem = cart_fwd_need(B, NF);
  if (smem > SMEM_LIMIT || cdiv(S, TS) > 65535)
    return (int)cudaErrorInvalidValue;
  const float *p = (const float*)P, *w = (const float*)wn;
  const float *pd = (const float*)pad, *f = (const float*)freqs;
  const cudaStream_t st = (cudaStream_t)stream;
  if (NF == NF_WIDE)
    return (int)launch_cart_fwd<NF_WIDE>(p, w, pd, f, (float*)out, R, B, S,
                                         NF, uniform_w, smem, st);
  return (int)launch_cart_fwd<0>(p, w, pd, f, (float*)out, R, B, S, NF,
                                 uniform_w, smem, st);
}

}  // extern "C"
