// Device code shared by the weighted-rank FSW kernels: the fused-projection
// pair K1f / K1b (fsw_rank_fwdp.cu, fsw_rank_bwdp.cu), the unfused pair
// K2f / K2b (fsw_rank_fwd.cu, fsw_rank_bwd.cu) and the cartesian pair
// K4f / K4b (fsw_rank_cart_fwd.cu, fsw_rank_cart_bwd.cu).  One copy of the
// rank loop, the trig, the transposed-mask loop and the deterministic
// column sums, so the kernels compute the same bits from the same
// projections.
//
// For a table row r with weights wn[0 .. B-1], phantom mass pad and one
// slice of frequency f, every thread owns one slice and holds its column
// P[r, :, s] in shared memory, laid out [b][thread] (TS threads a block) so
// a warp's accesses fall on consecutive banks:
//
//   c[i]   = sum_j wn[j] * 1[P[j] < P[i] or (P[j] == P[i] and j <= i)]
//            + pad * 1[P[i] > 0]
//   out    = (1 + f) * sum_i P[i] * sd_i,
//   sd_i   = (2 / (pi f)) sin(pi f wn_i) cos(pi f (2 c_i - wn_i)),
//            with the exact f == 0 limit 2 wn_i cos(...).
//
// c is summed in the order j = 0 .. B-1, as the TPU kernels' `_rank_c` and
// the plain PyTorch versions do, so it agrees with them to the bit wherever
// the projections agree.
//
// Trig accuracy: the phase pi f (2c - w) reaches about 1600 rad at the
// 'spread' frequencies (f up to 2S - 1), so the period is reduced exactly:
// u = f (2c - w) / 2 and cospi(2u) = cos(2 pi u), whose range reduction in
// CUDA's sinpi/cospi is exact (no __sinf).
//
// Zero-weight (padding) entries must contribute exactly 0 to the output and
// to every gradient, whatever their projection: sin(pi f 0) is exactly 0
// from sinpif, the uniform_w row value is forced to 0 there, and the f == 0
// limit 2 w cos A is 0 at w = 0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TS = 64;             // slices per block (one thread each)
constexpr int MAX_SPLIT = 256;     // partials a single reduction pass sums
constexpr int RED_THREADS = 256;   // threads of a column-sum block
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block may use

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline size_t align64(size_t n) { return (n + 63) / 64 * 64; }

constexpr int NI = 8;              // entries ranked together (see rank_group)

// The inclusive weighted ranks of entries i0 .. i0 + NI - 1 of thread tid's
// column: p[k] gets the projection of entry i0 + k and c[k] its rank with
// the pad shift pr, summed in the order j = 0 .. B-1 as `_rank_c` does
// (entries past B get p = 0 and a rank nobody reads).  One pass over the
// row serves NI entries: every p_j and wn_j loaded from shared memory feeds
// NI independent sums, so the loop is neither bound by the loads nor by one
// chain of dependent adds.  The tie rule (p_j == p_i precedes for j <= i) is
// settled by ranges: a j below the group precedes on <=, a j above it on <,
// and only the group's own NI entries compare both ways.
__device__ __forceinline__ void rank_group(const float* p_sm,
                                           const float* w_sm, int B, int tid,
                                           int i0, float pr, float (&p)[NI],
                                           float (&c)[NI]) {
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    p[k] = (i0 + k < B) ? p_sm[(i0 + k) * TS + tid] : 0.f;
    c[k] = 0.f;
  }
  int j = 0;
  for (; j < i0; ++j) {
    const float p_j = p_sm[j * TS + tid], w_j = w_sm[j];
#pragma unroll
    for (int k = 0; k < NI; ++k) c[k] += (p_j <= p[k]) ? w_j : 0.f;
  }
  for (const int j1 = min(i0 + NI, B); j < j1; ++j) {
    const float p_j = p_sm[j * TS + tid], w_j = w_sm[j];
#pragma unroll
    for (int k = 0; k < NI; ++k)
      c[k] += (p_j < p[k] || (p_j == p[k] && j <= i0 + k)) ? w_j : 0.f;
  }
  for (; j < B; ++j) {
    const float p_j = p_sm[j * TS + tid], w_j = w_sm[j];
#pragma unroll
    for (int k = 0; k < NI; ++k) c[k] += (p_j < p[k]) ? w_j : 0.f;
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) c[k] += (p[k] > 0.f) ? pr : 0.f;
}

// The forward of one (row, slice): thread `tid`'s column of P in p_sm
// ([B][TS]), the row's weights in w_sm ([B]).  Returns out[r, s].
__device__ __forceinline__ float rank_fwd_slice(const float* p_sm,
                                                const float* w_sm, int B,
                                                int tid, float f, float pr,
                                                int uniform_w) {
  const bool fz = f == 0.f;
  const float inv_f = fz ? 0.f : 1.f / f;
  const float c2f = 0.636619772367581343f * inv_f;  // (2 / pi) / f

  // uniform_w: every real entry of the row has the same weight, recovered
  // as the row max; sin(pi f w) is computed once and forced to exactly 0 at
  // the padded (zero-weight) entries, whose projections need not be zero.
  float sin_row = 0.f;
  if (uniform_w) {
    float wr = 0.f;
    for (int j = 0; j < B; ++j) wr = fmaxf(wr, w_sm[j]);
    sin_row = sinpif(2.f * (0.5f * f * wr));
  }

  float acc = 0.f;
  for (int i0 = 0; i0 < B; i0 += NI) {
    float p[NI], c[NI];
    rank_group(p_sm, w_sm, B, tid, i0, pr, p, c);
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      if (i0 + k < B) {
        const float w = w_sm[i0 + k];
        float sin_fw;
        if (uniform_w) {
          sin_fw = (w == 0.f) ? 0.f : sin_row;
        } else {
          sin_fw = sinpif(2.f * (0.5f * f * w));
        }
        const float u = 0.5f * f * (2.f * c[k] - w);
        const float cos_t = cospif(2.f * u);
        const float sd = (fz ? 2.f * w : c2f * sin_fw) * cos_t;
        acc = fmaf(p[k], sd, acc);
      }
    }
  }
  return (1.f + f) * acc;
}

// The sum over a warp's 32 lanes, complete in lane 0 (a fixed tree: the
// same bits every call).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

constexpr int WARPS = TS / 32;     // warps of an entry block

// The with_dw backward's transposed-mask loop on thread tid's column: entry
// j collects the dc of every i it precedes, in the order i = 0 .. B-1, NI
// entries j a pass, summed over the warp's slices (warp_sum) and added to
// d_sm[warp][j] by lane 0.  The tie rule by ranges as in rank_group (an i
// below the group is preceded on <, an i above it on <=).  Every lane of
// the warp must call it (the shuffles).
__device__ __forceinline__ void mask_consume(const float* p_sm,
                                             const float* dc_sm, float* d_sm,
                                             int B, int tid, int lane,
                                             int warp) {
  for (int j0 = 0; j0 < B; j0 += NI) {
    float p[NI], acc[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      p[k] = (j0 + k < B) ? p_sm[(j0 + k) * TS + tid] : 0.f;
      acc[k] = 0.f;
    }
    int i = 0;
    for (; i < j0; ++i) {
      const float p_i = p_sm[i * TS + tid], dc_i = dc_sm[i * TS + tid];
#pragma unroll
      for (int k = 0; k < NI; ++k) acc[k] += (p[k] < p_i) ? dc_i : 0.f;
    }
    for (const int i1 = min(j0 + NI, B); i < i1; ++i) {
      const float p_i = p_sm[i * TS + tid], dc_i = dc_sm[i * TS + tid];
#pragma unroll
      for (int k = 0; k < NI; ++k)
        acc[k] += (p[k] < p_i || (p[k] == p_i && j0 + k <= i)) ? dc_i : 0.f;
    }
    for (; i < B; ++i) {
      const float p_i = p_sm[i * TS + tid], dc_i = dc_sm[i * TS + tid];
#pragma unroll
      for (int k = 0; k < NI; ++k) acc[k] += (p[k] <= p_i) ? dc_i : 0.f;
    }
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      if (j0 + k < B) {
        const float t = warp_sum(acc[k]);
        if (lane == 0) d_sm[warp * B + j0 + k] += t;
      }
    }
  }
}

// The with_dw backward's block sums, called by every thread of the block:
// dwn_part[st, r, :] = the warps' d_sm rows added in warp order, and
// dpad_part[st, r] = the threads' dpad terms added in the order
// t = 0 .. TS-1 (r_sm holds TS floats of scratch).
__device__ __forceinline__ void write_entry_partials(
    const float* d_sm, float* r_sm, float dpad_acc, float* dwn_part,
    float* dpad_part, int R, int B, int r, int st, int tid) {
  r_sm[tid] = dpad_acc;
  __syncthreads();
  float* wp = dwn_part + ((size_t)st * R + r) * B;
  for (int j = tid; j < B; j += TS) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += d_sm[w * B + j];
    wp[j] = acc;
  }
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < TS; ++t) acc += r_sm[t];
    dpad_part[(size_t)st * R + r] = acc;
  }
}

// Dynamic shared memory of rank_bwd_entry_kernel at width B.
inline size_t entry_smem_bytes(int B, int with_dw) {
  return sizeof(float) * ((size_t)B * TS * (with_dw ? 2 : 1) +
                          (size_t)B * (with_dw ? 1 + WARPS : 1) + TS);
}

// The backward's entry kernel: one block per (table row, tile of TS
// slices), one thread per slice.  Reads the row's P (R, B, S), ranks its
// entries NI at a time (rank_group) and runs the trig, writes
//   dP[r, i, s] = (1 + f) g sd_i                 (R, B, S)
//   dfr[r, s]   = g (q + (1 + f) sum_i P[i] phi_f,i)   this row's df term
// and with with_dw runs the transposed-mask loop (NI entries j at a time)
// and reduces dwn / dpad over the block's slices into per-tile partials
// dwn_part (n_st, R, B) and dpad_part (n_st, R).  dwn's terms are summed
// over each warp's slices by shuffles as they are made (warp_sum), so a
// block holds two B x TS columns (P and dc) rather than three, and the
// warps' sums are added in warp order; dpad sums in the order t = 0 .. TS-1.
// Lanes past S run on zeros (p = 0, f = 0, g = 0: every term exactly 0) so
// that every lane of a warp takes part in the shuffles; a warp wholly past
// S skips the loops.  P and dP may be the same buffer: each thread reads its
// whole column before it writes there.
__global__ void rank_bwd_entry_kernel(const float* P, float* dP,
                                      const float* __restrict__ wn,
                                      const float* __restrict__ pad,
                                      const float* __restrict__ freqs,
                                      const float* __restrict__ G,
                                      float* __restrict__ dfr,
                                      float* __restrict__ dwn_part,
                                      float* __restrict__ dpad_part,
                                      int R, int B, int S, int uniform_w,
                                      int with_dw) {
  extern __shared__ float smem[];
  float* p_sm = smem;               // [B][TS]    projections, own column
  float* w_sm = p_sm + B * TS;      // [B]        wn[r]
  float* r_sm = w_sm + B;           // [TS]       dpad terms of the block
  float* dc_sm = r_sm + TS;         // [B][TS]    dc (with_dw)
  float* d_sm = dc_sm + B * TS;     // [WARPS][B] each warp's dwn sums (with_dw)

  const int r = blockIdx.x;
  const int st = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = st * TS + tid;
  const bool live = s < S;
  const bool warp_live = st * TS + warp * 32 < S;
  const float* pr_in = P + (size_t)r * B * S + s;
  float* dpr = dP + (size_t)r * B * S + s;

  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];
  for (int b = 0; b < B; ++b)
    p_sm[b * TS + tid] = live ? pr_in[(size_t)b * S] : 0.f;
  __syncthreads();

  float dpad_acc = 0.f;
  if (warp_live) {
    const float f = live ? freqs[s] : 0.f;
    const float pr = pad[r];
    const bool fz = f == 0.f;
    const float inv_f = fz ? 0.f : 1.f / f;
    const float c2f = 0.636619772367581343f * inv_f;     // (2 / pi) / f
    const float inv2f = 2.f * inv_f;
    const float inv_pf = 0.318309886183790672f * inv_f;  // (1 / pi) / f
    const float g = live ? G[(size_t)r * S + s] : 0.f;
    const float g1 = (1.f + f) * g;
    // uniform_w only without with_dw (cos_fw is the row value at padded
    // entries, exact only where it is multiplied by w)
    const bool unif = uniform_w && !with_dw;
    float sin_row = 0.f, cos_row = 1.f;
    if (unif) {
      float wr = 0.f;
      for (int j = 0; j < B; ++j) wr = fmaxf(wr, w_sm[j]);
      sincospif(2.f * (0.5f * f * wr), &sin_row, &cos_row);
    }
    float q = 0.f, qf = 0.f;
    for (int i0 = 0; i0 < B; i0 += NI) {
      float p[NI], c[NI];
      rank_group(p_sm, w_sm, B, tid, i0, pr, p, c);
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        const int i = i0 + k;
        if (i < B) {
          const float p_i = p[k];
          const float w = w_sm[i];
          float sin_fw, cos_fw;
          if (unif) {
            sin_fw = (w == 0.f) ? 0.f : sin_row;
            cos_fw = cos_row;
          } else {
            sincospif(2.f * (0.5f * f * w), &sin_fw, &cos_fw);
          }
          const float two_c_w = 2.f * c[k] - w;
          float sin_t, cos_t;
          sincospif(2.f * (0.5f * f * two_c_w), &sin_t, &cos_t);
          const float sd = (fz ? 2.f * w : c2f * sin_fw) * cos_t;
          if (live) dpr[(size_t)i * S] = g1 * sd;
          q = fmaf(p_i, sd, q);
          const float phi_f = inv2f * (w * cos_fw * cos_t
                                       - inv_pf * sin_fw * cos_t
                                       - two_c_w * sin_fw * sin_t);
          qf = fmaf(p_i, phi_f, qf);
          if (with_dw) {
            const float dc = g1 * p_i * (-4.f) * sin_fw * sin_t;
            dc_sm[i * TS + tid] = dc;
            dpad_acc += (p_i > 0.f) ? dc : 0.f;
            const float v = warp_sum(
                g1 * p_i * 2.f * (cos_fw * cos_t + sin_fw * sin_t));
            if (lane == 0) d_sm[warp * B + i] = v;
          }
        }
      }
    }
    if (live) dfr[(size_t)r * S + s] = g * (q + (1.f + f) * qf);
    if (with_dw) mask_consume(p_sm, dc_sm, d_sm, B, tid, lane, warp);
  } else if (with_dw && lane == 0) {
    for (int j = 0; j < B; ++j) d_sm[warp * B + j] = 0.f;
  }
  if (!with_dw) return;
  write_entry_partials(d_sm, r_sm, dpad_acc, dwn_part, dpad_part, R, B, r,
                       st, tid);
}

// Launch rank_bwd_entry_kernel on a (R, cdiv(S, TS)) grid; returns the
// first CUDA error.
inline cudaError_t launch_rank_bwd_entry(const float* P, float* dP,
                                         const float* wn, const float* pad,
                                         const float* freqs, const float* G,
                                         float* dfr, float* dwn_part,
                                         float* dpad_part, int R, int B,
                                         int S, int uniform_w, int with_dw,
                                         cudaStream_t stream) {
  const size_t smem = entry_smem_bytes(B, with_dw);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_bwd_entry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  rank_bwd_entry_kernel<<<dim3((unsigned)R, (unsigned)cdiv(S, TS)), TS, smem,
                          stream>>>(P, dP, wn, pad, freqs, G, dfr, dwn_part,
                                    dpad_part, R, B, S, uniform_w, with_dw);
  return cudaGetLastError();
}

// out[y, m] = sum_{k = y kc}^{min(K, (y + 1) kc) - 1} in[k, m], in order
__global__ void sum_rows_kernel(const float* __restrict__ in,
                                float* __restrict__ out, int K, long long M,
                                int kc) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  float acc = 0.f;
  for (int k = k0; k < k1; ++k) acc += in[(size_t)k * M + m];
  out[(size_t)blockIdx.y * M + m] = acc;
}

// out (M) = column sums of in (K, M); two passes through tmp (at most
// MAX_SPLIT x M floats) when K > MAX_SPLIT.
inline cudaError_t reduce_rows(const float* in, float* out, float* tmp, int K,
                               long long M, cudaStream_t stream) {
  const unsigned gx = (unsigned)cdiv(M, RED_THREADS);
  if (K <= MAX_SPLIT) {
    sum_rows_kernel<<<dim3(gx, 1), RED_THREADS, 0, stream>>>(in, out, K, M,
                                                              K);
    return cudaGetLastError();
  }
  const int kc = cdiv(K, MAX_SPLIT);
  const int k1 = cdiv(K, kc);
  sum_rows_kernel<<<dim3(gx, k1), RED_THREADS, 0, stream>>>(in, tmp, K, M,
                                                             kc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_rows_kernel<<<dim3(gx, 1), RED_THREADS, 0, stream>>>(tmp, out, k1, M,
                                                            k1);
  return cudaGetLastError();
}

// df (S), and with with_dw dwn (R * B) and dpad (R), from the entry
// kernel's partials; tmp holds MAX_SPLIT * S floats.
inline cudaError_t reduce_entry_partials(const float* dfr,
                                         const float* dwn_part,
                                         const float* dpad_part, float* df,
                                         float* dwn, float* dpad, float* tmp,
                                         int R, int B, int S, int with_dw,
                                         cudaStream_t stream) {
  cudaError_t e = reduce_rows(dfr, df, tmp, R, S, stream);
  if (e != cudaSuccess || !with_dw) return e;
  const int n_st = cdiv(S, TS);
  if ((e = reduce_rows(dwn_part, dwn, tmp, n_st, (long long)R * B,
                       stream)) != cudaSuccess)
    return e;
  return reduce_rows(dpad_part, dpad, tmp, n_st, R, stream);
}

}  // namespace
