// Device code shared by the weighted-rank FSW kernels: the fused-projection
// pair K1f / K1b (fsw_rank_fwdp.cu, fsw_rank_bwdp.cu), the unfused pair
// K2f / K2b (fsw_rank_fwd.cu, fsw_rank_bwd.cu) and the cartesian pair
// K4f / K4b (fsw_rank_cart_fwd.cu, fsw_rank_cart_bwd.cu).  One copy of the
// rank loop, the trig, the transposed-mask loop, the deterministic column
// sums and K1's tensor-core tile product (`tile_product`, at the end), so
// the kernels compute the same bits from the same inputs.
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

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

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

// ---- K1's products on the tensor cores ------------------------------------
//
// C (64 x 64) = A (64 x K) B (K x 64) for one output tile, by the block's
// MMA_THREADS = 128 threads: warp w owns rows 16 w .. 16 w + 15 and all 64
// columns (eight m16n8k8 tiles, `mma.sync` on TF32).  K is walked in chunks
// of KC = 32, staged by `cp.async` (4-byte copies: the row strides D and S
// are any integers, so 16-byte alignment is not given) into a two-stage ring
// in shared memory; chunk c + 1 is in flight while chunk c is multiplied.
//
// Accuracy: every operand x is split as hi = tf32(x), lo = tf32(x - hi)
// (3xTF32), and each k-step adds lo_a hi_b, then hi_a lo_b, then hi_a hi_b
// (the lo_a lo_b term, 2^-22 of the product, is dropped).  A chunk's 12
// products go into an accumulator of their own, started at 0, which is then
// added to the tile's running sum with one float32 add: the tensor cores'
// own additions truncate, and this keeps them to the 12 additions inside a
// chunk, relative to the chunk's partial sum.  The result is float32's
// accuracy (tests/test_torch_tf32.py emulates the split against float64);
// a plain TF32 product keeps about three decimal digits, which moves ranks
// at near-ties and the 'spread' frequencies' outputs (f up to 2S - 1).
//
// Determinism: every element sums its chunks in the order c = 0, 1, ... and
// its k-steps in a fixed order, from 0, and its value depends only on its
// row of A and column of B, so two calls give the same bits and K1b's
// recomputed projection (fsw_rank_bwdp.cu, step 1) has K1f's bits: both
// project with `project_block` on the same row tiles (`proj_rows`).
//
// Operands are given as a pointer to the tile's element (0, 0), a leading
// stride and the valid extent; rows, columns and k past the extent are read
// as zeros (the copies' zero fill), so ragged tiles need no other care.
// K_CONTIG says that k is the contiguous axis in global memory (element
// (i, k) at p[i * ld + k]); otherwise i is (element (i, k) at p[k * ld + i]).
// Shared layouts, padded so that every fragment load is free of bank
// conflicts: [64][KC + 4] for a k-contiguous operand, [KC][64 + 8] for the
// other; both are 2304 floats.

constexpr int MT = 64;                  // rows of an output tile
constexpr int NT = 64;                  // columns of an output tile
constexpr int KC = 32;                  // depth of one staged chunk
constexpr int MMA_THREADS = 128;        // 4 warps: 16 rows x 64 columns each
constexpr int LD_K = KC + 4;            // row stride, [64][KC] layout
constexpr int LD_I = 64 + 8;            // row stride, [KC][64] layout
constexpr int OP_FLOATS = 64 * LD_K;    // == KC * LD_I == 2304
constexpr int STAGE_FLOATS = 2 * 2 * OP_FLOATS;  // 2 stages x (A, B)
static_assert(KC * LD_I == OP_FLOATS, "both layouts must have one size");

struct Operand {
  const float* p;   // element (0, 0) of the tile
  long long ld;     // stride between rows (K_CONTIG) or between k
  int n;            // valid rows (i < n)
};

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage chunk k0 .. k0 + KC - 1 of one 64-row operand into `dst`.
template <bool K_CONTIG>
__device__ __forceinline__ void stage_operand(float* dst, const Operand& op,
                                              int k0, int K, int tid) {
#pragma unroll 4
  for (int e = tid; e < 64 * KC; e += MMA_THREADS) {
    int i, k, s;
    if (K_CONTIG) {
      i = e / KC; k = e % KC; s = i * LD_K + k;
    } else {
      k = e / 64; i = e % 64; s = k * LD_I + i;
    }
    const bool ok = i < op.n && k0 + k < K;
    const float* src = ok ? (K_CONTIG ? op.p + i * op.ld + (k0 + k)
                                      : op.p + (long long)(k0 + k) * op.ld + i)
                          : op.p;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst + s)),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

// Element (i, k) of a staged operand.
template <bool K_CONTIG>
__device__ __forceinline__ float staged(const float* op, int i, int k) {
  return K_CONTIG ? op[i * LD_K + k] : op[k * LD_I + i];
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);   // exact
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile product: acc[j][q] gets C at row 16 warp + g (+ 8 for q >= 2),
// column 8 j + 2 t (+ 1 for odd q), with g = lane / 4 and t = lane % 4 (the
// m16n8k8 accumulator layout).  `stage` holds STAGE_FLOATS floats; every
// thread of the block must call it.  A is (64 x K) and B is (K x 64): B's
// "rows" are its 64 columns n (element (n, k)).
template <bool A_K, bool B_K>
__device__ __forceinline__ void tile_product(const Operand& A,
                                             const Operand& B, int K,
                                             float* stage, float (&acc)[8][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  const int nk = cdiv(K, KC);
  if (nk == 0) return;
  stage_operand<A_K>(stage, A, 0, K, tid);
  stage_operand<B_K>(stage + OP_FLOATS, B, 0, K, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) {
      float* nxt = stage + ((c + 1) & 1) * 2 * OP_FLOATS;
      stage_operand<A_K>(nxt, A, (c + 1) * KC, K, tid);
      stage_operand<B_K>(nxt + OP_FLOATS, B, (c + 1) * KC, K, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* As = stage + (c & 1) * 2 * OP_FLOATS;
    const float* Bs = As + OP_FLOATS;
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      unsigned ahi[4], alo[4];
      split_tf32(staged<A_K>(As, r0, kk + t), ahi[0], alo[0]);
      split_tf32(staged<A_K>(As, r0 + 8, kk + t), ahi[1], alo[1]);
      split_tf32(staged<A_K>(As, r0, kk + t + 4), ahi[2], alo[2]);
      split_tf32(staged<A_K>(As, r0 + 8, kk + t + 4), ahi[3], alo[3]);
      // four column tiles at a time, their three products interleaved, so
      // that no product waits on the one just issued to its accumulator
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        unsigned bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 8 * (j0 + j) + g;
          split_tf32(staged<B_K>(Bs, n, kk + t), bhi[j][0], blo[j][0]);
          split_tf32(staged<B_K>(Bs, n, kk + t + 4), bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[j0 + j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[j0 + j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[j0 + j], ahi, bhi[j][0], bhi[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
    __syncthreads();  // the buffer is staged again two chunks on
  }
}

// Table rows a K1 block projects: enough that a block holds at least 64
// entries when B <= 64 (8 rows at B = 8), one row above.
__host__ __device__ inline int proj_rows(int B) {
  return (B >= 64 || B <= 0) ? 1 : 64 / B;
}

// Dynamic shared memory of K1f at width B: the staging ring, the block's
// projections [rows * B][TS] and its weights [rows * B].  Where the block
// projects in one pass (rows * B <= MT, every B <= 64) the projections and
// weights reuse the ring once the product is done, so the block needs no
// more than K1b's product kernels; wider rows add them beside the ring.
// It does not depend on the feature width D.
inline size_t fwdp_smem_bytes(int B) {
  const size_t e = (size_t)proj_rows(B) * B, own = e * TS + e;
  return sizeof(float) * (e <= (size_t)MT
                              ? (own > STAGE_FLOATS ? own : STAGE_FLOATS)
                              : STAGE_FLOATS + own);
}

// K1's projection of one block's entries: P[e, s] = sum_d Z[e, d] V[d, s]
// for the E entries of the block (consecutive in Z, from `z`) and its
// columns s0 .. s0 + 63 (< S), in passes of MT entries; each value goes to
// store(e, col, value).  The one copy of the projection K1f and K1b run.
template <typename Store>
__device__ __forceinline__ void project_block(const float* z, const float* V,
                                              int E, int D, int S, int s0,
                                              float* stage, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int m0 = 0; m0 < E; m0 += MT) {
    float acc[8][4];
    tile_product<true, false>(Operand{z + (long long)m0 * D, D, min(MT, E - m0)},
                              Operand{V + s0, S, min(NT, S - s0)}, D, stage,
                              acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = m0 + 16 * warp + g + (q >> 1) * 8;
        const int col = 8 * j + 2 * t + (q & 1);
        if (e < E && s0 + col < S) store(e, col, acc[j][q]);
      }
  }
}

}  // namespace
