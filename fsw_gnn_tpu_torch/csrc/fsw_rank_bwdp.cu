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
//   1. P = Z V: a 64 x 64 output tile per block, 256 threads of 4 x 4
//      outputs, the feature axis walked in stages of 16 through shared
//      memory.  Each output sums over d = 0 .. D-1 in order with fmaf from
//      0, as the forward kernel's threads do, so P has the forward's bits
//      and both rank alike.  P goes to the workspace that dp takes later.
//   2. entry kernel, one block per (table row, tile of 64 slices), one
//      thread per slice: its column of P, the rank loop in the order
//      j = 0 .. B-1, the trig, then dp written over P (each thread owns
//      its column) and this row's df term to (R, S).  With with_dw it also
//      runs the transposed-mask loop and reduces dwn / dpad over the
//      block's slices into per-tile partials.
//   3. dZ = dP V^T: the same tiling, the slice axis walked in stages.
//      Each block owns its tile: no cross-block sum.  The feature axis is
//      tiled too, so any D fits (no B x D accumulator per block).
//   4. dV = Z^T dP: the same tiling over (D, S), with the entry axis split
//      into at most 256 chunks (enough blocks to fill the card when D and S
//      are small); each chunk writes a partial (D, S).
//   5.-6. a column-sum kernel reduces the partials of dV, the (R, S) df
//      terms (two passes when R > 256) and the dwn / dpad tiles.
//
// What bounds it on an H100: a row with d real entries needs about
// S d (6 D + 3 d + 45) float32 operations (three products of 2 D each: the
// recomputed projection, dZ and dV; the rank loop; trig and the df, dp
// terms) against reading Z, V, G once and writing dZ, dV.  At the shapes of
// the training path the operations dominate.  This version keeps the
// products in plain FMAs out of shared memory (no tensor cores, no TF32)
// and pays HBM round trips for P and dp; moving the products to wgmma and
// fusing them with the entry kernel are the next steps.
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

#include <cuda_runtime.h>

namespace {

constexpr int TS = 64;          // slices per entry-kernel block
constexpr int GT = 64;          // output tile edge of the two products
constexpr int GK = 16;          // reduction depth per shared-memory stage
constexpr int GTHREADS = 256;   // threads of a product block (4 x 4 each)
constexpr int MAX_SPLIT = 256;  // partials a single reduction pass sums
constexpr int FILL_BLOCKS = 264;  // 2 blocks per SM of an H100
constexpr int RED_THREADS = 256;

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

size_t entry_smem_bytes(int B, int with_dw) {
  return sizeof(float) * ((size_t)B * TS * (with_dw ? 3 : 1) + (size_t)B +
                          TS);
}

// Workspace layout, in floats; each region starts on a 256-byte boundary.
struct Plan {
  size_t dp, dfr, tmp, dvp, dwnp, dpadp, total;
  int n_st, n_split, chunk;
};

size_t align64(size_t n) { return (n + 63) / 64 * 64; }

Plan make_plan(int R, int B, int D, int S, int with_dw) {
  Plan p;
  const long long N = (long long)R * B;
  p.n_st = cdiv(S, TS);
  const int tiles = cdiv(D, GT) * cdiv(S, GT);
  int want = cdiv(FILL_BLOCKS, tiles);
  want = want < MAX_SPLIT ? want : MAX_SPLIT;
  const int most = cdiv(N, 256);  // at least 256 entries a chunk
  want = want < most ? want : most;
  want = want > 1 ? want : 1;
  p.chunk = cdiv(cdiv(N, want), GK) * GK;
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

// P[n, s] = sum_d Z[n, d] V[d, s]  (n over the R * B entries), each sum in
// the order d = 0 .. D-1 with fmaf from 0: the forward kernel's bits
__global__ void __launch_bounds__(GTHREADS)
bwdp_proj_kernel(const float* __restrict__ Z, const float* __restrict__ V,
                 float* __restrict__ P, int N, int D, int S) {
  __shared__ float a_sm[GK][GT];  // Z tile, [feature][entry]
  __shared__ float b_sm[GK][GT];  // V tile, [feature][slice]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long n0 = (long long)blockIdx.x * GT;
  const int s0 = blockIdx.y * GT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += GK) {
    for (int e = tid; e < GT * GK; e += GTHREADS) {
      const int row = e / GK, kk = e % GK, k = k0 + kk;
      const long long n = n0 + row;
      a_sm[kk][row] = (n < N && k < D) ? Z[(size_t)n * D + k] : 0.f;
      const int kb = k0 + e / GT, col = e % GT;
      b_sm[e / GT][col] =
          (kb < D && s0 + col < S) ? V[(size_t)kb * S + s0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = a_sm[kk][ty * 4 + i];
        b[i] = b_sm[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      if (s < S) P[(size_t)n * S + s] = acc[i][j];
    }
  }
}

// pd holds P on entry and dp on exit: each thread reads its own column of
// the row's P before it writes dp there
__global__ void bwdp_entry_kernel(float* __restrict__ pd,
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
  float* p_sm = smem;               // [B][TS]   projections, own column
  float* w_sm = p_sm + B * TS;      // [B]       wn[r]
  float* r_sm = w_sm + B;           // [TS]      dpad terms of the block
  float* dc_sm = r_sm + TS;         // [B][TS]   dc (with_dw)
  float* v_sm = dc_sm + B * TS;     // [B][TS]   dwn terms (with_dw)

  const int r = blockIdx.x;
  const int st = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = st * TS + tid;
  const bool live = s < S;
  float* dpr = pd + (size_t)r * B * S + s;

  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];
  if (live) {
    for (int b = 0; b < B; ++b) p_sm[b * TS + tid] = dpr[(size_t)b * S];
  }
  __syncthreads();

  float dpad_acc = 0.f;
  if (live) {
    const float f = freqs[s];
    const float pr = pad[r];
    const bool fz = f == 0.f;
    const float inv_f = fz ? 0.f : 1.f / f;
    const float c2f = 0.636619772367581343f * inv_f;     // (2 / pi) / f
    const float inv2f = 2.f * inv_f;
    const float inv_pf = 0.318309886183790672f * inv_f;  // (1 / pi) / f
    const float g = G[(size_t)r * S + s];
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
    for (int i = 0; i < B; ++i) {
      const float p_i = p_sm[i * TS + tid];
      float c = 0.f;
      for (int j = 0; j < B; ++j) {
        const float p_j = p_sm[j * TS + tid];
        const bool m = (p_j < p_i) || (p_j == p_i && j <= i);
        c += m ? w_sm[j] : 0.f;
      }
      c += (p_i > 0.f) ? pr : 0.f;
      const float w = w_sm[i];
      float sin_fw, cos_fw;
      if (unif) {
        sin_fw = (w == 0.f) ? 0.f : sin_row;
        cos_fw = cos_row;
      } else {
        sincospif(2.f * (0.5f * f * w), &sin_fw, &cos_fw);
      }
      const float two_c_w = 2.f * c - w;
      float sin_t, cos_t;
      sincospif(2.f * (0.5f * f * two_c_w), &sin_t, &cos_t);
      const float sd = (fz ? 2.f * w : c2f * sin_fw) * cos_t;
      dpr[(size_t)i * S] = g1 * sd;
      q = fmaf(p_i, sd, q);
      const float phi_f = inv2f * (w * cos_fw * cos_t
                                   - inv_pf * sin_fw * cos_t
                                   - two_c_w * sin_fw * sin_t);
      qf = fmaf(p_i, phi_f, qf);
      if (with_dw) {
        const float dc = g1 * p_i * (-4.f) * sin_fw * sin_t;
        dc_sm[i * TS + tid] = dc;
        dpad_acc += (p_i > 0.f) ? dc : 0.f;
        v_sm[i * TS + tid] =
            g1 * p_i * 2.f * (cos_fw * cos_t + sin_fw * sin_t);
      }
    }
    dfr[(size_t)r * S + s] = g * (q + (1.f + f) * qf);
    if (with_dw) {
      // transposed mask: entry j collects the dc of every i it precedes
      for (int j = 0; j < B; ++j) {
        const float p_j = p_sm[j * TS + tid];
        float acc = 0.f;
        for (int i = 0; i < B; ++i) {
          const float p_i = p_sm[i * TS + tid];
          const bool m = (p_j < p_i) || (p_j == p_i && j <= i);
          acc += m ? dc_sm[i * TS + tid] : 0.f;
        }
        v_sm[j * TS + tid] += acc;
      }
    }
  } else if (with_dw) {
    for (int j = 0; j < B; ++j) v_sm[j * TS + tid] = 0.f;
  }
  if (!with_dw) return;
  r_sm[tid] = dpad_acc;
  __syncthreads();
  // sums over the block's slices, each in the order t = 0 .. TS-1
  float* wp = dwn_part + ((size_t)st * R + r) * B;
  for (int j = tid; j < B; j += TS) {
    float acc = 0.f;
    for (int t = 0; t < TS; ++t) acc += v_sm[j * TS + t];
    wp[j] = acc;
  }
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < TS; ++t) acc += r_sm[t];
    dpad_part[(size_t)st * R + r] = acc;
  }
}

// dZ[n, d] = sum_s dp[n, s] V[d, s]  (n over the R * B entries)
__global__ void __launch_bounds__(GTHREADS)
bwdp_dz_kernel(const float* __restrict__ dp, const float* __restrict__ V,
               float* __restrict__ dZ, int N, int D, int S) {
  __shared__ float a_sm[GK][GT];  // dp tile, [slice][entry]
  __shared__ float b_sm[GK][GT];  // V tile,  [slice][feature]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long n0 = (long long)blockIdx.x * GT;
  const int d0 = blockIdx.y * GT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += GK) {
    for (int e = tid; e < GT * GK; e += GTHREADS) {
      const int row = e / GK, kk = e % GK, k = k0 + kk;
      const long long n = n0 + row;
      const int d = d0 + row;
      a_sm[kk][row] = (n < N && k < S) ? dp[(size_t)n * S + k] : 0.f;
      b_sm[kk][row] = (d < D && k < S) ? V[(size_t)d * S + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = a_sm[kk][ty * 4 + i];
        b[i] = b_sm[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < D) dZ[(size_t)n * D + d] = acc[i][j];
    }
  }
}

// part[k, d, s] = sum over entries n of chunk k of Z[n, d] dp[n, s]
__global__ void __launch_bounds__(GTHREADS)
bwdp_dv_kernel(const float* __restrict__ Z, const float* __restrict__ dp,
               float* __restrict__ part, int N, int D, int S, int chunk) {
  __shared__ float a_sm[GK][GT];  // Z tile,  [entry][feature]
  __shared__ float b_sm[GK][GT];  // dp tile, [entry][slice]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int d0 = blockIdx.x * GT, s0 = blockIdx.y * GT;
  const long long lo = (long long)blockIdx.z * chunk;
  const long long hi = min((long long)N, lo + chunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long n0 = lo; n0 < hi; n0 += GK) {
    for (int e = tid; e < GT * GK; e += GTHREADS) {
      const int kk = e / GT, col = e % GT;
      const long long n = n0 + kk;
      a_sm[kk][col] = (n < hi && d0 + col < D)
                          ? Z[(size_t)n * D + d0 + col] : 0.f;
      b_sm[kk][col] = (n < hi && s0 + col < S)
                          ? dp[(size_t)n * S + s0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = a_sm[kk][ty * 4 + i];
        b[i] = b_sm[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * D * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty * 4 + i;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx * 4 + j;
      if (s < S) out[(size_t)d * S + s] = acc[i][j];
    }
  }
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
cudaError_t reduce_rows(const float* in, float* out, float* tmp, int K,
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

}  // namespace

extern "C" {

// Bytes of device workspace a call at this shape needs (the caller
// allocates it; the kernels allocate nothing).
size_t fsw_rank_bwdp_workspace_bytes(int R, int B, int D, int S,
                                     int with_dw) {
  return sizeof(float) * make_plan(R, B, D, S, with_dw).total;
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
  if (p.n_st > MAX_SPLIT || cdiv(S, GT) > 65535 || cdiv(D, GT) > 65535 ||
      entry_smem_bytes(B, with_dw) > 232448)
    return (int)cudaErrorInvalidValue;
  float* w = (float*)ws;
  float* dp = w + p.dp;
  const long long N = (long long)R * B;

  bwdp_proj_kernel<<<dim3((unsigned)cdiv(N, GT), (unsigned)cdiv(S, GT)),
                     GTHREADS, 0, st>>>((const float*)Z, (const float*)V, dp,
                                        (int)N, D, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = entry_smem_bytes(B, with_dw);
  if (smem > 48 * 1024) {
    if ((e = cudaFuncSetAttribute(
             bwdp_entry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)e;
  }
  bwdp_entry_kernel<<<dim3((unsigned)R, (unsigned)p.n_st), TS, smem, st>>>(
      dp, (const float*)wn, (const float*)pad, (const float*)freqs,
      (const float*)G, w + p.dfr, w + p.dwnp, w + p.dpadp, R, B, S,
      uniform_w, with_dw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  bwdp_dz_kernel<<<dim3((unsigned)cdiv(N, GT), (unsigned)cdiv(D, GT)),
                   GTHREADS, 0, st>>>(dp, (const float*)V, (float*)dZ,
                                      (int)N, D, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  bwdp_dv_kernel<<<dim3((unsigned)cdiv(D, GT), (unsigned)cdiv(S, GT),
                        (unsigned)p.n_split), GTHREADS, 0, st>>>(
      (const float*)Z, dp, w + p.dvp, (int)N, D, S, p.chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if ((e = reduce_rows(w + p.dvp, (float*)dV, w + p.tmp, p.n_split,
                       (long long)D * S, st)) != cudaSuccess)
    return (int)e;
  if ((e = reduce_rows(w + p.dfr, (float*)df, w + p.tmp, R, S, st)) !=
      cudaSuccess)
    return (int)e;
  if (with_dw) {
    if ((e = reduce_rows(w + p.dwnp, (float*)dwn, w + p.tmp, p.n_st, N,
                         st)) != cudaSuccess)
      return (int)e;
    if ((e = reduce_rows(w + p.dpadp, (float*)dpad, w + p.tmp, p.n_st, R,
                         st)) != cudaSuccess)
      return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
