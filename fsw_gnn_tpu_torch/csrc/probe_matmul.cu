// K1's in-kernel contractions, each on its own (float32): the probe P1.
//
// Replaces the TPU probe `run` (benchmarks/probe_kernel_matmul.py), which
// asks which contractions lower inside a Pallas kernel: `k_fwd`
// P = Xr (TR,B,D) . V (D,S); `k_dxr` dXr = dP (TR,B,S) . V^T; `k_dv`
// dV = Xr^T dP contracted over (TR, B); `k_dv_loop` the same as a loop over
// B of (D,TR)(TR,S) products; `k_flat` the forward on Xr reshaped to
// (TR B, D).  Each runs on one of two tile routines, both 3xTF32 (float32's
// accuracy on the tensor cores):
//
// routine 'k1': K1's own tile routine, `tile_product` (`mma.sync` m16n8k8
// tiles, a two-stage cp.async ring; fsw_rank_common.cuh), with no product
// code of its own, so their times price that routine alone (K1f runs the
// forward through `project_block`, K1b the other two):
//
//   fwd      K1f's tiling: a block takes `proj_rows(B)` table rows
//            (proj_rows(B) B entries, in passes of 64) and 64 slices;
//   flat     64-row tiles of the (TR B, D) matrix, whatever the row;
//   dxr      64 x 64 tiles of (TR B, D), contracting S (K1b's dZ);
//   dv       64 x 64 tiles of (D, S), contracting the TR B entries in
//            chunks of DV_CHUNK entries a block, the chunks' partials then
//            summed in chunk order (K1b's dV split);
//   dv_loop  a block a (tile, b): (D, TR)(TR, S) for one b, the B partials
//            summed in b order.
//
// Every such block has MMA_THREADS = 128 threads and the ring's
// STAGE_FLOATS floats of static shared memory.
//
// routine 'wgmma': the Hopper routine of tf32x3_wgmma.cuh (`wgmma` on TF32,
// B from 128-byte-swizzled shared memory and A from registers, a producer
// warpgroup staging four chunks by TMA (cp.async where an operand is not
// 16-byte aligned), the hi/lo split done once a staged chunk; persistent
// blocks of 384 threads over 128 x 128 output tiles):
//
//   fwd, flat  one product (TR B, D)(D, S): on this card both are the same
//            contiguous memory (the TPU probe asked a Mosaic question);
//   dxr      (TR B, S)(D, S)^T;
//   dv       (D, TR B)(TR B, S), k split into fixed ranges of `dv_split`
//            (enough units for 4 x 132 blocks, at least 512 entries a
//            range), the partials summed in range order;
//   dv_loop  a group a b, each (D, TR)(TR, S) split the same way, the
//            partials summed in (b, range) order.
//
// Each element sums its chunks of 32 in a fixed order, so two calls give
// the same bits, on either routine.
//
// What bounds it on an H100: the 2 M N K products at the 3xTF32 rate
// (495 / 3 TFLOP/s) against the bytes of the operands and the output at
// 3.35 TB/s: at K1's headline shape (TR B = 131072 rows, D = 64, S = 127)
// the bytes bound the forward (100 MB, 30 us, against 2.1 GFLOP, 13 us),
// at Cora's layer 0 (21696 rows, D = 1433, S = 2865) the products do
// (178 GFLOP, 1.08 ms, against 389 MB, 0.12 ms).

#include "fsw_rank_common.cuh"
#include "tf32x3_wgmma.cuh"

namespace {

constexpr int DV_CHUNK = 4096;     // entries a dv block contracts

template <typename Store>
__device__ __forceinline__ void store_tile(const float (&acc)[8][4], int ni,
                                           int nj, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 16 * warp + g + (q >> 1) * 8;
      const int c = 8 * j + 2 * t + (q & 1);
      if (i < ni && c < nj) store(i, c, acc[j][q]);
    }
}

__global__ void __launch_bounds__(MMA_THREADS)
fwd_kernel(const float* __restrict__ Z, const float* __restrict__ V,
           float* __restrict__ P, int R, int B, int D, int S) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const int rows = proj_rows(B);
  const int r0 = blockIdx.x * rows, s0 = blockIdx.y * NT;
  const int E = min(rows, R - r0) * B;
  const long long e0 = (long long)r0 * B;
  project_block(Z + e0 * D, V, E, D, S, s0, stage,
                [&](int e, int col, float v) {
                  P[(e0 + e) * S + s0 + col] = v;
                });
}

__global__ void __launch_bounds__(MMA_THREADS)
flat_kernel(const float* __restrict__ Z, const float* __restrict__ V,
            float* __restrict__ P, int M, int D, int S) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const long long m0 = (long long)blockIdx.x * MT;
  const int s0 = blockIdx.y * NT;
  const int ni = (int)min((long long)MT, M - m0), nj = min(NT, S - s0);
  float acc[8][4];
  tile_product<true, false>(Operand{Z + m0 * D, D, ni},
                            Operand{V + s0, S, nj}, D, stage, acc);
  store_tile(acc, ni, nj, [&](int i, int c, float v) {
    P[(m0 + i) * S + s0 + c] = v;
  });
}

__global__ void __launch_bounds__(MMA_THREADS)
dxr_kernel(const float* __restrict__ dP, const float* __restrict__ V,
           float* __restrict__ dX, int M, int D, int S) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const long long m0 = (long long)blockIdx.x * MT;
  const int d0 = blockIdx.y * NT;
  const int ni = (int)min((long long)MT, M - m0), nj = min(NT, D - d0);
  float acc[8][4];
  tile_product<true, true>(Operand{dP + m0 * S, S, ni},
                           Operand{V + (long long)d0 * S, S, nj}, S, stage,
                           acc);
  store_tile(acc, ni, nj, [&](int i, int c, float v) {
    dX[(m0 + i) * D + d0 + c] = v;
  });
}

// part[z] (D, S) of the entries z DV_CHUNK .. (z + 1) DV_CHUNK - 1
__global__ void __launch_bounds__(MMA_THREADS)
dv_kernel(const float* __restrict__ Z, const float* __restrict__ dP,
          float* __restrict__ part, int M, int D, int S) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const int d0 = blockIdx.x * MT, s0 = blockIdx.y * NT;
  const long long k0 = (long long)blockIdx.z * DV_CHUNK;
  const int K = (int)min((long long)DV_CHUNK, M - k0);
  const int ni = min(MT, D - d0), nj = min(NT, S - s0);
  float acc[8][4];
  tile_product<false, false>(Operand{Z + k0 * D + d0, D, ni},
                             Operand{dP + k0 * S + s0, S, nj}, K, stage, acc);
  float* out = part + (size_t)blockIdx.z * D * S;
  store_tile(acc, ni, nj, [&](int i, int c, float v) {
    out[(size_t)(d0 + i) * S + s0 + c] = v;
  });
}

// part[b] (D, S) = Z[:, b, :]^T dP[:, b, :], contracting the TR rows
__global__ void __launch_bounds__(MMA_THREADS)
dv_loop_kernel(const float* __restrict__ Z, const float* __restrict__ dP,
               float* __restrict__ part, int TR, int B, int D, int S) {
  __shared__ __align__(16) float stage[STAGE_FLOATS];
  const int d0 = blockIdx.x * MT, s0 = blockIdx.y * NT, b = blockIdx.z;
  const int ni = min(MT, D - d0), nj = min(NT, S - s0);
  float acc[8][4];
  tile_product<false, false>(
      Operand{Z + (long long)b * D + d0, (long long)B * D, ni},
      Operand{dP + (long long)b * S + s0, (long long)B * S, nj}, TR, stage,
      acc);
  float* out = part + (size_t)b * D * S;
  store_tile(acc, ni, nj, [&](int i, int c, float v) {
    out[(size_t)(d0 + i) * S + s0 + c] = v;
  });
}

// out[i] = sum over z = 0 .. n - 1 of part[z][i], in that order
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int n,
                                 long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < n; ++z) s += part[(size_t)z * len + i];
  out[i] = s;
}

inline int sum_parts(const float* part, float* out, int n, long long len,
                     cudaStream_t stream) {
  sum_parts_kernel<<<(unsigned)cdiv(len, 256), 256, 0, stream>>>(part, out, n,
                                                                 len);
  return (int)cudaGetLastError();
}

// ---- routine 'wgmma' ------------------------------------------------------

enum Kind { FWD = 0, FLAT = 1, DXR = 2, DV = 3, DV_LOOP = 4 };
constexpr int UNIT_TARGET = 4 * 132;    // units the dv splits aim for
constexpr int MIN_RANGE_CHUNKS = 16;    // chunks of 32 a range at least

// (chunk, splits) of a depth K contracted by `units0` units (tiles x
// groups) before splitting: enough ranges for UNIT_TARGET units, each at
// least MIN_RANGE_CHUNKS chunks (fewer partials to write and sum) and a
// whole number of chunks.  It depends on the shape alone, so the bits do.
inline void dv_split(int K, long long units0, int& chunk, int& splits) {
  const int nkc = cdiv(K, tf32x3::KC);
  const int want = (int)((UNIT_TARGET + units0 - 1) / units0);
  int per = cdiv(nkc, want > 1 ? want : 1);
  if (per < MIN_RANGE_CHUNKS) per = MIN_RANGE_CHUNKS;
  if (per > nkc) per = nkc > 0 ? nkc : 1;
  chunk = per * tf32x3::KC;
  splits = K > 0 ? cdiv(K, chunk) : 1;
}

// The product of one contraction as `tf32x3::Params`, its operands' last
// axes la and lb floats apart (D or S, or padded to a multiple of 4);
// parts() partials for dv and dv_loop.  Returns false for an unknown kind.
inline bool wg_params(int kind, const float* a, const float* b, float* out,
                      int TR, int B, int D, int S, int la, int lb,
                      tf32x3::Params& p) {
  const long long M = (long long)TR * B;
  p = tf32x3::Params{};
  p.splits = 1;
  p.nz = 1;
  const bool dv = kind == DV || kind == DV_LOOP;
  p.a_len = M * la;                           // Z or dP
  p.b_len = (dv ? M : (long long)D) * lb;     // dP, or V
  if (kind == FWD || kind == FLAT) {          // (M, D)(D, S): V MN-major
    p.a = a; p.lda = la; p.M = (int)M;
    p.b = b; p.ldb = lb; p.N = S;
    p.c = out; p.ldc = S; p.K = D;
  } else if (kind == DXR) {                   // (M, S)(D, S)^T
    p.a = a; p.lda = la; p.M = (int)M;
    p.b = b; p.ldb = lb; p.N = D;
    p.c = out; p.ldc = D; p.K = S;
  } else if (kind == DV || kind == DV_LOOP) { // (D, k)(k, S), both MN-major
    const bool loop = kind == DV_LOOP;
    p.a = a; p.lda = loop ? (long long)B * la : la; p.M = D;
    p.b = b; p.ldb = loop ? (long long)B * lb : lb; p.N = S;
    p.a_group = loop ? la : 0;
    p.b_group = loop ? lb : 0;
    p.K = loop ? TR : (int)M;
    const int groups = loop ? B : 1;
    const long long tiles =
        (long long)cdiv(D, tf32x3::BM) * cdiv(S, tf32x3::BN);
    dv_split(p.K, tiles * groups, p.chunk, p.splits);
    p.nz = groups * p.splits;
    p.c = out; p.ldc = S; p.c_unit = (long long)D * S;
    return true;
  } else {
    return false;
  }
  p.chunk = p.K;
  return true;
}

}  // namespace

extern "C" {

// Partials of D S floats each that the dv entry needs for M entries.
long long probe_matmul_dv_parts(int M) { return cdiv(M, DV_CHUNK); }

// Z (R, B, D), V (D, S) -> P (R, B, S), K1f's tiling.
int probe_matmul_fwd_f32(const void* Z, const void* V, void* P, int R, int B,
                         int D, int S, void* stream) {
  const dim3 grid((unsigned)cdiv(R, proj_rows(B)), (unsigned)cdiv(S, NT));
  fwd_kernel<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)Z, (const float*)V, (float*)P, R, B, D, S);
  return (int)cudaGetLastError();
}

// Z (M, D), V (D, S) -> P (M, S), 64-row tiles.
int probe_matmul_flat_f32(const void* Z, const void* V, void* P, int M, int D,
                          int S, void* stream) {
  const dim3 grid((unsigned)cdiv(M, MT), (unsigned)cdiv(S, NT));
  flat_kernel<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)Z, (const float*)V, (float*)P, M, D, S);
  return (int)cudaGetLastError();
}

// dP (M, S), V (D, S) -> dX (M, D) = dP V^T.
int probe_matmul_dxr_f32(const void* dP, const void* V, void* dX, int M,
                         int D, int S, void* stream) {
  const dim3 grid((unsigned)cdiv(M, MT), (unsigned)cdiv(D, NT));
  dxr_kernel<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dP, (const float*)V, (float*)dX, M, D, S);
  return (int)cudaGetLastError();
}

// Z (M, D), dP (M, S) -> dV (D, S) = Z^T dP; ws holds
// probe_matmul_dv_parts(M) D S floats.
int probe_matmul_dv_f32(const void* Z, const void* dP, void* dV, void* ws,
                        int M, int D, int S, void* stream) {
  const int n = cdiv(M, DV_CHUNK);
  const dim3 grid((unsigned)cdiv(D, MT), (unsigned)cdiv(S, NT), (unsigned)n);
  dv_kernel<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)Z, (const float*)dP, (float*)ws, M, D, S);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return sum_parts((const float*)ws, (float*)dV, n, (long long)D * S,
                   (cudaStream_t)stream);
}

// Z (TR, B, D), dP (TR, B, S) -> dV (D, S) summed over b of the (D, TR)
// (TR, S) products; ws holds B D S floats.
int probe_matmul_dv_loop_f32(const void* Z, const void* dP, void* dV,
                             void* ws, int TR, int B, int D, int S,
                             void* stream) {
  const dim3 grid((unsigned)cdiv(D, MT), (unsigned)cdiv(S, NT), (unsigned)B);
  dv_loop_kernel<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)Z, (const float*)dP, (float*)ws, TR, B, D, S);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return sum_parts((const float*)ws, (float*)dV, B, (long long)D * S,
                   (cudaStream_t)stream);
}


// Routine 'wgmma': partials of D S floats each that `kind` (3 dv, 4
// dv_loop) needs in its workspace, 0 for the others.
long long probe_matmul_wgmma_parts(int kind, int TR, int B, int D, int S) {
  tf32x3::Params p;
  if (kind != DV && kind != DV_LOOP) return 0;
  wg_params(kind, nullptr, nullptr, nullptr, TR, B, D, S, D, S, p);
  return p.nz;
}

// Routine 'wgmma' for contraction `kind` (0 fwd, 1 flat, 2 dxr, 3 dv,
// 4 dv_loop): a and b the two operands as the k1 entries take them, but
// with their last axes la and lb floats apart (>= their D or S), out its
// result (contiguous), ws probe_matmul_wgmma_parts() D S floats (dv,
// dv_loop; else unused).  Launches on `stream` and returns
// cudaGetLastError().
int probe_matmul_wgmma_f32(int kind, const void* a, const void* b, void* out,
                           void* ws, int TR, int B, int D, int S, int la,
                           int lb, void* stream) {
  tf32x3::Params p;
  const bool dv = kind == DV || kind == DV_LOOP;
  if (!wg_params(kind, (const float*)a, (const float*)b,
                 dv ? (float*)ws : (float*)out, TR, B, D, S, la, lb, p))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = tf32x3::launch(p, /*a_k=*/!dv, /*b_k=*/kind == DXR, st);
  if (e || !dv) return e;
  return sum_parts((const float*)ws, (float*)out, p.nz, (long long)D * S,
                   st);
}

}  // extern "C"
