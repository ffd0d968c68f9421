// K1's in-kernel contractions, each on its own (float32): the probe P1.
//
// Replaces the TPU probe `run` (benchmarks/probe_kernel_matmul.py), which
// asks which contractions lower inside a Pallas kernel: `k_fwd`
// P = Xr (TR,B,D) . V (D,S); `k_dxr` dXr = dP (TR,B,S) . V^T; `k_dv`
// dV = Xr^T dP contracted over (TR, B); `k_dv_loop` the same as a loop over
// B of (D,TR)(TR,S) products; `k_flat` the forward on Xr reshaped to
// (TR B, D).  Here every one runs on K1's own tile routine, `tile_product`
// (3xTF32 `mma.sync` m16n8k8 tiles, a two-stage cp.async ring;
// fsw_rank_common.cuh), with no product code of its own, so their times
// price that routine alone (K1f runs the forward through `project_block`,
// K1b the other two):
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
// Every block has MMA_THREADS = 128 threads and the ring's STAGE_FLOATS
// floats of static shared memory.  Each element sums its chunks of 32 in a
// fixed order, so two calls give the same bits.
//
// What bounds it on an H100: the 2 M N K products at the 3xTF32 rate
// (495 / 3 TFLOP/s) against the bytes of the operands and the output at
// 3.35 TB/s: at K1's headline shape (TR B = 131072 rows, D = 64, S = 127)
// the bytes bound the forward (100 MB, 30 us, against 2.1 GFLOP, 13 us),
// at Cora's layer 0 (21696 rows, D = 1433, S = 2865) the products do
// (178 GFLOP, 1.08 ms, against 389 MB, 0.12 ms).  None of this is tuned:
// the tile routine is K1's as it stands.

#include "fsw_rank_common.cuh"

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

}  // extern "C"
