// K2f with explicitly staged loads (float32): the probe P4.
//
// Replaces the TPU probe `fwd_emit` (benchmarks/probe_emit_pipeline.py,
// `_outer` / `_inner` over `emit_pipeline`), which runs the rank forward
// with explicit double-buffered copies against the implicit grid pipeline
// (`fwd_implicit`, whose H100 counterpart is K2f itself, fsw_rank_fwd.cu).
// It computes K2f's function, out (R, S) from P (R, B, S), wn (R, B),
// pad (R,) and freqs (S,), and answers one question: does K2f wait on its
// loads?  K2f loads a row's columns with plain loads and ranks them only
// when they have arrived.  Here each block walks several rows of one tile
// of TS = 64 slices (rows blockIdx.x, + gridDim.x, ...): while it ranks
// row r, the next row's B x TS projections and B weights are already in
// flight into the second of two buffers in shared memory, by `cp.async`
// copies of 16 bytes (four slices) for P and 4 bytes for the weights.
//
// The output is K2f's to the bit: once a row has arrived, every thread
// keeps its column's entries of nonzero weight in their order (in place,
// the rule of `stage_kept`), warp 0 compacts the weights alike
// (`compact_kept_weights`), and `rank_fwd_slice` ranks and sums exactly as
// K2f does (fsw_rank_common.cuh).  Slices past S are zero-filled by the
// copies, as K2f stores zeros there.  P must have S a multiple of 4 and a
// 16-byte aligned base (the wrapper checks).
//
// What bounds it on an H100: K2f's bound, the real entries' columns of P
// read once; it reads every entry's column (the copies are issued before
// the weights are known), which K2f does not.  Its shared memory is two
// rows: 8 (64 B + B) bytes and some, B up to 447.

#include "fsw_rank_common.cuh"

namespace {

__host__ __device__ inline int stage_stride(int B) {
  return B * TS + ((B + 3) / 4) * 4;       // floats a buffer, 16-byte multiple
}

__device__ __forceinline__ void stage_row(float* buf, const float* P,
                                          const float* wn, int r, int B,
                                          int S, int s0, int tid) {
  float* p_dst = buf;
  float* w_dst = buf + B * TS;
  const float* prow = P + (size_t)r * B * S;
  const int chunks = B * (TS / 4);
  for (int e = tid; e < chunks; e += TS) {
    const int b = e / (TS / 4), q = e % (TS / 4);
    const int s = s0 + 4 * q;
    const bool ok = s < S;
    const float* src = ok ? prow + (size_t)b * S + s : P;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(p_dst + b * TS + 4 * q)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
  for (int b = tid; b < B; b += TS)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(w_dst + b)),
                 "l"(wn + (size_t)r * B + b));
}

__global__ void probe_stage_kernel(const float* __restrict__ P,
                                   const float* __restrict__ wn,
                                   const float* __restrict__ pad,
                                   const float* __restrict__ freqs,
                                   float* __restrict__ out, int R, int B,
                                   int S, int uniform_w) {
  extern __shared__ __align__(16) float smem[];
  const int stride = stage_stride(B);
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * TS, s = s0 + tid;
  const bool live = s < S;
  const float f = live ? freqs[s] : 0.f;

  int r = blockIdx.x;
  if (r < R) stage_row(smem, P, wn, r, B, S, s0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; r < R; ++it, r += gridDim.x) {
    float* cur = smem + (it & 1) * stride;
    float* nxt = smem + ((it + 1) & 1) * stride;
    __syncthreads();   // every thread is done with the previous row's buffer
    if (r + (int)gridDim.x < R)
      stage_row(nxt, P, wn, r + gridDim.x, B, S, s0, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();   // the row in `cur` has arrived for every thread
    float* p_sm = cur;
    float* w_sm = cur + B * TS;
    int d = 0;
    for (int b = 0; b < B; ++b)
      if (w_sm[b] != 0.f) p_sm[(d++) * TS + tid] = p_sm[b * TS + tid];
    __syncthreads();
    compact_kept_weights(w_sm, B, tid);
    if (live)
      out[(size_t)r * S + s] =
          rank_fwd_slice(p_sm, w_sm, d, tid, f, pad[r], uniform_w);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at width B needs.
size_t probe_stage_smem_bytes(int B) {
  return sizeof(float) * 2 * (size_t)stage_stride(B);
}

// K2f's arguments (see fsw_rank_fwd.cu), S a multiple of 4 and P 16-byte
// aligned.  The grid holds as many blocks of each slice tile as fit the
// card at once, each walking its rows.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int probe_stage_f32(const void* P, const void* wn, const void* pad,
                    const void* freqs, void* out, int R, int B, int S,
                    int uniform_w, void* stream) {
  const size_t smem = probe_stage_smem_bytes(B);
  const int tiles = cdiv(S, TS);
  if (smem > SMEM_LIMIT || tiles > 65535 || S % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(probe_stage_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, probe_stage_kernel, TS, smem)) != cudaSuccess)
    return (int)e;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long gx = resident / tiles > 0 ? resident / tiles : 1;
  const dim3 grid((unsigned)(gx < R ? gx : R), (unsigned)tiles);
  probe_stage_kernel<<<grid, TS, smem, (cudaStream_t)stream>>>(
      (const float*)P, (const float*)wn, (const float*)pad,
      (const float*)freqs, (float*)out, R, B, S, uniform_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
