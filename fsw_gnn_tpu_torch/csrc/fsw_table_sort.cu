// The table-layout FSW forward by a sorting network (float32): kernel A1.
//
// Replaces the TPU kernel `_fsw_table_kernel` behind `_fsw_table_call`
// (benchmarks/attic/fsw_table_pallas.py), an attic kernel that the JAX
// package wires into no route; the port reaches it only through
// `fsw_gnn_tpu_torch.benchmarks.attic.fsw_table`.  For every table row r
// and slice s, from P (R, B, S) already gathered (P[r, b] = Xp[idx[r, b]]):
//
//   (ps, ws) = the row's (P[r, :, s], wn[r, :]) sorted by ps along B
//              (the TPU kernel's bitonic network, so ties keep the same
//              pairing as there: the multiset of (p, w) pairs is kept)
//   c_b      = ws_0 + ... + ws_b + pad[r] * 1[ps_b > 0]
//   out      = (1 + f) sum_b ps_b 2 ws_b sinc(f ws_b) cos(pi f (2 c_b - ws_b))
//
// with the TPU kernel's mod-1 range reduction before the trig:
// u = f (2c - w) / 2 - rint(u), cos(2 pi u) as cospif(2u), and
// sinc(x) = sin(2 pi (x/2 - rint(x/2))) / (pi x), 1 at x = 0.
//
// Design: one block of NT = 256 threads per (row, tile of TS slices).  The
// row's B x TS pairs sit in shared memory as [b][slice] (two arrays, p and
// w), so consecutive threads touch consecutive slices.  The network runs
// log2 B (log2 B + 1) / 2 stages of B / 2 compare-exchanges a slice, a
// __syncthreads between stages; each stage's B TS / 2 pairs are spread
// over the block.  Then each slice's NT / TS threads take B TS / NT
// consecutive entries each: a first pass sums the chunk's weights, the
// chunk offsets are summed in chunk order, and a second pass runs the
// inclusive scan, the shift, the trig and the chunk's part of the sum;
// the parts are added in chunk order.  Every sum has a fixed order, so a
// call gives the same bits every time; nothing crosses blocks.  TS is 32
// up to B = 512 and 16 at B = 1024, so the pairs take 8 B TS bytes, at
// most 131072: B above 1024, or not a power of two, is refused before any
// launch (`fsw_table_sort_smem_bytes`).
//
// What bounds it on an H100: reading P (4 B bytes a row and slice) once
// and writing the output, against the network's B log2 B (log2 B + 1) / 4
// compare-exchanges a row and slice (4 operations each: a min, a max and
// two selects of the weights), the scan (B adds) and the trig (about 25
// operations a pair) at 67 TFLOP/s: at B = 32 that is 1792 operations
// (27 ps) against 128 bytes (38 ps), so the bytes bound it; from B = 128
// on the network's operations do (at B = 1024, 139264 operations against
// 4 KB).  This first kernel is not tuned: a warp-shuffle network within
// 32, registers instead of shared memory for the early stages and the
// gather of Xp inside the kernel are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads a block
constexpr size_t SMEM_LIMIT = 232448;   // shared memory a block may use
constexpr float PI_F = 3.14159265358979323846f;

__host__ __device__ inline int table_ts(int B) { return B <= 512 ? 32 : 16; }

inline size_t smem_need(int B) {
  return sizeof(float) * (2 * (size_t)B * table_ts(B) + 2 * NT);
}

__global__ void __launch_bounds__(NT)
fsw_table_sort_kernel(const float* __restrict__ P,
                      const float* __restrict__ wn,
                      const float* __restrict__ pad,
                      const float* __restrict__ freqs, float* __restrict__ out,
                      int B, int S, int TS) {
  extern __shared__ float smem[];
  float* p_sm = smem;                 // [B][TS]
  float* w_sm = p_sm + B * TS;        // [B][TS]
  float* part = w_sm + B * TS;        // [NT] chunk sums
  float* acc_sm = part + NT;          // [NT] chunk parts of the output

  const int r = blockIdx.x, s0 = blockIdx.y * TS, tid = threadIdx.x;
  const float* prow = P + (size_t)r * B * S;
  for (int e = tid; e < B * TS; e += NT) {
    const int b = e / TS, t = e % TS;
    p_sm[e] = (s0 + t < S) ? prow[(size_t)b * S + s0 + t] : 0.f;
    w_sm[e] = wn[(size_t)r * B + b];
  }
  __syncthreads();

  // the bitonic network: at merge size k and distance j, the pair
  // (i, i + j) with bit j of i clear is put in ascending order where
  // i & k == 0 and in descending order elsewhere; both are decided by one
  // predicate, swap = (lo > hi) == asc, as the TPU kernel's
  const int pairs = (B / 2) * TS;
  for (int k = 2; k <= B; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < pairs; q += NT) {
        const int t = q % TS, m = q / TS;
        const int i = ((m & ~(j - 1)) << 1) | (m & (j - 1));
        const int a = i * TS + t, b = (i + j) * TS + t;
        const float lo = p_sm[a], hi = p_sm[b];
        const bool asc = (i & k) == 0;
        if ((lo > hi) == asc) {
          const float wl = w_sm[a];
          p_sm[a] = hi;
          p_sm[b] = lo;
          w_sm[a] = w_sm[b];
          w_sm[b] = wl;
        }
      }
      __syncthreads();
    }
  }

  // scan and quadrature: slice t, chunk `ch` of L consecutive entries
  const int per = NT / TS, t = tid % TS, ch = tid / TS;
  const int L = (B + per - 1) / per;
  const int b0 = min(ch * L, B), b1 = min(b0 + L, B);
  float sum = 0.f;
  for (int b = b0; b < b1; ++b) sum += w_sm[b * TS + t];
  part[ch * TS + t] = sum;
  __syncthreads();
  float run = 0.f;
  for (int c2 = 0; c2 < ch; ++c2) run += part[c2 * TS + t];
  const int s = s0 + t;
  const float f = s < S ? freqs[s] : 0.f, pr = pad[r];
  float acc = 0.f;
  for (int b = b0; b < b1; ++b) {
    const float p = p_sm[b * TS + t], w = w_sm[b * TS + t];
    run += w;
    const float c = run + (p > 0.f ? pr : 0.f);
    float u_cos = 0.5f * f * (2.f * c - w);
    u_cos -= rintf(u_cos);
    const float cos_t = cospif(2.f * u_cos);
    const float x = f * w;
    float u_sin = 0.5f * x;
    u_sin -= rintf(u_sin);
    const float sin_t = sinpif(2.f * u_sin);
    const float sinc_t = x == 0.f ? 1.f : sin_t / (PI_F * x);
    acc += p * (2.f * w * sinc_t * cos_t);
  }
  acc_sm[ch * TS + t] = acc;
  __syncthreads();
  if (ch == 0 && s < S) {
    float tot = 0.f;
    for (int c2 = 0; c2 < per; ++c2) tot += acc_sm[c2 * TS + t];
    out[(size_t)r * S + s] = (1.f + f) * tot;
  }
}

}  // namespace

extern "C" {

// Slices a block takes at width B.
int fsw_table_sort_ts(int B) { return table_ts(B); }

// Dynamic shared memory, in bytes, that a launch at width B needs.
size_t fsw_table_sort_smem_bytes(int B) { return smem_need(B); }

// P (R, B, S), wn (R, B), pad (R,), freqs (S,), out (R, S): contiguous
// float32 on the current device, R, S > 0, B a power of two >= 2 whose
// pairs fit a block.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); does not synchronise.
int fsw_table_sort_f32(const void* P, const void* wn, const void* pad,
                       const void* freqs, void* out, int R, int B, int S,
                       void* stream) {
  const int TS = table_ts(B);
  const size_t smem = smem_need(B);
  if (B < 2 || (B & (B - 1)) != 0 || smem > SMEM_LIMIT ||
      (S + TS - 1) / TS > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fsw_table_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)R, (unsigned)((S + TS - 1) / TS));
  fsw_table_sort_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)P, (const float*)wn, (const float*)pad,
      (const float*)freqs, (float*)out, B, S, TS);
  return (int)cudaGetLastError();
}

}  // extern "C"
