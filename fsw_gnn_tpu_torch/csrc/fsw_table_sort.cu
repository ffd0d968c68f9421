// The table-layout FSW forward by a sorting network (float32): kernel A1.
//
// Replaces the TPU kernel `_fsw_table_kernel` behind `_fsw_table_call`
// (benchmarks/attic/fsw_table_pallas.py), an attic kernel that the JAX
// package wires into no route; the port reaches it only through
// `fsw_gnn_tpu_torch.benchmarks.attic.fsw_table`.  For every table row r
// and slice s, with P[r, b] = Xp[idx[r, b]]:
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
// Two entries run one device function, `table_column`: `fsw_table_sort_f32`
// on P (R, B, S) already gathered, and `fsw_table_sort_gather_f32`, which reads
// Xp[idx[r, b], s] itself (rows of Xp along s), so the (R, B, S) P is never
// written.  On the same values both give the same bits.
//
// Design: the network runs in registers.  A (row, slice) column belongs to
// G = B / E lanes of one warp, each holding E = min(B, 32) entries (lane q
// of the group holds b = q E .. q E + E - 1); B is a template parameter
// (2 .. 1024), so every stage is unrolled.  A stage of distance j < E
// compares inside the lane; a stage of distance j >= E exchanges with lane
// q ^ (j / E) by `__shfl_xor_sync`, and both lanes of a pair evaluate the
// same predicate, (lo > hi) == asc, on the same two values, so the pairing
// is the TPU network's, ties included.  No shared memory, no block barrier.
// Consecutive lane groups take consecutive slices of a row and rows follow
// each other (the columns r S + s, flattened), so a ragged S idles no
// lane but the grid's last.  The scan is a running sum inside the lane
// after an exclusive prefix of the lanes' totals across the group
// (`__shfl_up_sync`, in lane order); the sum over b runs inside the lane,
// then a fixed butterfly across the group, whose every level leaves both
// lanes of a pair the same bits.  Every sum has a fixed order, so a call
// gives the same bits every time.  B above 1024 or not a power of two is
// refused before any launch.
//
// What bounds it on an H100: the P entry reads P (4 B bytes a row and
// slice) once and writes the output, against the network's
// B log2 B (log2 B + 1) / 4 compare-exchanges a row and slice (4
// operations each), the scan and the trig (about 26 operations a pair) at
// 67 TFLOP/s: at B = 32 the bytes bound it, from B = 128 on the network's
// operations do.  The gathered entry reads Xp once, not P, so its
// operations bound it at every width.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads a block
constexpr unsigned FULL = 0xffffffffu;
constexpr float PI_F = 3.14159265358979323846f;

__host__ __device__ constexpr int lane_entries(int B) {
  return B < 32 ? B : 32;
}

// One stage of the bitonic network, at merge size K and distance J: the
// pair (i, i + J) with bit J of i clear is put in ascending order where
// i & K == 0, in descending order elsewhere; swap = (lo > hi) == asc, as
// the TPU kernel's.  Lane q holds entries i = q E + e.
template <int E, int K, int J>
__device__ __forceinline__ void stage(float (&p)[E], float (&w)[E], int q) {
  if constexpr (J >= E) {        // across lanes: the partner is q ^ (J / E)
    constexpr int m = J / E;
    const bool lower = (q & m) == 0;
    const bool asc = ((q * E) & K) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float po = __shfl_xor_sync(FULL, p[e], m);
      const float wo = __shfl_xor_sync(FULL, w[e], m);
      const float lo = lower ? p[e] : po, hi = lower ? po : p[e];
      const bool sw = (lo > hi) == asc;
      p[e] = sw ? po : p[e];
      w[e] = sw ? wo : w[e];
    }
  } else {                       // inside the lane
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & J) continue;
      const bool asc = (((q * E) | e) & K) == 0;
      const float lo = p[e], hi = p[e + J];
      const bool sw = (lo > hi) == asc;
      const float wl = w[e], wh = w[e + J];
      p[e] = sw ? hi : lo;
      p[e + J] = sw ? lo : hi;
      w[e] = sw ? wh : wl;
      w[e + J] = sw ? wl : wh;
    }
  }
}

// Every stage from (K, J) on, in the network's order.
template <int B, int E, int K, int J>
__device__ __forceinline__ void stages(float (&p)[E], float (&w)[E], int q) {
  stage<E, K, J>(p, w, q);
  if constexpr (J > 1)
    stages<B, E, K, J / 2>(p, w, q);
  else if constexpr (K < B)
    stages<B, E, 2 * K, K>(p, w, q);
}

// The sort, scan and quadrature of one column, its entries loaded by
// `load(b)` -> p; every lane of the group returns the result.
template <int B, typename Load>
__device__ __forceinline__ float table_column(Load load, const float* wrow,
                                              float pr, float f, int q) {
  constexpr int E = lane_entries(B), G = B / E;
  float p[E], w[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    p[e] = load(q * E + e);
    w[e] = wrow[q * E + e];
  }
  stages<B, E, 2, 1>(p, w, q);
  // the weights before this lane's entries: the lanes' totals scanned in
  // lane order
  float run = 0.f;
  if constexpr (G > 1) {
    float tot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) tot += w[e];
    float inc = tot;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const float v = __shfl_up_sync(FULL, inc, d, G);
      if (q >= d) inc += v;
    }
    run = __shfl_up_sync(FULL, inc, 1, G);
    if (q == 0) run = 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += w[e];
    const float c = run + (p[e] > 0.f ? pr : 0.f);
    float u_cos = 0.5f * f * (2.f * c - w[e]);
    u_cos -= rintf(u_cos);
    const float cos_t = cospif(2.f * u_cos);
    const float x = f * w[e];
    float u_sin = 0.5f * x;
    u_sin -= rintf(u_sin);
    const float sin_t = sinpif(2.f * u_sin);
    const float sinc_t = x == 0.f ? 1.f : sin_t / (PI_F * x);
    acc += p[e] * (2.f * w[e] * sinc_t * cos_t);
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
  return (1.f + f) * acc;
}

// One lane a G-th of a column; columns r S + s, lanes past the last column
// run on the last one's values (the shuffles need every lane) and store
// nothing.  GATHER: src is Xp (N, S) read at idx; else P (R, B, S).
template <int B, bool GATHER>
__global__ void __launch_bounds__(NT)
table_kernel(const float* __restrict__ src, const int* __restrict__ idx,
             const float* __restrict__ wn, const float* __restrict__ pad,
             const float* __restrict__ freqs, float* __restrict__ out,
             int S, long long cols) {
  constexpr int G = B / lane_entries(B);
  const long long id = (long long)blockIdx.x * NT + threadIdx.x;
  const long long col = id / G;
  const int q = (int)(id % G);
  const long long cc = col < cols ? col : cols - 1;
  const long long r = cc / S;
  const int s = (int)(cc % S);
  const float* wrow = wn + r * B;
  float v;
  if (GATHER) {
    const int* irow = idx + r * B;
    v = table_column<B>(
        [&](int b) { return src[(long long)irow[b] * S + s]; }, wrow, pad[r],
        freqs[s], q);
  } else {
    const float* prow = src + r * B * S + s;
    v = table_column<B>([&](int b) { return prow[(long long)b * S]; }, wrow,
                        pad[r], freqs[s], q);
  }
  if (q == 0 && col < cols) out[cc] = v;
}

template <bool GATHER>
int launch(const float* src, const int* idx, const float* wn,
           const float* pad, const float* freqs, float* out, int R, int B,
           int S, cudaStream_t stream) {
  if (R <= 0 || S <= 0) return 0;
  const long long cols = (long long)R * S;
  const int G = B / lane_entries(B);
  const long long blocks = (cols * G + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
#define A1_CASE(W)                                                     \
  case W:                                                              \
    table_kernel<W, GATHER><<<grid, NT, 0, stream>>>(src, idx, wn, pad, \
                                                     freqs, out, S, cols); \
    break;
  switch (B) {
    A1_CASE(2) A1_CASE(4) A1_CASE(8) A1_CASE(16) A1_CASE(32) A1_CASE(64)
    A1_CASE(128) A1_CASE(256) A1_CASE(512) A1_CASE(1024)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef A1_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes one column takes at width B (0 for a width the kernel refuses).
int fsw_table_sort_lanes(int B) {
  if (B < 2 || B > 1024 || (B & (B - 1)) != 0) return 0;
  return B / lane_entries(B);
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S,), out (R, S): contiguous
// float32 on the current device, B a power of two from 2 to 1024.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
int fsw_table_sort_f32(const void* P, const void* wn, const void* pad,
                       const void* freqs, void* out, int R, int B, int S,
                       void* stream) {
  return launch<false>((const float*)P, nullptr, (const float*)wn,
                       (const float*)pad, (const float*)freqs, (float*)out,
                       R, B, S, (cudaStream_t)stream);
}

// The same on Xp (N, S) and idx (R, B) int32 sender rows: P[r, b] =
// Xp[idx[r, b]] read inside the kernel.
int fsw_table_sort_gather_f32(const void* idx, const void* wn, const void* pad,
                         const void* Xp, const void* freqs, void* out, int R,
                         int B, int S, void* stream) {
  return launch<true>((const float*)Xp, (const int*)idx, (const float*)wn,
                      (const float*)pad, (const float*)freqs, (float*)out, R,
                      B, S, (cudaStream_t)stream);
}

}  // extern "C"
