// The tables' gather backward: dX[s] = sum of dZ[e] over the entries e of a
// table that gather sender s, as a deterministic sum in a fixed order.
//
// Replaces PyTorch's `indexing_backward_kernel`, the backward of
// `X[table.idx]` (embedding.py `_gather`).  No Pallas kernel computes this
// function: the JAX package leaves it to XLA, whose transpose of `jnp.take`
// is a scatter-add, so this kernel is that transpose's counterpart.
//
// The problem it solves.  A table's padding entries all gather sender 0, so
// one sender can own hundreds of thousands of entries (289,941 in the B = 8
// class of an ogbn-arxiv-sized graph).  PyTorch's backward sorts the indices
// and then walks each run of equal indices with one warp, in series: that
// run is a chain of dependent loads, about 1.3 us an entry on an H100.
//
// Design.  The order is built once, with the table (ops/gather_bwd.py
// `gather_order`): the entries sorted stably by sender, and every sender's
// run cut into chunks of at most CHUNK entries.  A chunk is one int4
// (sender, first, count, slot).  One warp sums one chunk, or one tile of
// 32 TILE vectors of a wider row (the grid's y): its lanes hold the row's
// features as vectors of V (a float2 a lane at D = 64 in float32, one tile;
// the unfused route's odd widths, such as Cora's 2865 projections, one
// float a lane and 23 tiles), the chunk's row numbers wait in shared
// memory, and UNROLL rows are loaded before any is added, so several rows
// are in flight while the adds keep entry order.  A sender's only chunk (slot < 0) writes dX[s]
// directly, rounded once to the output type; a chunk of a sender that was
// cut writes a partial row (slot >= 0) in the accumulation type.  The next
// launch sums each cut sender's partials the same way, cut again into
// chunks of at most CHUNK partials, until every sender has one; a run of n
// entries takes 1 + ceil(log_CHUNK(n)) launches, and no warp adds more than
// CHUNK rows in series.  Senders with no entry have one empty chunk and get
// zeros in the first launch, so dX needs no memset.
//
// Numbers.  Every feature is summed from 0 over its chunk's rows in entry
// order, and the partials in chunk order, in float32 for float32 and
// bfloat16 (rounded once at the end) and in float64 for float64.  There
// are no atomics: the same inputs give the same bits on every call, and the
// plain version (ops/gather_bwd.py `gather_bwd_plain`) gives the same bits.
//
// What bounds it on an H100: bytes.  Each call reads dZ once (M rows of D),
// the order (4 bytes an entry, 16 a chunk) and writes dX (N rows); the
// partials are a few rows a cut sender.  At arxiv's B = 8 class (1.01 M
// entries of 64 float32, 169,343 senders) that is about 0.31 GB, 0.09 ms at
// 3.35 TB/s.
//
// C interface (ctypes): gather_bwd_<type>(...), one launch, on `stream`,
// returns cudaGetLastError() (0 on success); gather_bwd_chunk() gives CHUNK
// so the wrapper can check its order against the kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 128;   // the most rows one warp adds in series
constexpr int WARPS = 8;     // warps (chunks) a block
constexpr int UNROLL = 8;    // rows a lane has in flight
constexpr int TILE = 4;      // vectors a lane sums a chunk (blockIdx.y tiles)

template <typename T> struct Num;
template <> struct Num<float> {
  using Acc = float;
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
};
template <> struct Num<double> {
  using Acc = double;
  __device__ static double in(double x) { return x; }
  __device__ static double out(double x) { return x; }
};
template <> struct Num<__nv_bfloat16> {
  using Acc = float;
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// One warp a chunk.  `in` holds the rows the chunks sum: dZ (type Out) in
// the first launch, read through `perm`; the partials (type Acc) later,
// read directly (perm null).  `out` is dX, `part` the partial rows.
template <typename In, typename Out, int V>
__global__ void __launch_bounds__(WARPS * 32)
gather_bwd_kernel(const In* __restrict__ in, const int* __restrict__ perm,
                  const int4* __restrict__ chunks, long long n_chunks,
                  Out* __restrict__ out,
                  typename Num<Out>::Acc* __restrict__ part, int D) {
  using Acc = typename Num<Out>::Acc;
  __shared__ int rows_sm[WARPS][CHUNK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * WARPS + warp;
  if (c >= n_chunks) return;                 // the whole warp leaves
  const int4 ch = chunks[c];                 // sender, first, count, slot
  const int n = ch.z;
  int* rows = rows_sm[warp];
  for (int j = lane; j < n; j += 32) rows[j] = perm ? perm[ch.y + j] : ch.y + j;
  __syncwarp();

  const int f0 = blockIdx.y * 32 * TILE;
  const int f1 = min(D / V, f0 + 32 * TILE);
  for (int f = f0 + lane; f < f1; f += 32) {
    Acc acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = Acc(0);
    for (int j0 = 0; j0 < n; j0 += UNROLL) {
      Vec<In, V> x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j0 + u < n)
          x[u] = reinterpret_cast<const Vec<In, V>*>(
              in + (size_t)rows[j0 + u] * D)[f];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j0 + u < n) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += Num<In>::in(x[u].v[e]);
        }
    }
    if (ch.w < 0) {
      Vec<Out, V> y;
#pragma unroll
      for (int e = 0; e < V; ++e) y.v[e] = Num<Out>::out(acc[e]);
      reinterpret_cast<Vec<Out, V>*>(out + (size_t)ch.x * D)[f] = y;
    } else {
      Vec<Acc, V> y;
#pragma unroll
      for (int e = 0; e < V; ++e) y.v[e] = acc[e];
      reinterpret_cast<Vec<Acc, V>*>(part + (size_t)ch.w * D)[f] = y;
    }
  }
}

// The widest vector (at most 16 bytes of the accumulation type) that
// divides D and that every row's address keeps aligned; among those, the
// widest that still gives each of a warp's 32 lanes one vector.
template <typename Out>
int vec_width(int D, const void* in, const void* out, const void* part,
              size_t in_size) {
  using Acc = typename Num<Out>::Acc;
  const int vmax = 16 / (int)sizeof(Acc);
  int best = 1;
  for (int v = vmax; v >= 1; v /= 2) {
    const bool fits =
        D % v == 0 && (uintptr_t)in % (v * in_size) == 0 &&
        (uintptr_t)out % (v * sizeof(Out)) == 0 &&
        (uintptr_t)part % (v * sizeof(Acc)) == 0;
    if (!fits) continue;
    if (best == 1) best = v;           // the widest that fits
    if (D / v >= 32) return v;         // the widest that fills a warp
  }
  return best;
}

template <typename In, typename Out>
int launch(const void* in, const void* perm, const void* chunks,
           long long n_chunks, void* out, void* part, int D, void* stream) {
  using Acc = typename Num<Out>::Acc;
  if (n_chunks <= 0) return 0;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  const int v = vec_width<Out>(D, in, out, part, sizeof(In));
  const long long blocks = (n_chunks + WARPS - 1) / WARPS;
  const int tiles = (D / v + 32 * TILE - 1) / (32 * TILE);
  if (blocks > 0x7fffffffLL || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)tiles);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* ip = (const In*)in;
  const auto* pp = (const int*)perm;
  const auto* cp = (const int4*)chunks;
  auto* op = (Out*)out;
  auto* ap = (Acc*)part;
  switch (v) {
    case 4:   // 16 bytes of float32 (vec_width gives float64 at most 2)
      if constexpr (sizeof(Acc) == 4)
        gather_bwd_kernel<In, Out, 4><<<grid, WARPS * 32, 0, s>>>(
            ip, pp, cp, n_chunks, op, ap, D);
      break;
    case 2:
      gather_bwd_kernel<In, Out, 2><<<grid, WARPS * 32, 0, s>>>(
          ip, pp, cp, n_chunks, op, ap, D);
      break;
    default:
      gather_bwd_kernel<In, Out, 1><<<grid, WARPS * 32, 0, s>>>(
          ip, pp, cp, n_chunks, op, ap, D);
  }
  return (int)cudaGetLastError();
}

template <typename Out>
int entry(const void* in, const void* perm, const void* chunks,
          long long n_chunks, void* out, void* part, int D,
          int in_is_partials, void* stream) {
  using Acc = typename Num<Out>::Acc;
  return in_is_partials
             ? launch<Acc, Out>(in, nullptr, chunks, n_chunks, out, part, D,
                                stream)
             : launch<Out, Out>(in, perm, chunks, n_chunks, out, part, D,
                                stream);
}

}  // namespace

extern "C" {

int gather_bwd_chunk() { return CHUNK; }

// in: dZ (M, D) of the output type, read by perm (M,) int32, when
// in_is_partials is 0; the partial rows (accumulation type, (P, D)), read
// directly, when it is 1.  chunks (n_chunks, 4) int32, this launch's
// (sender, first, count <= CHUNK, slot).  out: dX (N, D); part: the partial
// rows (P, D) in the accumulation type (float32, or float64 for float64).
// Every pointer contiguous on the current device.
int gather_bwd_f32(const void* in, const void* perm, const void* chunks,
                   long long n_chunks, void* out, void* part, int D,
                   int in_is_partials, void* stream) {
  return entry<float>(in, perm, chunks, n_chunks, out, part, D,
                      in_is_partials, stream);
}

int gather_bwd_f64(const void* in, const void* perm, const void* chunks,
                   long long n_chunks, void* out, void* part, int D,
                   int in_is_partials, void* stream) {
  return entry<double>(in, perm, chunks, n_chunks, out, part, D,
                       in_is_partials, stream);
}

int gather_bwd_bf16(const void* in, const void* perm, const void* chunks,
                    long long n_chunks, void* out, void* part, int D,
                    int in_is_partials, void* stream) {
  return entry<__nv_bfloat16>(in, perm, chunks, n_chunks, out, part, D,
                              in_is_partials, stream);
}

}  // extern "C"
