// Segmented inclusive cumulative sum (K3), float32 and float64.
//
// Replaces the TPU kernels behind `segcumsum_pallas`
// (fsw_gnn_tpu/ops/segcumsum_pallas.py): `_segcumsum_kernel` (segments
// given by sorted int32 ids) and `_segcumsum_mask_kernel` (segments given by
// an int8 is_end mask, 1 on the last element of each segment).  For every i,
//
//   out[i] = sum of v[j] over the j <= i in i's segment,
//
// restarted at every segment start, so the rounding error is about eps times
// the segment's prefix, never eps times the global prefix.
//
// Design.  The TPU kernel carries the running total from one tile to the
// next in scalar memory across a sequential grid; blocks on a GPU run in no
// order, so the scan is three launches over the monoid
//
//   (a, fa) then (b, fb)  =  (fb ? b : a + b,  fa | fb)
//
// on (value, segment-start flag) pairs:
//   1. `tile_scan`: one block per tile of TILE = 2048 elements.  The tile is
//      loaded striped (coalesced) into shared memory; each thread scans its
//      ITEMS = 8 consecutive elements in order, the 256 thread totals are
//      scanned with warp shuffles and then across the 8 warps, and each
//      thread adds its incoming prefix to the elements before its first
//      start.  The block writes the tile scanned on its own, the tile's
//      aggregate (trailing-segment total, has-a-start flag) and the offset of
//      its first segment start.
//   2. `carry_scan`: one block scans the tile aggregates in the same monoid
//      (each thread a run of consecutive tiles in order, then shuffles) and
//      writes each tile's incoming carry, the exclusive prefix.
//   3. `carry_apply`: one block per tile adds the carry to the elements
//      before the tile's first segment start, and touches no other element.
// Every sum is taken in a fixed order: no atomics, the same bits each run.
// The element start flags come from the ids (ids[i] != ids[i-1]) or the mask
// (end[i-1] != 0), element 0 always starts; neither needs the ids sorted,
// only equal ids contiguous.  `max_seg_size`, a bound the TPU kernel uses to
// prune its doubling passes, is not needed here: the result is exact for
// any segment length.
//
// What bounds it on an H100: memory.  It reads the values and the ids (or
// the mask) once and writes the output once, 12 bytes an element in
// float32 with ids, 9 with the mask, and does one add an element.  Launch 1
// moves all of that; launch 3 reads and writes again only the elements of
// each tile's leading segment (about half a segment a tile on average), and
// launch 2 moves 16 bytes a tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr int CARRY_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// Inclusive scan over a warp of (v, f) pairs in the monoid above.
template <typename T>
__device__ __forceinline__ void warp_scan(T& v, int& f, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T pv = __shfl_up_sync(FULL, v, o);
    const int pf = __shfl_up_sync(FULL, f, o);
    if (lane >= o) {
      if (!f) v = pv + v;
      f |= pf;
    }
  }
}

// Block-wide exclusive prefix of each thread's (v, f) and the block's
// inclusive aggregate; `wv`/`wf` are shared arrays of nwarps entries.
template <typename T, int NWARPS>
__device__ __forceinline__ void block_exclusive(T v, int f, T* wv, int* wf,
                                                T& ex_v, T& agg_v,
                                                int& agg_f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T iv = v;
  int ifl = f;
  warp_scan(iv, ifl, lane);
  // exclusive within the warp
  T xv = __shfl_up_sync(FULL, iv, 1);
  int xf = __shfl_up_sync(FULL, ifl, 1);
  if (lane == 0) {
    xv = T(0);
    xf = 0;
  }
  if (lane == 31) {
    wv[warp] = iv;
    wf[warp] = ifl;
  }
  __syncthreads();
  if (warp == 0) {
    T a = lane < NWARPS ? wv[lane] : T(0);
    int af = lane < NWARPS ? wf[lane] : 0;
    warp_scan(a, af, lane);
    T ea = __shfl_up_sync(FULL, a, 1);
    int eaf = __shfl_up_sync(FULL, af, 1);
    const T tot = __shfl_sync(FULL, a, NWARPS - 1);
    const int totf = __shfl_sync(FULL, af, NWARPS - 1);
    __syncwarp();
    if (lane < NWARPS) {
      wv[lane] = lane == 0 ? T(0) : ea;
      wf[lane] = lane == 0 ? 0 : eaf;
    }
    if (lane == 0) {
      wv[NWARPS] = tot;
      wf[NWARPS] = totf;
    }
  }
  __syncthreads();
  // warp prefix, then the thread's exclusive prefix within its warp
  ex_v = xf ? xv : wv[warp] + xv;
  agg_v = wv[NWARPS];
  agg_f = wf[NWARPS];
}

template <typename T, bool IDS>
__global__ void __launch_bounds__(THREADS)
    tile_scan(const T* __restrict__ v, const int* __restrict__ ids,
              const int8_t* __restrict__ end, T* __restrict__ out,
              T* __restrict__ tile_v, int* __restrict__ tile_f,
              int* __restrict__ tile_first, long long n) {
  __shared__ T sv[TILE + TILE / 32];
  __shared__ unsigned char sf[TILE + TILE / 32];
  __shared__ T wv[WARPS + 1];
  __shared__ int wf[WARPS + 1];
  __shared__ int first;

  const long long base = (long long)blockIdx.x * TILE;
  const int tid = threadIdx.x;
  if (tid == 0) first = TILE;
  __syncthreads();

  // striped, coalesced load; past the end: value 0, a segment of its own
  int my_first = TILE;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + tid;
    const long long i = base + j;
    T x = T(0);
    int s = 1;
    if (i < n) {
      x = v[i];
      if (i > 0) s = IDS ? (ids[i] != ids[i - 1]) : (end[i - 1] != 0);
      if (s && j < my_first) my_first = j;
    }
    sv[padded(j)] = x;
    sf[padded(j)] = (unsigned char)s;
  }
  if (my_first < TILE) atomicMin(&first, my_first);   // an int minimum
  __syncthreads();

  // each thread scans its ITEMS consecutive elements in order
  T loc[ITEMS];
  unsigned seen = 0;     // bit k: a start at or before item k
  T acc = T(0);
  int fl = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = tid * ITEMS + k;
    const T x = sv[padded(j)];
    const int s = sf[padded(j)];
    acc = s ? x : acc + x;
    fl |= s;
    loc[k] = acc;
    if (fl) seen |= 1u << k;
  }

  T ex_v, agg_v;
  int agg_f;
  block_exclusive<T, WARPS>(acc, fl, wv, wf, ex_v, agg_v, agg_f);

  __syncthreads();          // every thread has read sv
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const T y = (seen >> k) & 1u ? loc[k] : ex_v + loc[k];
    sv[padded(tid * ITEMS + k)] = y;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + tid;
    const long long i = base + j;
    if (i < n) out[i] = sv[padded(j)];
  }
  if (tid == 0) {
    tile_v[blockIdx.x] = agg_v;
    tile_f[blockIdx.x] = agg_f;
    tile_first[blockIdx.x] = first;
  }
}

template <typename T>
__global__ void __launch_bounds__(CARRY_THREADS)
    carry_scan(const T* __restrict__ tile_v, const int* __restrict__ tile_f,
               T* __restrict__ carry, int tiles) {
  __shared__ T wv[CARRY_THREADS / 32 + 1];
  __shared__ int wf[CARRY_THREADS / 32 + 1];
  const int per = (tiles + CARRY_THREADS - 1) / CARRY_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, tiles);
  T a = T(0);
  int af = 0;
  for (int t = lo; t < hi; ++t) {
    const int f = tile_f[t];
    a = f ? tile_v[t] : a + tile_v[t];
    af |= f;
  }
  T ex_v, agg_v;
  int agg_f;
  block_exclusive<T, CARRY_THREADS / 32>(a, af, wv, wf, ex_v, agg_v, agg_f);
  // carry[t] = the aggregate of tiles 0 .. t-1
  T c = ex_v;
  for (int t = lo; t < hi; ++t) {
    carry[t] = c;
    c = tile_f[t] ? tile_v[t] : c + tile_v[t];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    carry_apply(T* __restrict__ out, const T* __restrict__ carry,
                const int* __restrict__ tile_first, long long n) {
  const int t = blockIdx.x + 1;         // tile 0 has no carry
  const T c = carry[t];
  const long long base = (long long)t * TILE;
  const long long stop = min(base + (long long)tile_first[t], n);
  for (long long i = base + threadIdx.x; i < stop; i += THREADS)
    out[i] = out[i] + c;
}

inline long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// workspace: tile_v, carry (T each), tile_f, tile_first (int each), a tile
template <typename T>
int run(const void* v, const void* ids, const void* end, void* out, void* ws,
        long long n, void* stream) {
  if (n <= 0) return 0;
  if ((ids == nullptr) == (end == nullptr)) return (int)cudaErrorInvalidValue;
  const long long tiles = tiles_of(n);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  char* w = (char*)ws;
  T* tile_v = (T*)w;
  w += align256(sizeof(T) * tiles);
  T* carry = (T*)w;
  w += align256(sizeof(T) * tiles);
  int* tile_f = (int*)w;
  w += align256(sizeof(int) * tiles);
  int* tile_first = (int*)w;
  cudaStream_t s = (cudaStream_t)stream;
  if (ids != nullptr) {
    tile_scan<T, true><<<(unsigned)tiles, THREADS, 0, s>>>(
        (const T*)v, (const int*)ids, nullptr, (T*)out, tile_v, tile_f,
        tile_first, n);
  } else {
    tile_scan<T, false><<<(unsigned)tiles, THREADS, 0, s>>>(
        (const T*)v, nullptr, (const int8_t*)end, (T*)out, tile_v, tile_f,
        tile_first, n);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return (int)e;
  carry_scan<T><<<1, CARRY_THREADS, 0, s>>>(tile_v, tile_f, carry,
                                            (int)tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  carry_apply<T><<<(unsigned)(tiles - 1), THREADS, 0, s>>>(
      (T*)out, carry, tile_first, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch memory a call on n elements of elem_bytes each needs.
size_t segcumsum_workspace_bytes(long long n, int elem_bytes) {
  const long long tiles = n > 0 ? tiles_of(n) : 0;
  return 2 * align256((size_t)elem_bytes * tiles) +
         2 * align256(sizeof(int) * tiles);
}

// values and out (n,) contiguous on the current device; exactly one of ids
// (int32, n) and end (int8, n) given, the other null; ws of
// segcumsum_workspace_bytes(n, 4 or 8) bytes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int segcumsum_f32(const void* values, const void* ids, const void* end,
                  void* out, void* ws, long long n, void* stream) {
  return run<float>(values, ids, end, out, ws, n, stream);
}

int segcumsum_f64(const void* values, const void* ids, const void* end,
                  void* out, void* ws, long long n, void* stream) {
  return run<double>(values, ids, end, out, ws, n, stream);
}

}  // extern "C"
