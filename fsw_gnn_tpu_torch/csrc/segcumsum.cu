// Segmented inclusive cumulative sum (K3), float32 and float64, forward
// and reverse, over rows that share one segment structure.
//
// Replaces the TPU kernels behind `segcumsum_pallas`
// (fsw_gnn_tpu/ops/segcumsum_pallas.py): `_segcumsum_kernel` (segments
// given by sorted int32 ids) and `_segcumsum_mask_kernel` (segments given by
// an int8 is_end mask, 1 on the last element of each segment).  values is
// (rows, m), the ids or the mask (m,) are shared by every row, and each row
// is scanned on its own (the JAX CSR path's `jax.vmap` over slices; the
// flat form is one row).  For every row and every i,
//
//   forward:  out[i] = sum of v[j] over the j <= i in i's segment,
//   reverse:  out[i] = sum of v[j] over the j >= i in i's segment,
//
// restarted at every segment start, so the rounding error is about eps times
// the segment's prefix, never eps times the global prefix.  The reverse scan
// is the forward's gradient.  A forward segment starts at a row's first
// element, where ids[i] != ids[i-1], or after a set end[i-1]; a reverse one
// at a row's last element, where ids[i] != ids[i+1], or at a set end[i].
// Neither needs the ids sorted, only equal ids contiguous.  `max_seg_size`,
// a bound the TPU kernel uses to prune its doubling passes, is not needed:
// the result is exact for any segment length.
//
// Design: one launch a call, a single pass with a decoupled look-back.
//   * Tiles.  A row is cut into tiles of TILE = THREADS x ITEMS = 4096
//     elements; a block (8 scan warps and one look-back warp) takes the
//     next tile index from a counter in the workspace (one atomicAdd by one
//     thread), so a tile only ever waits on tiles whose blocks are already
//     running.  Tickets run row by row; in reverse a row's tiles are taken
//     from its end.  The block that draws the last ticket sets the counter
//     back to 0 for the next call and counts the call.
//   * Loads.  Values move as 16-byte copies (cp.async: four float4 or
//     eight double2 a thread, no registers held), neighbouring threads on
//     neighbouring addresses, into shared memory, where each thread reads
//     its ITEMS = 16 consecutive elements (the transpose; one 16-byte pad
//     every 128 bytes keeps both sides free of bank conflicts).  The mask
//     comes as one 16-byte load a thread, its own 16 bytes; ids go through
//     shared memory like the values.  A start flag comes from the thread's
//     own registers or the previous thread's (`__shfl_up_sync`; across
//     warps through shared memory); only the tile's first element reads
//     one value of the tile before it.  Unaligned or ragged tiles load
//     element by element into the same layout.
//   * The scan.  Each thread scans its 16 elements in order over the
//     monoid (a, fa) then (b, fb) = (fb ? b : a + b, fa | fb), the thread
//     totals are scanned with warp shuffles, then across the 8 warps.  The
//     tile's aggregate is the trailing segment's total and whether the tile
//     holds a start.
//   * The look-back.  A tile that holds a start publishes its inclusive
//     prefix (its trailing segment's total) as soon as it is scanned; one
//     that does not publishes its aggregate, and its inclusive prefix once
//     its carry is known; the last scan warp publishes the prefix before
//     the block scan when it holds a start.  The look-back warp works while
//     the scan's warps load and scan, and issues all its reads at once:
//     the flag of the tile's first element (no carry needed if it starts a
//     segment), the prefix and aggregate slots of the 32 tiles before, and
//     the previous tile's last scan warp (512 elements, mostly in L2, since
//     that tile's block has just read them), which it scans again exactly
//     as that block does.  Where that warp holds a start, its total is the
//     previous tile's prefix bit for bit, known without waiting for the
//     previous block: the common case with segments shorter than a few
//     hundred elements.  Otherwise the carry is the fold, in tile order, of
//     the nearest published prefix and the published aggregates after it,
//     read again until there is one.  Each slot word holds 32 bits of the
//     value under a published tag, so one read from L2 gives a value and
//     whether it is published.  A row's first tile always holds a start, so
//     the look-back never crosses a row.
//   * Deterministic bits.  The carry into tile t is always the left-to-
//     right fold of the aggregates from the nearest tile that holds a start
//     up to t - 1, and a published prefix is that same fold up to its tile,
//     so continuing from whichever prefix the look-back finds gives the
//     same bits; the up to 32 aggregates of a window are folded in order
//     (every lane the same sequence of adds), not by a shuffle tree.  No
//     atomics touch a value: the same bits every run, and the ids and the
//     mask, which give the same flags, give the same bits.
//   * The slots live on the device from call to call with nothing passed
//     in by the host, so a call captured in a CUDA graph replays safely.
//     The workspace holds two banks of slots and one 64-bit word: the
//     ticket counter in its low half, the calls made in its high half.
//     Every block reads the call count with its ticket (one atomicAdd), so
//     all blocks of a call agree on its bank, the count's parity; the block
//     that draws the last ticket resets the counter and counts the call.
//     While a call works in its bank, each block clears its share of the
//     other bank (32 bytes a tile, and the tiles a call of fewer tiles
//     leaves out), which no block of this call reads: the next call on the
//     stream finds its bank all zero.  Nothing published by an earlier
//     call, or an earlier replay of the same graph, is ever taken for this
//     call's.  The workspace is zeroed once, when it is made.
//
// What bounds it on an H100: memory.  It reads the values once and writes
// the output once, and reads the m-long segment structure once for all
// rows (the rows' tiles read it again from L2): in float32 8 bytes an
// element plus m with the shared mask (9 flat, 12 with ids), one add an
// element.  The design moves nothing else through device memory: no second
// pass over a tile, no copy of the mask per row, and for the backward no
// flipped copies (the reverse scan reads the cotangent as it lies).  What
// it does not do: it hides the ticket's latency, and with segments longer
// than the previous tile's last warp the wait for its aggregate, only by
// running several blocks an SM (4 in float32); the previous tile's last
// warp read again (2.5 KB a tile in float32 with the mask, from L2), the
// slots (32 bytes a tile) and the other bank's clearing (32 bytes a tile)
// are extra traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;               // the scan's threads
constexpr int BLOCK = THREADS + 32;        // and the look-back warp
constexpr int ITEMS = 16;                  // elements a thread; 16 mask bytes
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PUBLISHED = 1u;         // a slot word's tag once written
// Blocks an SM the registers are sized for (ptxas: 56 registers a thread in
// float32, 72 in float64).  The kernel waits on memory, so blocks in
// flight count: on an H100 4 ran faster than 3, and 5 (40 registers)
// spilled and ran slower; in float64 3 ran faster than 2 (PERF.md).
constexpr int MIN_BLOCKS_F32 = 4, MIN_BLOCKS_F64 = 3;
typedef unsigned long long u64;

// Shared-memory index of element e of a tile held as 4-byte (V = 4) or
// 8-byte (V = 2) words: one 16-byte pad after every 128 bytes.
template <int V>
__device__ __forceinline__ int pad(int e) { return e + V * (e / (8 * V)); }

constexpr int PADDED = TILE + TILE / 8;   // words of a padded tile

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<int> { using type = int4; };

// The scan's warps meet at barrier 1, without the look-back warp; all
// warps meet at barrier 2 once the carry is known.
__device__ __forceinline__ void scan_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(THREADS) : "memory");
}

__device__ __forceinline__ void carry_sync() {
  asm volatile("bar.sync 2, %0;" :: "n"(BLOCK) : "memory");
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// A published value: 32 bits of payload under the tag PUBLISHED in each
// 8-byte word (a cleared word reads as not published), so one load reads
// a value and whether it is there.
__device__ __forceinline__ void put(u64* s, float v, unsigned tag) {
  st_relaxed(s, (u64)tag << 32 | __float_as_uint(v));
}

__device__ __forceinline__ void put(u64* s, double v, unsigned tag) {
  const u64 b = (u64)__double_as_longlong(v);
  st_relaxed(s, (u64)tag << 32 | (b & 0xffffffffull));
  st_relaxed(s + 1, (u64)tag << 32 | (b >> 32));
}

__device__ __forceinline__ bool get(const u64* s, unsigned tag, float& v) {
  const u64 a = ld_relaxed(s);
  v = __uint_as_float((unsigned)a);
  return (unsigned)(a >> 32) == tag;
}

__device__ __forceinline__ bool get(const u64* s, unsigned tag, double& v) {
  const u64 a = ld_relaxed(s), b = ld_relaxed(s + 1);
  v = __longlong_as_double((long long)(b << 32 | (a & 0xffffffffull)));
  return (unsigned)(a >> 32) == tag && (unsigned)(b >> 32) == tag;
}

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

// A tile's elements [lo, lo + TILE) of one row, moved between device
// memory (row pointer g, m elements) and shared memory s (padded): 16-byte
// vectors where the tile is whole and aligned, else element by element
// (`fill` past the row's end).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ g,
                                          long long lo, long long m, T* s,
                                          T fill) {
  constexpr int V = 16 / sizeof(T), NV = TILE / V / THREADS;
  using VT = typename Vec16<T>::type;
  const T* src = g + lo;
  if (lo + TILE <= m && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // straight into shared memory (cp.async), no registers held
    const VT* vs = reinterpret_cast<const VT*>(src);
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          s + pad<V>((q * THREADS + threadIdx.x) * V));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(dst), "l"(vs + q * THREADS + threadIdx.x)
                   : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < TILE; e += THREADS)
      s[pad<V>(e)] = lo + e < m ? src[e] : fill;
  }
}

// A thread's ITEMS elements at p, of which n lie in the row (fill past
// it): 16-byte vectors where the chunk is whole and aligned.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, long long n,
                                           T (&y)[ITEMS], T fill) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec16<T>::type;
  if (n >= ITEMS && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < ITEMS / V; ++j) {
      const VT r = reinterpret_cast<const VT*>(p)[j];
      const T* q = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int k = 0; k < V; ++k) y[j * V + k] = q[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) y[k] = k < n ? p[k] : fill;
  }
}

// Bit k set where the mask byte at p + k, of which n lie in the row, is
// set: one 16-byte load where the chunk is whole and aligned.
__device__ __forceinline__ unsigned load_mask(const int8_t* p, long long n) {
  unsigned nz = 0;
  if (n >= ITEMS && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      nz |= (((wd[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0u) << k;
  } else {
    for (int k = 0; k < ITEMS; ++k)
      if (k < n && p[k] != 0) nz |= 1u << k;
  }
  return nz;
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ g, long long lo,
                                           long long m, const T* s) {
  constexpr int V = 16 / sizeof(T), NV = TILE / V / THREADS;
  using VT = typename Vec16<T>::type;
  T* dst = g + lo;
  if (lo + TILE <= m && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    VT* vd = reinterpret_cast<VT*>(dst);
#pragma unroll
    for (int q = 0; q < NV; ++q)
      vd[q * THREADS + threadIdx.x] = *reinterpret_cast<const VT*>(
          s + pad<V>((q * THREADS + threadIdx.x) * V));
  } else {
    for (int e = threadIdx.x; e < TILE; e += THREADS)
      if (lo + e < m) dst[e] = s[pad<V>(e)];
  }
}

// A thread's ITEMS consecutive elements of shared memory, chunk c.
template <typename T>
__device__ __forceinline__ void read_chunk(const T* s, int c, T (&x)[ITEMS]) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec16<T>::type;
#pragma unroll
  for (int j = 0; j < ITEMS / V; ++j) {
    const VT r =
        *reinterpret_cast<const VT*>(s + pad<V>(c * ITEMS + j * V));
    const T* p = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < V; ++k) x[j * V + k] = p[k];
  }
}

template <typename T>
__device__ __forceinline__ void write_chunk(T* s, int c, const T (&x)[ITEMS]) {
  constexpr int V = 16 / sizeof(T);
  using VT = typename Vec16<T>::type;
#pragma unroll
  for (int j = 0; j < ITEMS / V; ++j) {
    VT r;
    T* p = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = x[j * V + k];
    *reinterpret_cast<VT*>(s + pad<V>(c * ITEMS + j * V)) = r;
  }
}

template <typename T>
struct Work {
  const T* v;
  const int* ids;
  const int8_t* end;
  T* out;
  u64* state;              // ticket counter (low 32 bits), calls (high)
  u64* agg;                // a slot's aggregate (trailing-segment total)
  u64* pre;                // a slot's inclusive prefix; 2 words a slot
  long long m, tiles_per_row;
  long long capacity;      // tickets a bank; bank b's slots at b * capacity
  unsigned total;
};

// Whether the tile's first element, in processing order, starts a
// segment (then it needs no carry).
template <typename T, bool IDS, bool REV>
__device__ __forceinline__ bool first_starts(const Work<T>& w, long long lo) {
  if (REV) {
    const long long e = lo + TILE - 1;
    if (e >= w.m - 1) return true;
    return IDS ? w.ids[e] != w.ids[e + 1] : w.end[e] != 0;
  }
  if (lo == 0) return true;
  return IDS ? w.ids[lo] != w.ids[lo - 1] : w.end[lo - 1] != 0;
}

// One pass of the look-back: the prefix and aggregate slots j of this
// call's bank (lane i reads ticket d - 1 - i), each with whether it is
// published.
template <typename T>
struct Window {
  T pv = T(0), av = T(0);
  bool hp = false, ha = false;
};

template <typename T>
__device__ __forceinline__ Window<T> read_window(const Work<T>& w,
                                                 long long j, bool mine) {
  Window<T> r;
  if (mine) {
    r.hp = get(w.pre + 2 * j, PUBLISHED, r.pv);
    r.ha = get(w.agg + 2 * j, PUBLISHED, r.av);
  }
  return r;
}

// The carry from a window, if the nearest published prefix in it has only
// published aggregates after it: that prefix and those aggregates folded
// in tile order (every lane the same result).
template <typename T>
__device__ __forceinline__ bool fold_window(const Window<T>& r, int lane,
                                            T& c) {
  const unsigned pre_m = __ballot_sync(FULL, r.hp);
  const unsigned agg_m = __ballot_sync(FULL, r.ha);
  if (pre_m == 0) return false;
  const int k = __ffs(pre_m) - 1;               // the nearest prefix
  const unsigned nearer = (1u << k) - 1u;
  if ((agg_m & nearer) != nearer) return false; // an aggregate missing
  const T x = lane == k ? r.pv : r.av;
  c = __shfl_sync(FULL, x, k);
  for (int i = k - 1; i >= 0; --i) c = c + __shfl_sync(FULL, x, i);
  return true;
}

// Bits k of a thread's chunk (first element e0 in the row, in processing
// order) forced to start: a row's first element (its last in reverse), and
// every element past the row's end (a segment of its own, value 0).
template <bool REV>
__device__ __forceinline__ unsigned force_starts(unsigned sb, long long e0,
                                                 long long m) {
  const long long rem = m - e0;         // the chunk's elements in the row
  const int n = rem <= 0 ? 0 : rem >= ITEMS ? ITEMS : (int)rem;
  const unsigned past = ~((1u << n) - 1u) & 0xffffu;   // original order
  if (REV) {
    sb |= __brev(past) >> (32 - ITEMS);
    if (rem >= 1 && rem <= ITEMS) sb |= 1u << (ITEMS - rem);  // m - 1
  } else {
    sb |= past;
    if (e0 == 0) sb |= 1u;
  }
  return sb;
}

// A thread's scan of its items in order, in place: x[k] becomes the sum
// from the last start at or before k (or from the chunk's first item);
// (acc, fl) the chunk's total and whether it holds a start; returns bit k
// set where a start lies at or before item k.
template <typename T>
__device__ __forceinline__ unsigned thread_scan(T (&x)[ITEMS], unsigned sb,
                                                T& acc, int& fl) {
  acc = T(0);
  fl = 0;
  unsigned seen = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int s = (sb >> k) & 1u;
    acc = s ? x[k] : acc + x[k];
    fl |= s;
    x[k] = acc;
    seen |= (unsigned)fl << k;
  }
  return seen;
}

// The last scan warp's total of the tile at lo, as that tile's block
// computes it, read again from device memory by the look-back warp:
// (v, f) of its lane 31 after the warp scan.  Where f is set this is the
// tile's trailing-segment total, the prefix it publishes, bit for bit.
template <typename T, bool IDS, bool REV>
__device__ __forceinline__ void rescan_last_warp(const Work<T>& w,
                                                 long long row, long long lo,
                                                 int lane, T& v, int& f) {
  const int tid = (WARPS - 1) * 32 + lane;
  const int c = REV ? THREADS - 1 - tid : tid;
  const long long m = w.m, e0 = lo + (long long)c * ITEMS;
  // the element before the warp's first in processing order
  const long long pe = REV ? e0 + ITEMS : e0 - 1;
  const bool pin = lane == 0 && pe >= 0 && pe < m;
  T x[ITEMS];
  {
    T y[ITEMS];
    load_chunk<T>(w.v + row * m + e0, m - e0, y, T(0));
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) x[k] = REV ? y[ITEMS - 1 - k] : y[k];
  }
  unsigned sb;
  if (IDS) {
    const int pid = pin ? w.ids[pe] : 0;
    int y[ITEMS], id[ITEMS];
    load_chunk<int>(w.ids + e0, m - e0, y, 0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) id[k] = REV ? y[ITEMS - 1 - k] : y[k];
    int prev = __shfl_up_sync(FULL, id[ITEMS - 1], 1);
    if (lane == 0) prev = pid;
    sb = id[0] != prev;
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) sb |= (unsigned)(id[k] != id[k - 1]) << k;
  } else {
    const unsigned pbit = !REV && pin && w.end[pe] != 0;
    const unsigned nz = load_mask(w.end + e0, m - e0);
    if (REV) {
      sb = __brev(nz) >> (32 - ITEMS);
    } else {
      unsigned prev = __shfl_up_sync(FULL, (nz >> 15) & 1u, 1);
      if (lane == 0) prev = pbit;
      sb = ((nz << 1) | prev) & 0xffffu;
    }
  }
  sb = force_starts<REV>(sb, e0, m);
  T acc;
  thread_scan(x, sb, acc, f);
  v = acc;
  warp_scan(v, f, lane);
  v = __shfl_sync(FULL, v, 31);
  f = __shfl_sync(FULL, f, 31);
}

template <typename T, bool IDS, bool REV>
__global__ void __launch_bounds__(BLOCK, sizeof(T) == 4 ? MIN_BLOCKS_F32
                                                         : MIN_BLOCKS_F64)
    scan_kernel(Work<T> w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sv = reinterpret_cast<T*>(smem);
  int* sid = reinterpret_cast<int*>(smem + sizeof(T) * PADDED);
  __shared__ T wv[WARPS + 1];
  __shared__ int wf[WARPS + 1];
  __shared__ int edge[WARPS + 1];     // the element before each warp's first
  __shared__ unsigned s_ticket, s_bank;
  __shared__ T s_carry;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const u64 st = atomicAdd(w.state, 1ull);
    const unsigned t = (unsigned)st;
    const u64 calls = st >> 32;
    // the last ticket: the counter back to 0, one more call counted
    if (t == w.total - 1) atomicExch(w.state, (calls + 1) << 32);
    s_ticket = t;
    s_bank = (unsigned)(calls & 1);
  }
  __syncthreads();
  const long long d = s_ticket;
  const long long sd = d + s_bank * w.capacity;   // d's slot in the bank
  const long long row = d / w.tiles_per_row;
  const long long k_in_row = d - row * w.tiles_per_row;
  const long long row_first = row * w.tiles_per_row;
  const long long tile = REV ? w.tiles_per_row - 1 - k_in_row : k_in_row;
  const long long lo = tile * TILE;
  const long long m = w.m;

  // ---- the look-back warp: the carry, while the scan's warps load and
  // scan (they publish the tile's aggregate without waiting for it)
  if (warp == WARPS) {
    // one round of loads, all issued at once: whether the tile's first
    // element starts a segment, the slots of the tiles before, and the
    // previous tile's last scan warp read again (where that warp holds a
    // start its total is the previous tile's prefix, known without waiting
    // for its block)
    const bool need = !first_starts<T, IDS, REV>(w, lo);
    const long long j = d - 1 - lane;
    Window<T> win = read_window(w, sd - 1 - lane, j >= row_first);
    T pv = T(0);
    int pf = 0;
    if (d > row_first)
      rescan_last_warp<T, IDS, REV>(w, row, REV ? lo + TILE : lo - TILE,
                                    lane, pv, pf);
    T carry = T(0);
    if (need) {
      if (pf) {
        carry = pv;
      } else {
        while (!fold_window(win, lane, carry))
          win = read_window(w, sd - 1 - lane, j >= row_first);
      }
    }
    if (lane == 0) s_carry = carry;
    carry_sync();
    return;
  }

  // this thread's chunk of ITEMS elements, in processing order
  const int c = REV ? THREADS - 1 - tid : tid;

  // ---- loads: values (and ids) into shared memory, mask bytes to registers
  load_tile<T>(w.v + row * m, lo, m, sv, T(0));
  unsigned nz = 0;        // mask: bit k = end[lo + 16 c + k] != 0
  if (IDS) {
    load_tile<int>(w.ids, lo, m, sid, 0);
    if (tid == 0) {
      const long long e = REV ? lo + TILE : lo - 1;   // before the first
      edge[0] = (e >= 0 && e < m) ? w.ids[e] : 0;
    }
  } else {
    const long long e0 = lo + (long long)c * ITEMS;
    nz = load_mask(w.end + e0, m - e0);
    if (!REV) {
      if (lane == 31 && warp + 1 < WARPS) edge[warp + 1] = (nz >> 15) & 1u;
      if (tid == 0) edge[0] = lo > 0 && w.end[lo - 1] != 0;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  scan_sync();

  // ---- this thread's items and start flags, in processing order
  T x[ITEMS];
  {
    T y[ITEMS];
    read_chunk<T>(sv, c, y);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) x[k] = REV ? y[ITEMS - 1 - k] : y[k];
  }
  unsigned sb;            // bit k: item k starts a segment
  if (IDS) {
    int y[ITEMS], id[ITEMS];
    read_chunk<int>(sid, c, y);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) id[k] = REV ? y[ITEMS - 1 - k] : y[k];
    int prev = __shfl_up_sync(FULL, id[ITEMS - 1], 1);
    if (lane == 0)
      prev = tid == 0 ? edge[0]
                      : sid[pad<4>(REV ? c * ITEMS + ITEMS : c * ITEMS - 1)];
    sb = id[0] != prev;
#pragma unroll
    for (int k = 1; k < ITEMS; ++k) sb |= (unsigned)(id[k] != id[k - 1]) << k;
  } else if (REV) {
    sb = __brev(nz) >> (32 - ITEMS);
  } else {
    unsigned prev = __shfl_up_sync(FULL, (nz >> 15) & 1u, 1);
    if (lane == 0) prev = edge[warp];
    sb = ((nz << 1) | prev) & 0xffffu;
  }
  sb = force_starts<REV>(sb, lo + (long long)c * ITEMS, m);

  // ---- the thread's scan, then the warp's, then the block's
  T acc;
  int fl;
  const unsigned seen = thread_scan(x, sb, acc, fl);
  T iv = acc;
  int ifl = fl;
  warp_scan(iv, ifl, lane);
  T xv = __shfl_up_sync(FULL, iv, 1);
  int xf = __shfl_up_sync(FULL, ifl, 1);
  if (lane == 0) {
    xv = T(0);
    xf = 0;
  }
  if (lane == 31) {
    wv[warp] = iv;
    wf[warp] = ifl;
    // the last warp's total is the tile's trailing-segment total when it
    // holds a start: publish the tile's prefix now
    if (warp == WARPS - 1 && ifl) put(w.pre + 2 * sd, iv, PUBLISHED);
  }
  scan_sync();

  T tot = T(0);
  int totf = 0;
  if (warp == 0) {
    T a = lane < WARPS ? wv[lane] : T(0);
    int af = lane < WARPS ? wf[lane] : 0;
    const int published = __shfl_sync(FULL, af, WARPS - 1);
    warp_scan(a, af, lane);
    const T ea = __shfl_up_sync(FULL, a, 1);
    const int eaf = __shfl_up_sync(FULL, af, 1);
    tot = __shfl_sync(FULL, a, WARPS - 1);
    totf = __shfl_sync(FULL, af, WARPS - 1);
    if (lane < WARPS) {
      wv[lane] = lane == 0 ? T(0) : ea;
      wf[lane] = lane == 0 ? 0 : eaf;
    }
    // a tile that holds a start knows its prefix; one that does not
    // publishes its aggregate, and its prefix once the carry is known
    if (lane == 0 && !published)
      put(totf ? w.pre + 2 * sd : w.agg + 2 * sd, tot, PUBLISHED);
  }
  carry_sync();                       // the carry is known
  if (tid == 0 && !totf) put(w.pre + 2 * sd, s_carry + tot, PUBLISHED);

  // ---- each element: its own prefix, after the thread's incoming one
  const T ex = xf ? xv : wv[warp] + xv;
  const int exf = xf | wf[warp];
  const T inc = exf ? ex : s_carry + ex;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (!((seen >> k) & 1u)) x[k] = inc + x[k];
  {
    T y[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) y[k] = REV ? x[ITEMS - 1 - k] : x[k];
    write_chunk<T>(sv, c, y);
  }
  scan_sync();
  store_tile<T>(w.out + row * m, lo, m, sv);

  // ---- the other bank cleared for the next call (no block of this call
  // reads it): tickets d, d + total, ... below the capacity, the four
  // words of each by four threads (d and the bank read again from shared
  // memory, so that neither stays in a register through the scan)
  const long long other = (long long)(s_bank ^ 1u) * w.capacity;
  for (long long t = s_ticket + (tid >> 2) * (long long)w.total;
       t < w.capacity; t += (THREADS / 4) * (long long)w.total)
    ((tid & 2) ? w.pre : w.agg)[2 * (other + t) + (tid & 1)] = 0ull;
}

inline long long tiles_of(long long m) { return (m + TILE - 1) / TILE; }

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

template <typename T, bool IDS>
constexpr size_t dyn_smem() {
  return sizeof(T) * PADDED +
         (IDS ? sizeof(int) * PADDED : 0);
}

template <typename T, bool IDS, bool REV>
int launch(const Work<T>& w, unsigned blocks, cudaStream_t s) {
  constexpr size_t bytes = dyn_smem<T, IDS>();
  if (bytes > 48 * 1024) {      // float64 with ids
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<T, IDS, REV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<T, IDS, REV><<<blocks, BLOCK, bytes, s>>>(w);
  return (int)cudaGetLastError();
}

// workspace of `capacity` tiles: the state word, then the aggregate slots
// and the prefix slots (16 bytes each) of two banks of `capacity`
template <typename T>
int run(const void* v, const void* ids, const void* end, void* out, void* ws,
        long long capacity, long long rows, long long m, int reverse,
        void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  if ((ids == nullptr) == (end == nullptr)) return (int)cudaErrorInvalidValue;
  const long long tpr = tiles_of(m);
  const long long tiles = rows * tpr;
  if (tiles > 0x7fffffffLL || tiles > capacity)
    return (int)cudaErrorInvalidValue;
  char* p = (char*)ws;
  Work<T> w;
  w.v = (const T*)v;
  w.ids = (const int*)ids;
  w.end = (const int8_t*)end;
  w.out = (T*)out;
  w.state = (u64*)p;
  p += 256;
  w.agg = (u64*)p;
  p += align256(32 * capacity);
  w.pre = (u64*)p;
  w.m = m;
  w.tiles_per_row = tpr;
  w.capacity = capacity;
  w.total = (unsigned)tiles;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)tiles;
  if (ids != nullptr)
    return reverse ? launch<T, true, true>(w, blocks, s)
                   : launch<T, true, false>(w, blocks, s);
  return reverse ? launch<T, false, true>(w, blocks, s)
                 : launch<T, false, false>(w, blocks, s);
}

}  // namespace

extern "C" {

// Elements a tile (the block's share of a row).
int segcumsum_tile() { return TILE; }

// Tiles a call on rows x m elements takes.
long long segcumsum_tiles(long long rows, long long m) {
  return rows > 0 && m > 0 ? rows * tiles_of(m) : 0;
}

// Bytes of a workspace for calls of up to `capacity` tiles.  The caller
// zeroes it once and keeps it for every later call on its stream.
size_t segcumsum_workspace_bytes(long long capacity) {
  return 256 + 2 * align256(32 * capacity);
}

// values and out (rows, m) contiguous on the current device; exactly one
// of ids (int32, m) and end (int8, m) given, the other null, shared by
// every row; reverse 0 or 1; ws of segcumsum_workspace_bytes(capacity)
// bytes for capacity >= segcumsum_tiles(rows, m), zero when it was made,
// kept with the same capacity for every call, and used by no other
// stream.
// Launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
int segcumsum_f32(const void* values, const void* ids, const void* end,
                  void* out, void* ws, long long capacity, long long rows,
                  long long m, int reverse, void* stream) {
  return run<float>(values, ids, end, out, ws, capacity, rows, m, reverse,
                    stream);
}

int segcumsum_f64(const void* values, const void* ids, const void* end,
                  void* out, void* ws, long long capacity, long long rows,
                  long long m, int reverse, void* stream) {
  return run<double>(values, ids, end, out, ws, capacity, rows, m, reverse,
                     stream);
}

}  // extern "C"
