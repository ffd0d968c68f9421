// A float32 matrix product on Hopper's warpgroup tensor-core instructions
// (`wgmma.mma_async` on TF32), with float32's accuracy by the 3xTF32 split:
// the tile routine of probe P1's `routine='wgmma'` (probe_matmul.cu, the one
// source that includes this header).  K1's own routine, `tile_product` in
// fsw_rank_common.cuh, is untouched.
//
// What it computes: C[i][j] = sum_k A(i, k) B(j, k) for one work unit, with
// A (M x K) and B (N x K) each given either K-major (element (i, k) at
// p[i ld + k]) or MN-major (at p[k ld + i]).  A unit is one 128 x 128
// output tile of one range of k (`Params`: the dv contractions split k
// into fixed ranges, and dv_loop also takes one b a group).
//
// Design, per block (256 threads, two warpgroups; one block an SM,
// persistent over units):
//
//   a ring of STAGES = 4 raw chunks of KC = 32 k in shared memory, staged
//     four chunks ahead of their use along the block's units, each
//     completing on its slot's `mbarrier`; a slot is staged again once
//     every thread is past its use (the barrier ending each chunk).
//     An operand whose base is 16-byte aligned and whose strides are
//     multiples of 16 bytes goes by TMA (`cp.async.bulk.tensor` from
//     thread 0: a K-major chunk as 128 rows x 32 k, 128-byte swizzled, the
//     layout the `wgmma` descriptors read: row i at 128 i bytes, its
//     16-byte group q at position q ^ (i % 8); an MN-major one as 32 k x
//     128 i); any other by `cp.async` from every thread, 16 bytes a copy:
//     each row's groups from the 16-byte boundary at or before its first
//     value, which the readers skip (`shift_of`).  The wrapper pads rows
//     to 16 bytes where that pays (`probe_kernel_matmul.pads_operand`).
//   the two warpgroups take 64 rows of the tile each.  For each chunk, one
//     pass of all 256 threads reads B's raw chunk
//     once and writes hi = tf32(x) and lo = tf32(x - hi) in the swizzled
//     K-major layout (transposing an MN-major B on the way: `wgmma` takes
//     TF32 operands from shared memory K-major only) into one of two split
//     buffers.  A is split in registers: each consumer loads its fragments
//     of a k8 step (the m64n8k8 layout: rows g and g + 8 of its warp's 16,
//     k t and t + 4) from the raw chunk and splits them there, two steps
//     ahead of the products at most (two register sets), so A's halves
//     never go through shared memory.  B's chunk c + 1 is split while
//     chunk c's last products run.
//   Each k8 step issues three `wgmma` m64n128k8 (lo_a hi_b, hi_a lo_b,
//     hi_a hi_b, as `tile_product` orders them; lo_a lo_b, 2^-22 of the
//     product, is dropped) into a chunk accumulator that the chunk's first
//     `wgmma` zeroes (scale-d = 0); it is added to the unit's float32 sum
//     once a chunk.  The tensor cores' truncating additions thus stay
//     within a chunk's 12 products, and every element sums its chunks in
//     the order of k, so two calls give the same bits.  The split rounds
//     as `cvt.rna.tf32.f32` (to nearest, ties away), in integer operations.
//   Where N <= 64 and both operands are K-major (K1's dZ at D = 64), the
//     tiles are 64 columns wide (m64n64k8): half the products and B's
//     split of a 128-column tile whose half is zeros.
//   The epilogue stages a warpgroup's 64 x 128 sums through shared memory
//     (the split buffers, free by then; 8-float groups swizzled by row)
//     and writes rows of C coalesced.
//
// Shared memory: 4 stages x 36 KB raw, 2 x 32 KB split, barriers: 210 KB.
// Registers: 255 a thread at most (256 threads, one block an SM; a ninth
// warp, a producer, would cut that to 168); a thread holds two 64-float
// accumulators and 16 of A's halves.
//
// TMA's tensor maps are encoded on the host with the driver's
// `cuTensorMapEncodeTiled`, reached through `cudaGetDriverEntryPoint`, so
// the library links against the runtime alone (no -lcuda).

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tf32x3 {

constexpr int BM = 128;                 // rows of an output tile
constexpr int BN = 128;                 // columns of an output tile (64
                                        // where N <= 64: `Params::bn`)
constexpr int KC = 32;                  // k of a chunk: one 128-byte row
constexpr int STAGES = 4;               // raw chunks in the ring
constexpr int THREADS = 256;            // two warpgroups
constexpr int OP_FLOATS = BM * KC;      // one operand's chunk: 16 KB
constexpr int RK = KC + 4;              // a K-major row staged by cp.async
constexpr int RMN = BM + 4;             // an MN-major row staged by cp.async
constexpr int OP_RAW = BM * RK;         // the largest raw operand chunk
constexpr int RAW_FLOATS = 2 * OP_RAW;  // A and B of a stage
constexpr int SPLIT_FLOATS = 2 * OP_FLOATS;      // hi B, lo B
constexpr size_t SMEM_BYTES =
    sizeof(float) * (STAGES * RAW_FLOATS + 2 * SPLIT_FLOATS) + 1024 + 1024;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
static_assert(BM * BN <= 2 * SPLIT_FLOATS, "the epilogue's staging");
static_assert(KC * RMN <= OP_RAW, "an MN-major raw chunk");
static_assert((OP_RAW * 4) % 1024 == 0, "1024-aligned raw operands");

// how the producer stages an operand, and so how its raw chunk is laid
// out: TMA_K swizzled K-major rows of 32 k; TMA_MN [KC][BM]; CP_K [BM][RK]
// and CP_MN [KC][RMN], each row the 16-byte groups that cover its values
// from the one at or before its first, that value `shift` floats in
enum Mode { TMA_K = 0, TMA_MN = 1, CP_K = 2, CP_MN = 3 };
__host__ __device__ constexpr bool k_major(int mode) {
  return mode == TMA_K || mode == CP_K;
}

struct Params {
  // A: (i, k) at a[i lda + k] (K-major) or a[k lda + i] (MN-major); group
  // g of the units starts at a + g a_group.  The same for B.
  const float* a; long long lda; long long a_group; int M;
  const float* b; long long ldb; long long b_group; int N;
  float* c; long long ldc; long long c_unit;   // unit z writes c + z c_unit
  int K;          // k of a group
  int chunk;      // k of a split (a multiple of KC)
  int splits;     // splits a group; units along z = groups x splits
  int nz;
  int tiles_m, tiles_n, bn;   // bn: the tile's columns, BN or 64
  long long a_len, b_len;   // floats from a and b to their tensors' ends
};

__host__ __device__ inline int cdiv32(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

struct Unit {
  int m0, n0, z, g, kb, ke;
  long long a_off, b_off;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit w;
  const int tn = u % p.tiles_n;
  const int tm = (u / p.tiles_n) % p.tiles_m;
  w.z = u / (p.tiles_n * p.tiles_m);
  w.m0 = tm * BM;
  w.n0 = tn * p.bn;
  w.g = w.z / p.splits;
  w.kb = (w.z % p.splits) * p.chunk;
  w.ke = min(p.K, w.kb + p.chunk);
  w.a_off = w.g * p.a_group;
  w.b_off = w.g * p.b_group;
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void bar_arrive_cp(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---- the producer's copies -------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// float offset of element (i, k) in the swizzled K-major chunk layout
__device__ __forceinline__ int swz(int i, int k) {
  return i * KC + ((((k >> 2) ^ i) & 7) << 2) + (k & 3);
}

// One operand's view for a chunk: values (i, k) for rows r0 + i < n and
// k0 + k < ke, at p[(r0 + i) ld + k0 + k] (K-major) or p[(k0 + k) ld + r0
// + i] (MN-major); p starts the unit's group, len floats before the end.
struct Src {
  const float* p;
  long long ld, len;
  int n, r0, k0, ke;
};

// floats from the 16-byte boundary at or before the first value of raw
// row `row` (K-major: i; MN-major: k) of s's chunk: the address mod 16,
// in 32-bit arithmetic (a product's low bits are exact)
template <int MODE>
__device__ __forceinline__ int shift_of(const Src& s, int row) {
  const uint32_t at =
      MODE == CP_K ? (uint32_t)(s.r0 + row) * (uint32_t)s.ld + s.k0
                   : (uint32_t)(s.k0 + row) * (uint32_t)s.ld + s.r0;
  return (int)(((uint32_t)(reinterpret_cast<uintptr_t>(s.p) >> 2) + at) &
               3u);
}

// Stage a chunk by cp.async, 16 bytes a copy, by the block's threads
// (`tid`): each row's groups from the boundary at or before its first
// value, clipped at the tensor's end; rows past n and k past ke are not
// copied (the consumers read them as zeros).
template <int MODE>
__device__ __forceinline__ void stage_cp(float* dst, const Src& s, int tid) {
  if (MODE == CP_K) {           // BM rows of KC / 4 + 1 groups
    constexpr int G = KC / 4 + 1;
    for (int e = tid; e < BM * G; e += THREADS) {
      const int i = e / G, q = e - i * G;
      if (s.r0 + i >= s.n) continue;
      const long long at = (long long)(s.r0 + i) * s.ld + s.k0;
      const int sh = shift_of<CP_K>(s, i);
      if (4 * q - sh >= s.ke - s.k0) continue;
      const long long from = at - sh + 4 * q;
      const long long left = s.len - from;
      cp16(dst + i * RK + 4 * q, s.p + from,
           left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0));
    }
  } else {                      // KC rows of BM / 4 + 1 groups
    constexpr int G = BM / 4 + 1;
    for (int e = tid; e < KC * G; e += THREADS) {
      const int k = e / G, q = e - k * G;
      if (s.k0 + k >= s.ke) continue;
      const long long at = (long long)(s.k0 + k) * s.ld + s.r0;
      const int sh = shift_of<CP_MN>(s, k);
      if (4 * q - sh >= s.n - s.r0) continue;
      const long long from = at - sh + 4 * q;
      const long long left = s.len - from;
      cp16(dst + k * RMN + 4 * q, s.p + from,
           left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0));
    }
  }
}

// a K-major chunk: box (32 k, 128 rows) at (k0, r0)
__device__ __forceinline__ void tma_k(float* dst, const CUtensorMap* map,
                                      uint64_t* bar, int k0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0),
      "r"(r0)
      : "memory");
}

// an MN-major chunk: box (128 i, 1 group, 32 k) at (r0, g, k0)
__device__ __forceinline__ void tma_mn(float* dst, const CUtensorMap* map,
                                       uint64_t* bar, int r0, int g, int k0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(r0),
      "r"(g), "r"(k0)
      : "memory");
}

template <int MODE>
__device__ __forceinline__ void stage_operand(float* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, const Src& s,
                                              int g, int tid) {
  if (MODE == TMA_K) {
    if (tid == 0) tma_k(dst, map, bar, s.k0, s.r0);
  } else if (MODE == TMA_MN) {
    if (tid == 0) tma_mn(dst, map, bar, s.r0, g, s.k0);
  } else {
    stage_cp<MODE>(dst, s, tid);
  }
}

// ---- the consumers' split --------------------------------------------------

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the bits of `cvt.rna.tf32.f32` for every finite x, in two integer
// operations
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// element (i, k) of a raw chunk
template <int MODE>
__device__ __forceinline__ float raw_at(const float* raw, const Src& s, int i,
                                        int k) {
  if (MODE == TMA_K) return raw[swz(i, k)];
  if (MODE == TMA_MN) return raw[k * BM + i];
  if (s.r0 + i >= s.n || s.k0 + k >= s.ke) return 0.f;
  if (MODE == CP_K) return raw[i * RK + shift_of<CP_K>(s, i) + k];
  return raw[k * RMN + shift_of<CP_MN>(s, k) + i];
}

// Four values of group c of row i of a raw chunk.
template <int MODE>
__device__ __forceinline__ float4 raw_group(const float* raw, const Src& s,
                                            int i, int c) {
  if (MODE == TMA_K)
    return *reinterpret_cast<const float4*>(raw + swz(i, 4 * c));
  if (MODE == CP_K) {           // one row: one shift, one row test
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s.r0 + i < s.n) {
      const float* row = raw + i * RK + shift_of<CP_K>(s, i) + 4 * c;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (s.k0 + 4 * c + q < s.ke) v[q] = row[q];
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  return make_float4(raw_at<MODE>(raw, s, i, 4 * c),
                     raw_at<MODE>(raw, s, i, 4 * c + 1),
                     raw_at<MODE>(raw, s, i, 4 * c + 2),
                     raw_at<MODE>(raw, s, i, 4 * c + 3));
}

// One pass over B's raw chunk: its hi and lo into split buffer `sp` (hi,
// then lo), by the 256 consumer threads (`ct`).
template <int MB, int TN>
__device__ __forceinline__ void split_b(const float* raw, const Src& src,
                                        float* sp, int ct) {
#pragma unroll 1
  for (int e = ct; e < TN * KC / 4; e += THREADS) {   // B's first TN rows
    const int i = e % TN, c = e / TN;
    const int off = swz(i, 4 * c);
    const float4 v = raw_group<MB>(raw, src, i, c);
    float4 h, l;
    h.x = tf32_rna(v.x); l.x = tf32_rna(v.x - h.x);
    h.y = tf32_rna(v.y); l.y = tf32_rna(v.y - h.y);
    h.z = tf32_rna(v.z); l.z = tf32_rna(v.z - h.z);
    h.w = tf32_rna(v.w); l.w = tf32_rna(v.w - h.w);
    *reinterpret_cast<float4*>(sp + off) = h;
    *reinterpret_cast<float4*>(sp + OP_FLOATS + off) = l;
  }
}

// A's fragments of k8 step s of a chunk for a consumer (rows r and r + 8
// of the tile, k 8 s + t and 8 s + t + 4: the m64n8k8 register layout),
// split in registers.
template <int MA>
__device__ __forceinline__ void split_a(const float* raw, const Src& src,
                                        int r, int t, int s,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float x =
        raw_at<MA>(raw, src, r + 8 * (v & 1), 8 * s + t + 4 * (v >> 1));
    const float h = tf32_rna(x);
    hi[v] = __float_as_uint(h);
    lo[v] = __float_as_uint(tf32_rna(x - h));
  }
}

// ---- wgmma ---------------------------------------------------------------

// descriptor of a K-major, 128-byte-swizzled operand at `p` (1024-aligned
// for its first k8 step): leading offset unused (1), stride 1024 bytes
// between groups of 8 rows, layout 1 = SWIZZLE_128B
__device__ __forceinline__ uint64_t make_desc(const float* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 over the warpgroup) = A (64 x 8, the warpgroup's registers)
// B (128 x 8 at descriptor db)^T + scale_d d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same for a 64-column tile: d (64 x 64 over the warpgroup)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the view of A (a = true) or B of chunk k0 .. k0 + KC - 1 of unit w
__device__ __forceinline__ Src src_of(const Params& p, const Unit& w, bool a,
                                      int k0) {
  Src s;
  s.p = a ? p.a + w.a_off : p.b + w.b_off;
  s.ld = a ? p.lda : p.ldb;
  s.len = a ? p.a_len - w.a_off : p.b_len - w.b_off;
  s.n = a ? p.M : p.N;
  s.r0 = a ? w.m0 : w.n0;
  s.k0 = k0;
  s.ke = w.ke;
  return s;
}

// One chunk's products, B's halves in split buffer P (0
// or 1), A's raw chunk in slot n % STAGES.  A's halves go two k8 steps at
// a time through two register sets (a step's three products are one wgmma
// group; a set is split again once its group is done); then, while the
// last products run, the next chunk's B halves into buffer 1 - P.
template <int P, int MA, int MB, int TN>
__device__ __forceinline__ void chunk_step(
    float (&acc)[TN / 2], float (&part)[TN / 2], const float* ring,
    float* split, uint64_t* full, int n, const Params& prm, const Unit& w,
    int c, int nk, int ra, int t, int tid) {
  const float* sp = split + P * SPLIT_FLOATS;
  const float* raw_a = ring + (n % STAGES) * RAW_FLOATS;
  const Src src_a = src_of(prm, w, true, w.kb + c * KC);
  const uint64_t hib = make_desc(sp);
  const uint64_t lob = make_desc(sp + OP_FLOATS);
  uint32_t ahi[2][4], alo[2][4];
  fence_regs(part);
#pragma unroll
  for (int s = 0; s < KC / 8; ++s) {
    const int q = s & 1;
    if (s >= 2) {                 // step s - 2's group no longer reads set q
      wgmma_wait<1>();
      fence_regs(ahi[q]);
      fence_regs(alo[q]);
    }
    split_a<MA>(raw_a, src_a, ra, t, s, ahi[q], alo[q]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // a k8 step is 32 bytes further along the swizzled row
    wgmma_tf32(part, alo[q], hib + 2 * s, s > 0);
    wgmma_tf32(part, ahi[q], lob + 2 * s, 1);
    wgmma_tf32(part, ahi[q], hib + 2 * s, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  fence_regs(part);
  if (c + 1 < nk) {
    const int m = n + 1;
    bar_wait(full + m % STAGES, (m / STAGES) & 1);
    split_b<MB, TN>(ring + (m % STAGES) * RAW_FLOATS + OP_RAW,
                src_of(prm, w, false, w.kb + (c + 1) * KC),
                split + (1 - P) * SPLIT_FLOATS, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    fence_regs(ahi[q]);
    fence_regs(alo[q]);
  }
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] += part[i];
  named_sync(1, THREADS);         // chunk n's raw slot and split buffer P
}                                 // are free

// The block's chunks in order (its units, each unit's chunks), each staged
// into slot i % STAGES, i its number; `u` at or past `units` when all are.
struct Loader {
  int u, k0, issued;
  Unit w;
};

// l at its unit's chunk k0, or the first later one there is
__device__ __forceinline__ void settle(const Params& p, Loader& l,
                                       int units) {
  while (l.u < units && l.k0 >= l.w.ke) {
    l.u += gridDim.x;
    if (l.u < units) {
      l.w = unit_of(p, l.u);
      l.k0 = l.w.kb;
    }
  }
}

// Stage the loader's next chunk, if any: by TMA from thread 0, or by
// cp.async from every thread; every thread arrives on the slot's barrier.
template <int MA, int MB>
__device__ __forceinline__ void issue(const Params& p, Loader& l, int units,
                                      const CUtensorMap* map_a,
                                      const CUtensorMap* map_b, float* ring,
                                      uint64_t* full, int tid) {
  if (l.u >= units) return;
  const int slot = l.issued % STAGES;
  float* raw = ring + slot * RAW_FLOATS;
  if (tid == 0)
    bar_arrive_tx(full + slot,
                  (MA == TMA_K || MA == TMA_MN ? 4 * OP_FLOATS : 0) +
                      (MB == TMA_K || MB == TMA_MN ? 4 * OP_FLOATS : 0));
  stage_operand<MA>(raw, map_a, full + slot, src_of(p, l.w, true, l.k0),
                    l.w.g, tid);
  stage_operand<MB>(raw + OP_RAW, map_b, full + slot,
                    src_of(p, l.w, false, l.k0), l.w.g, tid);
  bar_arrive_cp(full + slot);
  ++l.issued;
  l.k0 += KC;
  settle(p, l, units);
}

// ---- the kernel --------------------------------------------------------------

template <int MA, int MB, int TN>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-aligned base for the swizzled layouts
  float* base = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  float* ring = base;                              // STAGES x RAW_FLOATS
  float* split = ring + STAGES * RAW_FLOATS;       // 2 x SPLIT_FLOATS
  uint64_t* full = reinterpret_cast<uint64_t*>(split + 2 * SPLIT_FLOATS);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      bar_init(full + s, THREADS + 1);   // every thread, and expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int units = p.tiles_m * p.tiles_n * p.nz;
  // the warpgroup, read from lane 0 so that the compiler knows it is the
  // same on every lane (wgmma outside a provably uniform path is
  // serialized)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wt = tid & 127;
  const int warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 64 * wg + 16 * warp + g;      // its first row of A
  Loader l;
  l.u = blockIdx.x;
  l.issued = 0;
  l.w = unit_of(p, l.u);
  l.k0 = l.w.kb;
  settle(p, l, units);
  for (int s = 0; s < STAGES; ++s)
    issue<MA, MB>(p, l, units, &map_a, &map_b, ring, full, tid);
  int n = 0;                                   // chunks used so far
  float acc[TN / 2], part[TN / 2];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(p, u);
    const int nk = w.ke > w.kb ? cdiv32(w.ke - w.kb, KC) : 0;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = part[i] = 0.f;
    if (nk > 0) {
      bar_wait(full + n % STAGES, (n / STAGES) & 1);
      split_b<MB, TN>(ring + (n % STAGES) * RAW_FLOATS + OP_RAW,
                  src_of(p, w, false, w.kb), split, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1, THREADS);
    }
    for (int c = 0; c < nk; c += 2) {
      chunk_step<0, MA, MB, TN>(acc, part, ring, split, full, n, p, w, c, nk,
                                ra, t, tid);
      issue<MA, MB>(p, l, units, &map_a, &map_b, ring, full, tid);
      ++n;
      if (c + 1 < nk) {
        chunk_step<1, MA, MB, TN>(acc, part, ring, split, full, n, p, w,
                                  c + 1, nk, ra, t, tid);
        issue<MA, MB>(p, l, units, &map_a, &map_b, ring, full, tid);
        ++n;
      }
    }
    // ---- epilogue: through shared memory, rows of C coalesced -----------
    // (8-float groups of row r at group ^ (r % 4): the float2 stores of a
    // half warp and the row reads fall on distinct banks)
    float* out = split + wg * 64 * TN;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h, col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(out + r * TN + (col ^ ((r & 3) << 3))) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    named_sync(2 + wg, 128);
    const int nj = min(TN, p.N - w.n0);
    float* cz = p.c + (long long)w.z * p.c_unit;
    const int col = wt % TN;
    for (int r = wt / TN; r < 64; r += 128 / TN) {
      const int row = w.m0 + 64 * wg + r;
      if (row >= p.M) break;
      if (col < nj)
        cz[row * p.ldc + w.n0 + col] = out[r * TN + (col ^ ((r & 3) << 3))];
    }
    named_sync(1, THREADS);    // the staging is split space again
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// 16-byte aligned: the base, and every stride a multiple of 4 floats.
inline bool aligned(const float* p, long long ld, long long group) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0 &&
         group % 4 == 0;
}

// The tensor map of a K-major operand (`rows` rows of K): boxes of 128
// rows x 32 k, swizzled 128 bytes, zeros past the extents.
inline bool encode_k(CUtensorMap* map, const float* p, long long ld,
                     int rows, int K) {
  const EncodeTiled fn = encoder();
  if (!fn || K <= 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {KC, BM};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)p, dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of an MN-major operand: `rows` i (contiguous), `groups`
// groups `group` floats apart, K k `ld` floats apart; boxes of 128 i x 1
// group x 32 k, unswizzled, zeros past the extents.
inline bool encode_mn(CUtensorMap* map, const float* p, long long ld,
                      long long group, int rows, int groups, int K) {
  const EncodeTiled fn = encoder();
  if (!fn || K <= 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)rows, (cuuint64_t)groups,
                              (cuuint64_t)K};
  const cuuint64_t strides[2] = {(cuuint64_t)(group > 0 ? group : ld) *
                                     sizeof(float),
                                 (cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[3] = {BM, 1, KC};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)p, dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MA, int MB, int TN>
inline int launch_modes(const CUtensorMap& ma, const CUtensorMap& mb,
                        const Params& p, cudaStream_t stream) {
  auto kern = wgmma_kernel<MA, MB, TN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const long long units = (long long)p.tiles_m * p.tiles_n * p.nz;
  const int grid = (int)(units < sms ? units : sms);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

// B by TMA (mode TB) where tb, else by cp.async (mode CB)
template <int MA, int TB, int CB, int TN = BN>
inline int launch_b(const CUtensorMap& ma, const CUtensorMap& mb, bool tb,
                    const Params& p, cudaStream_t stream) {
  return tb ? launch_modes<MA, TB, TN>(ma, mb, p, stream)
            : launch_modes<MA, CB, TN>(ma, mb, p, stream);
}

// Launch the product of `p` (tiles filled in here); a_k / b_k say that A /
// B are K-major.  Each operand goes by TMA where it is 16-byte aligned
// (`aligned`) and its map encodes, else by cp.async.
inline int launch(Params p, bool a_k, bool b_k, cudaStream_t stream) {
  // a contraction over K-major operands with N <= 64 (K1's dZ at D = 64)
  // takes 64-column tiles: half the products and B's split
  const bool narrow = a_k && b_k && p.N <= 64;
  p.bn = narrow ? 64 : BN;
  p.tiles_m = cdiv32(p.M, BM);
  p.tiles_n = cdiv32(p.N, p.bn);
  if (p.M <= 0 || p.N <= 0 || p.nz <= 0) return 0;
  if ((long long)p.tiles_m * p.tiles_n * p.nz >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // cp.async reads 16-byte groups from each operand's base on
  if ((reinterpret_cast<uintptr_t>(p.a) & 15) ||
      (reinterpret_cast<uintptr_t>(p.b) & 15))
    return (int)cudaErrorInvalidValue;
  const int groups = p.nz / p.splits;
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  const bool ta =
      aligned(p.a, p.lda, p.a_group) &&
      (a_k ? encode_k(&ma, p.a, p.lda, p.M, p.K)
           : encode_mn(&ma, p.a, p.lda, p.a_group, p.M, groups, p.K));
  const bool tb =
      aligned(p.b, p.ldb, p.b_group) &&
      (b_k ? encode_k(&mb, p.b, p.ldb, p.N, p.K)
           : encode_mn(&mb, p.b, p.ldb, p.b_group, p.N, groups, p.K));
  if (narrow)
    return ta ? launch_b<TMA_K, TMA_K, CP_K, 64>(ma, mb, tb, p, stream)
              : launch_b<CP_K, TMA_K, CP_K, 64>(ma, mb, tb, p, stream);
  if (a_k && b_k)
    return ta ? launch_b<TMA_K, TMA_K, CP_K>(ma, mb, tb, p, stream)
              : launch_b<CP_K, TMA_K, CP_K>(ma, mb, tb, p, stream);
  if (a_k)
    return ta ? launch_b<TMA_K, TMA_MN, CP_MN>(ma, mb, tb, p, stream)
              : launch_b<CP_K, TMA_MN, CP_MN>(ma, mb, tb, p, stream);
  if (!b_k)
    return ta ? launch_b<TMA_MN, TMA_MN, CP_MN>(ma, mb, tb, p, stream)
              : launch_b<CP_MN, TMA_MN, CP_MN>(ma, mb, tb, p, stream);
  return (int)cudaErrorInvalidValue;      // no contraction needs it
}

}  // namespace tf32x3
