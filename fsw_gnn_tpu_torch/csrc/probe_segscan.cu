// K3's probes P5 (the segmented scan's inner-loop variants) and P2 (the
// boundary-mask scan cut into stages), float32.
//
// Replaces two TPU probes of K3, the segmented cumsum:
//   * P5, benchmarks/probe_segscan_variants.py `segcumsum` → `kernel`, with
//     its inner loops `row_segscan_roll`, `_shift` / `row_segscan_shift` and
//     `row_segscan_fma`: the segmented inclusive cumsum of values (n,) by
//     sorted int32 ids, whose rows of 128 are scanned by lane doubling in one
//     of three forms, then carried across rows and tiles;
//   * P2, benchmarks/probe_fill_floor.py `build` → `kernel`: five nested
//     functions of values (n,) >= 0 and an int8 is_end mask of 0 and 1 (1 on
//     the last element of each segment), over rows of 128:
//       io       v + is_end;
//       fill k   k running-max passes, the element 2^i before (0 before the
//                row), then + is_end;
//       mxu_only the in-row inclusive prefix p plus the count of ends strictly
//                before the element in its row;
//       nofill   p plus the row and tile carry (the carry chains through rows
//                with no end in lanes 0..126 and none at the previous row's
//                last lane; an element takes it when no end lies before it in
//                its row);
//       full     the segmented cumsum: p minus the fill-forward base (p at the
//                last end before the element in its row, by the running max,
//                which needs v >= 0), plus the same carry.
//
// Design.  A warp holds a row as four consecutive elements a lane (one
// 16-byte load of values, one of ids or one 4-byte load of mask bytes); a
// block of 8 warps walks `block_rows` rows (a multiple of 32) in chunks of
// 32, each warp 4 rows in registers (at most 128 registers a thread, so
// that two blocks share an SM and one loads while the other scans).  In a
// row:
//   * P5's loops run the TPU loops' seven doubling passes, strides 1 .. 64:
//     `roll` takes the element `stride` before with wrap-around
//     (`__shfl_sync` from lane - stride / 4 mod 32) and masks lanes below the
//     stride; `shift` takes it by `__shfl_up_sync` with the fill of `_shift`
//     (value 0, id -2) below; `fma` shifts alike and adds
//     shifted * (float)(ids equal).  Strides 1 and 2 take an element from the
//     lane's own registers or the lane below.
//   * P2's prefix is a lane's sequential sum and a warp scan of lane totals
//     (float adds: nothing on the card corresponds to the TPU's matrix
//     product); its end count a warp scan of popcounts; its fill passes
//     shuffle like `shift`.
// The carry is deterministic and uses no atomics on values.  Within a chunk
// warp 0 scans the 32 rows' (trailing value, chains-into-the-next-row)
// pairs with warp shuffles, a row a lane, after the chunk before (the block's loop takes
// the place of the TPU's sequential grid); each element of a row's leading
// segment takes its row's carry.  Each block publishes its last element's
// value, whether it depends on anything before the block, and how many of
// its first elements form its leading segment; a second launch adds to
// those the block's carry: the aggregates folded in block order from the
// nearest block that does not chain (a warp finds it by ballots, 32 blocks
// a read).  P5's MAXSEG and P2's carry depth, which truncate the TPU's row
// carry, are not needed: the result is exact for any segment length.
//
// What bounds it on an H100: memory.  P5 reads values and ids and writes the
// output, 12 bytes an element; P2 reads values and the mask and writes, 9.
// The second launch reads the blocks' 12 bytes and rewrites only leading
// segments that chain into a block.  The in-row passes are shuffles, seven
// a row for P5 (14 for ids and values) and P2's fill; their instruction
// rate, not the bytes, is what the variants and the stages price.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;            // a row
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = 4;                // rows a warp holds in a chunk
constexpr int CHUNK = WARPS * RPW;    // rows a chunk: one a lane of a warp
constexpr int MIN_BLOCKS = 2;         // blocks an SM the registers allow
constexpr int PASSES = 7;             // log2(LANES)
constexpr unsigned FULL = 0xffffffffu;

enum { P5 = 0, P2 = 1 };                              // the probe
enum { ROLL = 0, SHIFT = 1, FMA = 2 };                // P5's loops
enum { IO = 0, FILL = 1, MXU = 2, NOFILL = 3, SEGSCAN = 4 };  // P2's stages

template <int KIND, int MODE>
struct Carried {
  static constexpr bool value = KIND == P5 || MODE >= NOFILL;
};

struct Args {
  const float* v;
  const int* ids;             // P5
  const int8_t* end;          // P2
  float* out;
  float* agg;                 // a block's last element, without its carry
  int* fresh;                 // whether that value needs no carry
  int* lead;                  // the block's first elements that take it
  long long n, rows, block_rows;
  int passes;                 // P2's fill passes
};

// x of the lane `lanes` below: wrapped around the warp (WRAP), or `fill`
// below lane `lanes`.
template <bool WRAP, typename T>
__device__ __forceinline__ T from_below(T x, int lanes, int lane, T fill) {
  if (WRAP) return __shfl_sync(FULL, x, (lane - lanes) & 31);
  const T y = __shfl_up_sync(FULL, x, lanes);
  return lane < lanes ? fill : y;
}

// y[k]: the element `stride` before element k of the lane's four (the lane
// holds elements 4 lane .. 4 lane + 3 of the row).
template <bool WRAP, typename T>
__device__ __forceinline__ void shifted(const T (&x)[4], int stride, int lane,
                                        T fill, T (&y)[4]) {
  if (stride >= 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = from_below<WRAP>(x[k], stride >> 2, lane, fill);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = k >= stride ? x[k - stride]
                         : from_below<WRAP>(x[k - stride + 4], 1, lane, fill);
  }
}

// P5: the row's segmented inclusive scan, seven doubling passes in the
// variant's form.
template <int VAR>
__device__ __forceinline__ void row_segscan(float (&v)[4], const int (&s)[4],
                                            int lane) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int stride = 1 << p;
    float pv[4];
    int ps[4];
    shifted<VAR == ROLL>(v, stride, lane, 0.f, pv);
    shifted<VAR == ROLL>(s, stride, lane, -2, ps);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (VAR == ROLL) {
        const bool ok = 4 * lane + k >= stride && ps[k] == s[k];
        v[k] = v[k] + (ok ? pv[k] : 0.f);
      } else if (VAR == SHIFT) {
        v[k] = v[k] + (ps[k] == s[k] ? pv[k] : 0.f);
      } else {
        v[k] = v[k] + pv[k] * (float)(ps[k] == s[k]);
      }
    }
  }
}

// P2: `passes` running-max passes (the element 2^i before, 0 before the row).
__device__ __forceinline__ void fill_max(float (&b)[4], int passes, int lane) {
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (p < passes) {
      float y[4];
      shifted<false>(b, 1 << p, lane, 0.f, y);
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = fmaxf(b[k], y[k]);
    }
  }
}

// P2: the row's inclusive prefix, in place.
__device__ __forceinline__ void row_prefix(float (&x)[4], int lane) {
  x[1] = x[0] + x[1];
  x[2] = x[1] + x[2];
  x[3] = x[2] + x[3];
  float t = x[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, t, o);
    if (lane >= o) t = y + t;
  }
  float ex = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) ex = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = ex + x[k];
}

// P2: ends strictly before each of the lane's elements in the row (bit k
// of eb: element k is an end).
__device__ __forceinline__ void strict_ends(unsigned eb, int lane,
                                            int (&c)[4]) {
  int t = __popc(eb);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, t, o);
    if (lane >= o) t += y;
  }
  int ex = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) ex = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = ex + __popc(eb & ((1u << k) - 1u));
}

// Inclusive scan over a warp of (v, f) pairs in the monoid
// (a, fa) then (b, fb) = (fb ? b : a + b, fa | fb).
__device__ __forceinline__ void warp_scan(float& v, int& f, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float pv = __shfl_up_sync(FULL, v, o);
    const int pf = __shfl_up_sync(FULL, f, o);
    if (lane >= o) {
      if (!f) v = pv + v;
      f |= pf;
    }
  }
}

template <int KIND, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) rows_kernel(Args a) {
  constexpr bool CARRY = Carried<KIND, MODE>::value;
  __shared__ float s_t[CHUNK], s_c[CHUNK];
  __shared__ int s_f[CHUNK], s_g[CHUNK];
  __shared__ float s_carry;
  __shared__ int s_lead;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * a.block_rows;
  const long long start = row0 * LANES;
  const long long rows_here =
      a.rows - row0 < a.block_rows ? a.rows - row0 : a.block_rows;
  const long long len = a.n - start < rows_here * LANES ? a.n - start
                                                         : rows_here * LANES;
  const int bfirst = KIND == P5 ? a.ids[start] : 0;
  if (tid == 0) {
    s_carry = 0.f;
    s_lead = (int)len;
  }
  __syncthreads();

  for (long long c0 = 0; c0 < rows_here; c0 += CHUNK) {
    float x[RPW][4];
    unsigned lead = 0;        // bit 4 j + k: element k of row j takes C
    int lead_at = (int)len;   // the block's first element not leading
    // ---- loads: all the warp's rows at once
    int s[RPW][4];
    unsigned eb[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const long long r = row0 + c0 + warp * RPW + j;
      const long long e = r * LANES + 4 * lane;
      if (r < row0 + rows_here && e + 3 < a.n) {
        const float4 q = *reinterpret_cast<const float4*>(a.v + e);
        x[j][0] = q.x; x[j][1] = q.y; x[j][2] = q.z; x[j][3] = q.w;
        if (KIND == P5) {
          const int4 u = *reinterpret_cast<const int4*>(a.ids + e);
          s[j][0] = u.x; s[j][1] = u.y; s[j][2] = u.z; s[j][3] = u.w;
        } else {
          eb[j] = *reinterpret_cast<const unsigned*>(a.end + e);
        }
      } else {
        eb[j] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = r < row0 + rows_here && e + k < a.n;
          x[j][k] = in ? a.v[e + k] : 0.f;
          if (KIND == P5) s[j][k] = in ? a.ids[e + k] : 0x7fffffff;
          else eb[j] |= (unsigned)(uint8_t)(in ? a.end[e + k] : 1) << (8 * k);
        }
      }
    }
    // ---- each row
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int rb = (int)(c0 + warp * RPW + j);   // row in the block
      const long long r = row0 + rb;
      const bool live = rb < rows_here;
      const int e_in = rb * LANES + 4 * lane;      // element in the block
      float t = 0.f;
      int single = 0, g = 0;
      if (KIND == P5) {
        row_segscan<MODE>(x[j], s[j], lane);
        const int first = __shfl_sync(FULL, s[j][0], 0);
        const int last = __shfl_sync(FULL, s[j][3], 31);
        t = __shfl_sync(FULL, x[j][3], 31);
        single = first == last;
        g = rb > 0 && live && first == a.ids[r * LANES - 1];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lead |= (unsigned)(s[j][k] == first) << (4 * j + k);
          if (s[j][k] != bfirst && e_in + k < lead_at) lead_at = e_in + k;
        }
      } else {
        float f[4];
        unsigned bits = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int8_t m = (int8_t)(eb[j] >> (8 * k));
          f[k] = (float)m;
          bits |= (unsigned)(m != 0) << k;
        }
        if (MODE == IO) {
#pragma unroll
          for (int k = 0; k < 4; ++k) x[j][k] = x[j][k] + f[k];
        } else if (MODE == FILL) {
          fill_max(x[j], a.passes, lane);
#pragma unroll
          for (int k = 0; k < 4; ++k) x[j][k] = x[j][k] + f[k];
        } else {
          int cs[4];
          strict_ends(bits, lane, cs);
          row_prefix(x[j], lane);
          if (MODE == MXU) {
#pragma unroll
            for (int k = 0; k < 4; ++k) x[j][k] = x[j][k] + (float)cs[k];
          } else {
            if (MODE == SEGSCAN) {
              // base: p at the last end before each element, by the
              // running max of p at the ends shifted in by one
              float b[4], be[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) be[k] = bits >> k & 1u ? x[j][k] : 0.f;
              shifted<false>(be, 1, lane, 0.f, b);
              fill_max(b, PASSES, lane);
#pragma unroll
              for (int k = 0; k < 4; ++k) x[j][k] = x[j][k] - b[k];
            }
            t = __shfl_sync(FULL, x[j][3], 31);
            single = __shfl_sync(FULL, cs[3], 31) == 0;   // none in 0..126
            g = rb > 0 && live && a.end[r * LANES - 1] == 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              lead |= (unsigned)(cs[k] == 0) << (4 * j + k);
              if ((bits >> k & 1u) && e_in + k + 1 < lead_at)
                lead_at = e_in + k + 1;
            }
          }
        }
      }
      if (CARRY && lane == 0) {
        const int rc = warp * RPW + j;
        s_t[rc] = live ? t : 0.f;
        s_f[rc] = !(live && single && g);
        s_g[rc] = g;
      }
    }
    if (CARRY) {
      const unsigned at = __reduce_min_sync(FULL, (unsigned)lead_at);
      if (lane == 0) atomicMin(&s_lead, (int)at);
      __syncthreads();
      // ---- the chunk's rows, one a lane: o_r = t_r + (chains ? o_{r-1} :
      // 0) after the chunk before; C_r = g_r ? o_{r-1} : 0
      if (warp == 0) {
        float o = s_t[lane];
        int f = s_f[lane];
        warp_scan(o, f, lane);
        const float cin = s_carry;
        if (!f) o = cin + o;
        float before = __shfl_up_sync(FULL, o, 1);
        if (lane == 0) before = cin;
        s_c[lane] = s_g[lane] ? before : 0.f;
        __syncwarp();
        if (lane == 31) s_carry = o;
      }
      __syncthreads();
    }
    // ---- stores
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const long long r = row0 + c0 + warp * RPW + j;
      const long long e = r * LANES + 4 * lane;
      if (CARRY) {
        const float cr = s_c[warp * RPW + j];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          x[j][k] = x[j][k] + ((lead >> (4 * j + k) & 1u) ? cr : 0.f);
      }
      if (r < row0 + rows_here && e + 3 < a.n) {
        *reinterpret_cast<float4*>(a.out + e) =
            make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      } else if (r < row0 + rows_here) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (e + k < a.n) a.out[e + k] = x[j][k];
      }
    }
  }
  if (CARRY && tid == 0) {
    const bool chained =
        blockIdx.x > 0 && (KIND == P5 ? a.ids[start] == a.ids[start - 1]
                                      : a.end[start - 1] == 0);
    a.agg[blockIdx.x] = s_carry;
    a.lead[blockIdx.x] = s_lead;
    a.fresh[blockIdx.x] = !(chained && s_lead >= len);
  }
}

// The blocks' carries: block b's leading elements take the value of the
// element before the block, folded in block order from the nearest block
// whose last element needs no carry.
template <int KIND>
__global__ void __launch_bounds__(THREADS) carry_kernel(Args a) {
  __shared__ float s_cin;
  const long long b = blockIdx.x;
  const long long start = b * a.block_rows * LANES;
  if (b == 0) return;
  const bool chained = KIND == P5 ? a.ids[start] == a.ids[start - 1]
                                  : a.end[start - 1] == 0;
  if (!chained) return;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long j0 = b - 1, first = 0;
    for (;; j0 -= 32) {
      const long long j = j0 - lane;
      const unsigned m = __ballot_sync(FULL, j < 0 || a.fresh[j] != 0);
      if (m) {
        first = j0 - (__ffs(m) - 1);
        break;
      }
    }
    float c = 0.f;
    for (long long j = first; j < b; j += 32) {
      const float y = j + lane < b ? a.agg[j + lane] : 0.f;
      const int cnt = b - j < 32 ? (int)(b - j) : 32;
      for (int q = 0; q < cnt; ++q) {
        const float z = __shfl_sync(FULL, y, q);
        c = j == first && q == 0 ? z : c + z;
      }
    }
    if (lane == 0) s_cin = c;
  }
  __syncthreads();
  const float c = s_cin;
  const long long len = a.lead[b];
  for (long long i = threadIdx.x; i < len; i += THREADS)
    a.out[start + i] = a.out[start + i] + c;
}

template <int KIND, int MODE>
int launch(const Args& a, long long blocks, cudaStream_t s) {
  rows_kernel<KIND, MODE><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !Carried<KIND, MODE>::value) return (int)e;
  carry_kernel<KIND><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

inline long long blocks_of(long long n, long long block_rows) {
  const long long rows = (n + LANES - 1) / LANES;
  return (rows + block_rows - 1) / block_rows;
}

Args make_args(const void* v, const void* ids, const void* end, void* out,
               void* agg, void* fresh, void* lead, long long n,
               long long block_rows, int passes) {
  Args a;
  a.v = (const float*)v;
  a.ids = (const int*)ids;
  a.end = (const int8_t*)end;
  a.out = (float*)out;
  a.agg = (float*)agg;
  a.fresh = (int*)fresh;
  a.lead = (int*)lead;
  a.n = n;
  a.rows = (n + LANES - 1) / LANES;
  a.block_rows = block_rows;
  a.passes = passes;
  return a;
}

}  // namespace

extern "C" {

// Blocks of a call on n elements, `block_rows` rows of 128 a block: the
// entries of each scratch array (agg float32, fresh and lead int32).
long long probe_segscan_blocks(long long n, long long block_rows) {
  return n > 0 && block_rows > 0 ? blocks_of(n, block_rows) : 0;
}

// P5: out (n,) the segmented inclusive cumsum of values (n,) by sorted ids
// (n,) int32, variant 0 roll, 1 shift, 2 fma; `block_rows` rows of 128 a
// block, a positive multiple of 32 (a chunk).  All pointers
// on the current device, values, ids and out 16-byte aligned.  Launches
// two kernels on `stream`; returns cudaGetLastError() (0 on success), does
// not synchronise.
int probe_segscan_variant_f32(const void* values, const void* ids, void* out,
                              void* agg, void* fresh, void* lead, long long n,
                              long long block_rows, int variant,
                              void* stream) {
  if (n <= 0) return 0;
  if (block_rows <= 0 || block_rows % CHUNK) return (int)cudaErrorInvalidValue;
  const Args a = make_args(values, ids, nullptr, out, agg, fresh, lead, n,
                           block_rows, 0);
  const long long blocks = blocks_of(n, block_rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case ROLL: return launch<P5, ROLL>(a, blocks, s);
    case SHIFT: return launch<P5, SHIFT>(a, blocks, s);
    case FMA: return launch<P5, FMA>(a, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// P2: out (n,) the stage's function of values (n,) >= 0 and the is_end
// mask (n,) int8 of 0 and 1: stage 0 io, 1 fill (`passes` passes, 0 .. 7),
// 2 mxu_only, 3 nofill, 4 full; `block_rows` rows of 128 a block, a
// positive multiple of 32.  values and out 16-byte
// aligned, the mask 4-byte aligned.  Launches one kernel (two for nofill
// and full) on `stream`; returns cudaGetLastError(), does not synchronise.
int probe_segscan_stage_f32(const void* values, const void* end, void* out,
                            void* agg, void* fresh, void* lead, long long n,
                            long long block_rows, int stage, int passes,
                            void* stream) {
  if (n <= 0) return 0;
  if (block_rows <= 0 || block_rows % CHUNK || passes < 0 || passes > PASSES)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(values, nullptr, end, out, agg, fresh, lead, n,
                           block_rows, passes);
  const long long blocks = blocks_of(n, block_rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case IO: return launch<P2, IO>(a, blocks, s);
    case FILL: return launch<P2, FILL>(a, blocks, s);
    case MXU: return launch<P2, MXU>(a, blocks, s);
    case NOFILL: return launch<P2, NOFILL>(a, blocks, s);
    case SEGSCAN: return launch<P2, SEGSCAN>(a, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
