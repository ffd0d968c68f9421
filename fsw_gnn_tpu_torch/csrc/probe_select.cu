// The rank loop's and the trig tails' operation mixes, each alone
// (float32): the probe P6.
//
// Replaces the TPU probe `run_probe` / `make_kernel`
// (benchmarks/probe_select_ceiling.py), which times kernels that are
// nothing but one loop body or one tail of the rank kernels, to measure
// the rate they can reach.  Each of its 21 bodies is an instance here (the
// table `BODIES` of the probe, in its order, mirrored by `BODY_NAMES` in
// fsw_gnn_tpu_torch/benchmarks/probe_select_ceiling.py), run as
// `make_kernel` runs it: for a table row of B entries and a slice,
//
//   acc = 0;  repeat REP times:  c = body(P, wn);  acc += sum_b c;
//                                P = P + 1e-30 c
//
// (the dependency keeps the repeats from being merged and leaves the
// compares' outcomes as they were), out (R, S) = acc.  The loop bodies
// (fma_anchor, select_add, rank) run B steps an element, c_i = sum_j of
// their term; the tails run once an element.  `jnp.sin`/`cos` are sinf/cosf,
// `jnp.round` (half to even) is rintf, `jnp.floor` floorf, and the
// polynomial bodies keep the probe's coefficients (`S_COEF`).  The
// production tails (`*_new`, `*_unif`) are the JAX rank kernels' `_trig`,
// `_trig_unif`, `_freq_consts` and `_sd` (fsw_gnn_tpu/ops/fsw_rank_pallas.py).
//
// Layout, by width (`probe_select_loop` says which loop a launch takes):
//
//   B <= rank_regs::W (32, the probe's width): a block holds one row's
//     slices, TSN = 128 threads, one a slice (a ragged last tile where S is
//     not a multiple of 128).  The three loop bodies run on the register
//     loop of rank_regs.cuh (`probe_select_regs`): each thread loads its
//     column once and keeps it in registers across the REP repeats, with
//     the row's weights read once from shared memory by broadcast; the
//     W x W pairs are unrolled, entries past B weigh 0.  `rank` is one
//     compare to 1.f/0.f and one fused multiply-add a pair (the tie rule
//     settled at compile time), `fma_anchor` one fused multiply-add,
//     `select_add` its select and add as written.  The other bodies keep
//     the column in shared memory as [b][TSN] and their arithmetic as
//     below.
//   wider rows: one block of TS = 64 threads per (row, tile of 64 slices),
//     the row's columns of P and c in shared memory as [b][64] and its
//     weights as [B]; a loop body keeps NI = 8 entries' sums in registers
//     for each pass over j, with the tie rule of `rank` as an integer
//     compare of the entry's index against j.
//
// Products f = 0.7 + 0.001 s are rounded twice, as the probe's float32
// iota is.
//
// What bounds it on an H100: issue.  The TPU probe's model counts
// operations an element-step (a fused multiply-add as 2); on this card the
// loop bodies' floor is their least issue slots a pair (fma_anchor 1,
// select_add 2, rank 2) at the FFMA issue rate, half of 67 TFLOP/s
// (`ISSUE_SLOTS` in the script).  The SASS of each instance
// (`cuobjdump -sass`) shows what the compares and selects compiled to.
//
// Three more bodies, not of the TPU table, price one pipe each: NI
// independent chains in registers, PIPE_STEPS steps an element, of one
// fused multiply-add (pipe_ffma: v = fma(v, a, P)), of one compare and one
// select (pipe_select: v = v < w ? P : w - P), or of the register loop's
// pair, a compare to 1.f/0.f and a fused multiply-add (pipe_rank:
// v = fma(w - P, v < w ? 1 : 0, P)), with one shared load and store an
// element, so that the issue rates of FFMA, of FSETP + FSEL and of FSET +
// FFMA can be compared without the loads that the loop bodies share.

#include <cuda_runtime.h>

#include "rank_regs.cuh"

namespace {

constexpr int TS = 64;            // slices a block, rows wider than W
constexpr int TSN = 128;          // slices a block, rows up to W
constexpr int W = rank_regs::W;
constexpr int NI = 8;
constexpr size_t SMEM_LIMIT = 232448;
constexpr int N_BODIES = 24;
constexpr int PIPE_STEPS = 64;

enum Body {
  FMA_ANCHOR, SELECT_ADD, RANK, FWD_TAIL, BWD_TAIL, SIN_ONLY, ROUND_ONLY,
  FLOOR_ONLY, SINCOS_POLY_ONLY, BWD_ARITH_ONLY, FWD_TAIL_POLY, BWD_TAIL_POLY,
  MAGIC_ROUND_ONLY, FWD_TAIL_POLY2, BWD_TAIL_POLY2, FWD_TAIL_NEW,
  BWD_TAIL_NEW, FWD_TAIL_UNIF, BWD_TAIL_UNIF, CAST_ROUND_ONLY,
  FLOOR_WRAP_ONLY, PIPE_FFMA, PIPE_SELECT, PIPE_RANK
};

__host__ __device__ constexpr bool loop_body(int body) {
  return body == FMA_ANCHOR || body == SELECT_ADD || body == RANK;
}

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float TWO_OVER_PI = 0.636619772367581343f;
constexpr float ONE_OVER_PI = 0.318309886183790672f;
constexpr float MAGIC = 12582912.f;     // 1.5 * 2^23

// S_COEF: (-1)^k (2 pi)^(2k+1) / (2k+1)!, k = 0 .. 6, rounded to float32
__constant__ float S_COEF[7] = {
    (float)6.283185307179586, (float)-41.341702240399755,
    (float)81.60524927607504, (float)-76.70585975306136,
    (float)42.058693944897634, (float)-15.094642576822984,
    (float)3.8199525848482803};

__device__ __forceinline__ float sgn(float u) {
  return u > 0.f ? 1.f : (u < 0.f ? -1.f : 0.f);
}

// the probe's Horner polynomial in t^2, times t
__device__ __forceinline__ float poly_t(float t) {
  const float t2 = t * t;
  float p = S_COEF[6];
#pragma unroll
  for (int k = 5; k >= 0; --k) p = p * t2 + S_COEF[k];
  return p * t;
}

// the probe's `_sin2pi`: quarter-period fold, then the polynomial
__device__ __forceinline__ float sin2pi_fold(float u) {
  const float a = fabsf(u);
  return sgn(u) * poly_t(fminf(a, 0.5f - a));
}

__device__ __forceinline__ float wrap_magic(float u) {
  return u - ((u + MAGIC) - MAGIC);
}

struct Trig {
  float sinc_t, cos_t, sin_t, cos_fw;
};

// `_trig_r2` (sinf/cosf, rintf), `_trig_poly` and `_trig_poly_magic`
template <int KIND>
__device__ __forceinline__ Trig trig_old(float ws, float c, float f) {
  Trig z;
  const float x = f * ws;
  float sin_fw;
  if (KIND == 0) {
    float u_cos = 0.5f * f * (2.f * c - ws);
    u_cos = u_cos - rintf(u_cos);
    const float ang = TWO_PI_F * u_cos;
    z.sin_t = sinf(ang);
    z.cos_t = cosf(ang);
    float u_sin = 0.5f * x;
    u_sin = u_sin - rintf(u_sin);
    const float ang2 = TWO_PI_F * u_sin;
    sin_fw = sinf(ang2);
    z.cos_fw = cosf(ang2);
  } else if (KIND == 1) {
    float u_cos = 0.5f * f * (2.f * c - ws);
    u_cos = u_cos - rintf(u_cos);
    z.sin_t = sin2pi_fold(u_cos);
    float uc = u_cos + 0.25f;
    z.cos_t = sin2pi_fold(uc - rintf(uc));
    float u_sin = 0.5f * x;
    u_sin = u_sin - rintf(u_sin);
    sin_fw = sin2pi_fold(u_sin);
    uc = u_sin + 0.25f;
    z.cos_fw = sin2pi_fold(uc - rintf(uc));
  } else {
    const float u_cos = wrap_magic(0.5f * f * (2.f * c - ws));
    z.sin_t = sin2pi_fold(u_cos);
    z.cos_t = sin2pi_fold(wrap_magic(u_cos + 0.25f));
    const float u_sin = wrap_magic(0.5f * x);
    sin_fw = sin2pi_fold(u_sin);
    z.cos_fw = sin2pi_fold(wrap_magic(u_sin + 0.25f));
  }
  const float safe = x == 0.f ? 1.f : x;
  z.sinc_t = x == 0.f ? 1.f : sin_fw / (PI_F * safe);
  return z;
}

// the production `_round_wrap` (float32), `_sincos2pi` (the shared fold)
__device__ __forceinline__ float round_wrap(float u) {
  return u - floorf(u + 0.5f);
}

__device__ __forceinline__ void sincos2pi(float u, float& s, float& c) {
  const float a = fabsf(u);
  c = poly_t(0.25f - a);
  const float m = poly_t(0.25f - fabsf(a - 0.25f));
  s = u < 0.f ? -m : m;
}

struct TrigNew {
  float sin_fw, cos_fw, sin_t, cos_t;
};

// `_trig` (UNIF false) and `_trig_unif` (UNIF true, wr the row's max)
template <bool UNIF>
__device__ __forceinline__ TrigNew trig_new(float ws, float wr, float c,
                                            float f) {
  TrigNew z;
  sincos2pi(round_wrap(0.5f * f * (2.f * c - ws)), z.sin_t, z.cos_t);
  if (UNIF) {
    float sr, cr;
    sincos2pi(round_wrap(0.5f * f * wr), sr, cr);
    z.sin_fw = ws == 0.f ? 0.f : sr;
    z.cos_fw = cr;
  } else {
    sincos2pi(round_wrap(0.5f * f * ws), z.sin_fw, z.cos_fw);
  }
  return z;
}

// the backward tail's arithmetic on its four trig values
__device__ __forceinline__ float bwd_arith(float P, float ws, float c,
                                           float f, float sinc_t, float cos_t,
                                           float sin_t, float cos_fw) {
  const float g1 = 1.f + f;
  const float sd = 2.f * ws * sinc_t * cos_t;
  const float dp = g1 * sd;
  const float dc = g1 * P * (-2.f * TWO_PI_F) * f * ws * sinc_t * sin_t;
  const float fsafe = f == 0.f ? 1.f : f;
  const float phi_f =
      2.f * ws *
      ((f == 0.f ? 0.f : (cos_fw - sinc_t) / fsafe) * cos_t -
       PI_F * (2.f * c - ws) * sinc_t * sin_t);
  return dp + dc + P * sd + P * phi_f;
}

__device__ __forceinline__ float bwd_new(float P, float ws, float c, float f,
                                         const TrigNew& z) {
  const float g1 = 1.f + f;
  const bool fz = f == 0.f;
  const float inv_f = fz ? 0.f : 1.f / f;
  const float c2f = TWO_OVER_PI * inv_f, inv2f = 2.f * inv_f,
              inv_pf = ONE_OVER_PI * inv_f;
  const float sd = (fz ? 2.f * ws : c2f * z.sin_fw) * z.cos_t;
  const float dp = g1 * sd;
  const float dc = g1 * P * (-4.f) * z.sin_fw * z.sin_t;
  const float phi_f = inv2f * (ws * z.cos_fw * z.cos_t -
                               inv_pf * z.sin_fw * z.cos_t -
                               (2.f * c - ws) * z.sin_fw * z.sin_t);
  return dp + dc + P * sd + P * phi_f;
}

__device__ __forceinline__ float fwd_new(float P, float ws, float f,
                                         const TrigNew& z) {
  const bool fz = f == 0.f;
  const float inv_f = fz ? 0.f : 1.f / f;
  const float c2f = TWO_OVER_PI * inv_f;
  const float sd = (fz ? 2.f * ws : c2f * z.sin_fw) * z.cos_t;
  return (1.f + f) * (P * sd);
}

// One element of a tail body: P, its weight ws, the row's largest weight
// wr and the slice's f.
template <int BODY>
__device__ __forceinline__ float tail(float P, float ws, float wr, float f) {
  const float c = 0.3f * P + ws;
  // the trig of the old tails: sinf/cosf, the polynomial, its magic wrap
  constexpr int KIND = (BODY == FWD_TAIL || BODY == BWD_TAIL) ? 0
                       : (BODY == FWD_TAIL_POLY || BODY == BWD_TAIL_POLY) ? 1
                                                                          : 2;
  if (BODY == FWD_TAIL || BODY == FWD_TAIL_POLY || BODY == FWD_TAIL_POLY2) {
    const Trig z = trig_old<KIND>(ws, c, f);
    return (1.f + f) * (P * (2.f * ws * z.sinc_t * z.cos_t));
  } else if (BODY == BWD_TAIL || BODY == BWD_TAIL_POLY ||
             BODY == BWD_TAIL_POLY2) {
    const Trig z = trig_old<KIND>(ws, c, f);
    return bwd_arith(P, ws, c, f, z.sinc_t, z.cos_t, z.sin_t, z.cos_fw);
  } else if (BODY == BWD_ARITH_ONLY) {
    return bwd_arith(P, ws, c, f, 0.2f * c + 0.1f, 0.3f * c - 0.2f,
                     0.1f * c + 0.4f, 0.25f * c);
  } else if (BODY == FWD_TAIL_NEW || BODY == FWD_TAIL_UNIF) {
    return fwd_new(P, ws, f, trig_new<BODY == FWD_TAIL_UNIF>(ws, wr, c, f));
  } else if (BODY == BWD_TAIL_NEW || BODY == BWD_TAIL_UNIF) {
    return bwd_new(P, ws, c, f, trig_new<BODY == BWD_TAIL_UNIF>(ws, wr, c, f));
  } else if (BODY == SIN_ONLY) {
    return sinf(P);
  } else if (BODY == ROUND_ONLY) {
    return P - rintf(P);
  } else if (BODY == FLOOR_ONLY) {
    return P - floorf(P);
  } else if (BODY == SINCOS_POLY_ONLY) {
    float u = P * 0.37f;
    u = u - rintf(u);
    float uc = u + 0.25f;
    const float s1 = sin2pi_fold(u), c1 = sin2pi_fold(uc - rintf(uc));
    float v = P * 0.11f + 0.05f;
    v = v - rintf(v);
    uc = v + 0.25f;
    const float s2 = sin2pi_fold(v), c2 = sin2pi_fold(uc - rintf(uc));
    return s1 * c2 + c1 * s2;
  } else if (BODY == MAGIC_ROUND_ONLY) {
    return wrap_magic(P);
  } else if (BODY == CAST_ROUND_ONLY) {
    const float half = P >= 0.f ? 0.5f : -0.5f;
    return P - (float)(int)(P + half);
  } else if (BODY == PIPE_FFMA || BODY == PIPE_SELECT || BODY == PIPE_RANK) {
    const float a = 0.5f + 0.25f * ws, z = ws - P;
    float v[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) v[k] = P + (0.25f * k - 1.f);
#pragma unroll
    for (int t = 0; t < PIPE_STEPS; ++t) {
#pragma unroll
      for (int k = 0; k < NI; ++k)
        v[k] = BODY == PIPE_FFMA   ? fmaf(v[k], a, P)
               : BODY == PIPE_RANK ? fmaf(z, v[k] < ws ? 1.f : 0.f, P)
                                   : (v[k] < ws ? P : z);
    }
    float sum = v[0];
#pragma unroll
    for (int k = 1; k < NI; ++k) sum += v[k];
    return sum;
  } else {   // FLOOR_WRAP_ONLY
    return P - floorf(P + 0.5f);
  }
}

// Every body on a row's columns in shared memory, a block of TSX threads
// per (row, tile of TSX slices): the layout of rows wider than W for all
// bodies (TSX = TS), and of rows up to W for the tails and pipe bodies
// (TSX = TSN).
template <int BODY, int TSX>
__global__ void probe_select_kernel(const float* __restrict__ P,
                                    const float* __restrict__ wn,
                                    float* __restrict__ out, int B, int S,
                                    int rep) {
  extern __shared__ float smem[];
  float* p_sm = smem;               // [B][TSX]
  float* c_sm = p_sm + B * TSX;     // [B][TSX]
  float* w_sm = c_sm + B * TSX;     // [B]
  const int r = blockIdx.x, tid = threadIdx.x, s = blockIdx.y * TSX + tid;
  const bool live = s < S;
  for (int b = tid; b < B; b += TSX) w_sm[b] = wn[(size_t)r * B + b];
  for (int b = 0; b < B; ++b)
    p_sm[b * TSX + tid] = live ? P[((size_t)r * B + b) * S + s] : 0.f;
  __syncthreads();
  const float f = __fadd_rn(0.7f, __fmul_rn(0.001f, (float)s));
  float wr = 0.f;
  for (int b = 0; b < B; ++b) wr = fmaxf(wr, w_sm[b]);
  float acc = 0.f;
  for (int it = 0; it < rep; ++it) {
    float sum = 0.f;
    if constexpr (loop_body(BODY)) {
      for (int i0 = 0; i0 < B; i0 += NI) {
        float p[NI], c[NI];
#pragma unroll
        for (int k = 0; k < NI; ++k) {
          p[k] = i0 + k < B ? p_sm[(i0 + k) * TSX + tid] : 0.f;
          c[k] = 0.f;
        }
        for (int j = 0; j < B; ++j) {
          const float pj = p_sm[j * TSX + tid], wj = w_sm[j];
#pragma unroll
          for (int k = 0; k < NI; ++k) {
            if (BODY == FMA_ANCHOR) {
              c[k] = c[k] + p[k] * wj;
            } else if (BODY == SELECT_ADD) {
              c[k] = c[k] + (pj < p[k] ? wj : 0.f);
            } else {
              const bool cond = pj < p[k] || (pj == p[k] && i0 + k >= j);
              c[k] = c[k] + (cond ? wj : 0.f);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < NI; ++k)
          if (i0 + k < B) c_sm[(i0 + k) * TSX + tid] = c[k];
      }
      for (int b = 0; b < B; ++b) {
        const float cb = c_sm[b * TSX + tid];
        sum += cb;
        p_sm[b * TSX + tid] = p_sm[b * TSX + tid] + 1e-30f * cb;
      }
    } else {
      for (int b = 0; b < B; ++b) {
        const float pb = p_sm[b * TSX + tid];
        const float cb = tail<BODY>(pb, w_sm[b], wr, f);
        sum += cb;
        p_sm[b * TSX + tid] = pb + 1e-30f * cb;
      }
    }
    acc += sum;
  }
  if (live) out[(size_t)r * S + s] = acc;
}

// A loop body on rows of B <= W entries, the column in registers: a block
// of TSN threads per (row, tile of TSN slices).  Thread s holds
// p[b] = P[r, b, s] and w[b] = wn[r, b] (0 past B) for the whole launch,
// c[i] = sum_j term(i, j) in the order j = 0 .. W-1, fully unrolled.
template <int BODY>
__global__ void __launch_bounds__(TSN)
    probe_select_regs(const float* __restrict__ P,
                      const float* __restrict__ wn, float* __restrict__ out,
                      int B, int S, int rep) {
  __shared__ float w_sm[W];
  const int r = blockIdx.x, tid = threadIdx.x, s = blockIdx.y * TSN + tid;
  const bool live = s < S;
  if (tid < W) w_sm[tid] = tid < B ? wn[(size_t)r * B + tid] : 0.f;
  float p[W], w[W], c[W];
#pragma unroll
  for (int b = 0; b < W; ++b)
    p[b] = (live && b < B) ? P[((size_t)r * B + b) * S + s] : 0.f;
  __syncthreads();
#pragma unroll
  for (int b = 0; b < W; ++b) w[b] = w_sm[b];
  float acc = 0.f;
  for (int it = 0; it < rep; ++it) {
    if constexpr (BODY == RANK) {
      rank_regs::rank(p, w, c);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) c[i] = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if constexpr (BODY == FMA_ANCHOR)
            c[i] = fmaf(p[i], w[j], c[i]);
          else
            c[i] = c[i] + (p[j] < p[i] ? w[j] : 0.f);
        }
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      if (b < B) sum += c[b];
      p[b] = p[b] + 1e-30f * c[b];
    }
    acc += sum;
  }
  if (live) out[(size_t)r * S + s] = acc;
}

// Whether body `body` at width B runs on the register loop.
__host__ __device__ constexpr bool on_registers(int body, int B) {
  return loop_body(body) && B <= W;
}

// Dynamic shared memory of the shared-memory layout at width B.
size_t smem_need(int B) {
  return sizeof(float) * (2 * (size_t)B * (B <= W ? TSN : TS) + B);
}

template <typename K>
int launch_kernel(K kern, int threads, size_t smem, const float* P,
                  const float* wn, float* out, int R, int B, int S, int rep,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)R, (unsigned)((S + threads - 1) / threads));
  kern<<<grid, threads, smem, stream>>>(P, wn, out, B, S, rep);
  return (int)cudaGetLastError();
}

template <int BODY>
int launch(const float* P, const float* wn, float* out, int R, int B, int S,
           int rep, cudaStream_t stream) {
  if constexpr (loop_body(BODY)) {
    if (on_registers(BODY, B))
      return launch_kernel(probe_select_regs<BODY>, TSN, 0, P, wn, out, R, B,
                           S, rep, stream);
  } else {
    if (B <= W)
      return launch_kernel(probe_select_kernel<BODY, TSN>, TSN, smem_need(B),
                           P, wn, out, R, B, S, rep, stream);
  }
  return launch_kernel(probe_select_kernel<BODY, TS>, TS, smem_need(B), P,
                       wn, out, R, B, S, rep, stream);
}

template <int BODY>
int dispatch(int body, const float* P, const float* wn, float* out, int R,
             int B, int S, int rep, cudaStream_t stream) {
  if (body == BODY) return launch<BODY>(P, wn, out, R, B, S, rep, stream);
  if constexpr (BODY + 1 < N_BODIES)
    return dispatch<BODY + 1>(body, P, wn, out, R, B, S, rep, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bodies in the table, and the dynamic shared memory a launch of a body on
// the shared-memory layout at width B needs.
int probe_select_bodies() { return N_BODIES; }

size_t probe_select_smem_bytes(int B) { return smem_need(B); }

// The loop a launch of body `body` at width B takes: 1 the register loop
// (rank_regs.cuh), 0 the shared-memory layout.
int probe_select_loop(int body, int B) {
  return on_registers(body, B) ? 1 : 0;
}

// Body `body` (an index of the table) on P (R, B, S) and wn (R, B), REP
// repeats, out (R, S): contiguous float32 on the current device.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int probe_select_f32(int body, const void* P, const void* wn, void* out,
                     int R, int B, int S, int rep, void* stream) {
  if (body < 0 || body >= N_BODIES || B <= 0 ||
      (!on_registers(body, B) &&
       (smem_need(B) > SMEM_LIMIT || (S + TS - 1) / TS > 65535)))
    return (int)cudaErrorInvalidValue;
  return dispatch<0>(body, (const float*)P, (const float*)wn, (float*)out, R,
                     B, S, rep, (cudaStream_t)stream);
}

}  // extern "C"
