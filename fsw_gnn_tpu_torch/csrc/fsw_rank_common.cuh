// Device code shared by the weighted-rank FSW kernels: the fused-projection
// pair K1f / K1b (fsw_rank_fwdp.cu, fsw_rank_bwdp.cu), the unfused pair
// K2f / K2b (fsw_rank_fwd.cu, fsw_rank_bwd.cu) and the cartesian pair
// K4f / K4b (fsw_rank_cart_fwd.cu, fsw_rank_cart_bwd.cu).  One copy of the
// rank loop, the trig, the backward's entry kernel (K1b, K2b and K4b run
// it), the deterministic column sums and K1's tensor-core tile product
// (`tile_product`, at the end), so the kernels compute the same bits from
// the same inputs.
//
// For a table row r with weights wn[0 .. B-1], phantom mass pad and one
// slice of frequency f, a forward thread owns one slice and holds its
// column P[r, :, s] in shared memory, laid out [b][thread] (TS threads a
// block) so a warp's accesses fall on consecutive banks (the backward's
// layout is [b][slice of its tile], read by several threads a slice):
//
//   c[i]   = sum_j wn[j] * 1[P[j] < P[i] or (P[j] == P[i] and j <= i)]
//            + pad * 1[P[i] > 0]
//   out    = (1 + f) * sum_i P[i] * sd_i,
//   sd_i   = (2 / (pi f)) sin(pi f wn_i) cos(pi f (2 c_i - wn_i)),
//            with the exact f == 0 limit 2 wn_i cos(...).
//
// c is summed in the order j = 0 .. B-1, as the TPU kernels' `_rank_c` and
// the plain PyTorch versions do, so it agrees with them to the bit wherever
// the projections agree.
//
// Trig accuracy: the phase pi f (2c - w) reaches about 1600 rad at the
// 'spread' frequencies (f up to 2S - 1), so the period is reduced exactly:
// u = f (2c - w) / 2 and cospi(2u) = cos(2 pi u), whose range reduction in
// CUDA's sinpi/cospi is exact (no __sinf).
//
// Zero-weight (padding) entries must contribute exactly 0 to the output and
// to every gradient, whatever their projection: sin(pi f 0) is exactly 0
// from sinpif, the uniform_w row value is forced to 0 there, and the f == 0
// limit 2 w cos A is 0 at w = 0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TS = 64;             // slices a forward block (one thread each)
constexpr int MAX_SPLIT = 256;     // partials a single reduction pass sums
constexpr int RED_THREADS = 256;   // threads of a column-sum block
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block may use

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

inline size_t align64(size_t n) { return (n + 63) / 64 * 64; }

constexpr int NI = 8;              // entries ranked together (rank_core)

// The one rank loop of the six kernels: the inclusive weighted ranks of
// entries i0 .. i0 + NI - 1 of column `col` of a [b][ld] layout (the
// forwards: ld = TS, col = their thread), with the pad shift pr, summed in
// the order j = 0 .. B-1 as `_rank_c` does (entries past B get p = 0 and a
// rank nobody reads); with POS also each entry's position in the column's
// order under the tie rule, #{j : p_j < p_i or (p_j == p_i and j < i)}.
// One pass over the row serves NI entries: every p_j and wn_j loaded from
// shared memory feeds NI independent sums.  The tie rule (p_j == p_i
// precedes for j <= i) is settled by ranges: a j below the group precedes
// on <=, a j above it on <, and the group's own NI x NI pairs are unrolled,
// so whether j <= i is known and each pair is one compare.  A pair costs
// the predicate as 1.f or 0.f (one FSET) and a fused multiply-add
// c = w_j s + c, which rounds exactly as c + (pred ? w_j : 0) (w_j 1 + c
// is c + w_j, rounded once; w_j 0 + c is c), so c is the plain version's
// to the bit; POS adds s to a float count (exact below 2^24), one add
// more.  The order is total, so a column's positions are a permutation of
// 0 .. B-1 (a NaN projection, which precedes nothing, is put at 0: it may
// share that position, but never leaves the column).
template <bool POS>
__device__ __forceinline__ void rank_core(const float* p_sm,
                                          const float* w_sm, int B, int ld,
                                          int col, int i0, float pr,
                                          float (&p)[NI], float (&c)[NI],
                                          int (&pos)[NI]) {
  float n[NI];
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    p[k] = (i0 + k < B) ? p_sm[(i0 + k) * ld + col] : 0.f;
    c[k] = 0.f;
    n[k] = 0.f;
  }
  int j = 0;
  for (; j < i0; ++j) {
    const float p_j = p_sm[j * ld + col], w_j = w_sm[j];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const float s = (p_j <= p[k]) ? 1.f : 0.f;
      c[k] = fmaf(w_j, s, c[k]);
      if (POS) n[k] += s;
    }
  }
#pragma unroll
  for (int jj = 0; jj < NI; ++jj, ++j) {
    if (j >= B) break;
    const float p_j = p_sm[j * ld + col], w_j = w_sm[j];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const float s = (jj <= k ? p_j <= p[k] : p_j < p[k]) ? 1.f : 0.f;
      c[k] = fmaf(w_j, s, c[k]);
      if (POS) n[k] += s;
    }
  }
  for (; j < B; ++j) {
    const float p_j = p_sm[j * ld + col], w_j = w_sm[j];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const float s = (p_j < p[k]) ? 1.f : 0.f;
      c[k] = fmaf(w_j, s, c[k]);
      if (POS) n[k] += s;
    }
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    c[k] += (p[k] > 0.f) ? pr : 0.f;
    pos[k] = POS ? max((int)n[k] - 1, 0) : 0;
  }
}

// K2f's and K4f's row staging, which skips the padding.  w_sm holds the
// row's B weights (staged by the block, then a barrier); thread tid stores
// its column of P (from pr, stride S; zeros where !live) at the entries of
// nonzero weight only, in their order, as p_sm[0 .. d-1][TS], and w_sm is
// compacted in place to those entries' weights.  Returns d; the caller
// ranks and sums over d entries as if the width were d.  Every thread runs
// the same count over w_sm (the branch is uniform across the block), and
// warp 0 compacts w_sm after a barrier, 32 weights a pass: a pass writes
// at or below the words it read and below every word a later pass reads.
// This needs no shared memory beyond the row's own.
//
// Dropping a zero-weight j from every other entry's rank leaves c bit-equal
// (fmaf(0, s, c) is c), and the entry's own term is
// p (2/(pi f)) sin(pi f 0) cos(.) = +-0, so the sums keep their order and
// their bits wherever the padded projections are finite; a padded entry
// whose projection is not finite now contributes exactly 0 too, as the
// header's contract states.  (Splitting a slice's groups over several
// threads that share one column copy, as the backward's entry kernel does,
// was slower here: see PERF.md.)
// The second half of stage_kept: after a barrier that follows every
// thread's last read of the row's B weights, warp 0 compacts w_sm in place
// to its nonzero weights, in their order, 32 a pass (a pass writes at or
// below the words it read and below every word a later pass reads); a
// barrier ends it.  Every thread of the block calls it.
__device__ __forceinline__ void compact_kept_weights(float* w_sm, int B,
                                                     int tid) {
  if (tid < 32) {
    int base = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const float w = b0 + tid < B ? w_sm[b0 + tid] : 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, w != 0.f);
      __syncwarp();
      if (w != 0.f) w_sm[base + __popc(m & ((1u << tid) - 1u))] = w;
      base += __popc(m);
      __syncwarp();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int stage_kept(float* p_sm, float* w_sm,
                                          const float* pr, int B, int S,
                                          int tid, bool live) {
  int d = 0;
  for (int b0 = 0; b0 < B; b0 += NI) {
    float v[NI];
    bool keep[NI];
    // the chunk's loads are all issued before its stores
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int b = b0 + k;
      keep[k] = b < B && w_sm[b] != 0.f;
      v[k] = (keep[k] && live) ? pr[(size_t)b * S] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < NI; ++k)
      if (keep[k]) p_sm[(d++) * TS + tid] = v[k];
  }
  __syncthreads();
  compact_kept_weights(w_sm, B, tid);
  return d;
}

// The forward quadrature's constants of one frequency f: sin_row is
// sin(pi f wr) of the uniform row weight wr (uniform_w: every real entry of
// the row has the same weight, recovered as the row max).
struct FwdFreq {
  float f, c2f, sin_row;
  bool fz;
};

__device__ __forceinline__ FwdFreq fwd_freq(float f, int uniform_w,
                                            float wr) {
  FwdFreq z;
  z.f = f;
  z.fz = f == 0.f;
  const float inv_f = z.fz ? 0.f : 1.f / f;
  z.c2f = 0.636619772367581343f * inv_f;  // (2 / pi) / f
  z.sin_row = uniform_w ? sinpif(2.f * (0.5f * f * wr)) : 0.f;
  return z;
}

// sd_i of an entry of weight w and rank c at one frequency; uniform_w
// forces sin(pi f w) to exactly 0 at the padded (zero-weight) entries,
// whose projections need not be zero.
__device__ __forceinline__ float fwd_sd(const FwdFreq& z, float w, float c,
                                        int uniform_w) {
  float sin_fw;
  if (uniform_w) {
    sin_fw = (w == 0.f) ? 0.f : z.sin_row;
  } else {
    sin_fw = sinpif(2.f * (0.5f * z.f * w));
  }
  const float u = 0.5f * z.f * (2.f * c - w);
  const float cos_t = cospif(2.f * u);
  return (z.fz ? 2.f * w : z.c2f * sin_fw) * cos_t;
}

// The forward of one (row, slice): thread `tid`'s column of P in p_sm
// ([B][TS]), the row's weights in w_sm ([B]).  Returns out[r, s].  K2f
// passes its kept entries (stage_kept), K1f the whole row.
__device__ __forceinline__ float rank_fwd_slice(const float* p_sm,
                                                const float* w_sm, int B,
                                                int tid, float f, float pr,
                                                int uniform_w) {
  float wr = 0.f;
  if (uniform_w) {
    for (int j = 0; j < B; ++j) wr = fmaxf(wr, w_sm[j]);
  }
  const FwdFreq z = fwd_freq(f, uniform_w, wr);
  float acc = 0.f;
  for (int i0 = 0; i0 < B; i0 += NI) {
    float p[NI], c[NI];
    int unused[NI];
    rank_core<false>(p_sm, w_sm, B, TS, tid, i0, pr, p, c, unused);
#pragma unroll
    for (int k = 0; k < NI; ++k)
      if (i0 + k < B)
        acc = fmaf(p[k], fwd_sd(z, w_sm[i0 + k], c[k], uniform_w), acc);
  }
  return (1.f + f) * acc;
}

// The sum over a warp's 32 lanes, complete in lane 0 (a fixed tree: the
// same bits every call).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---- the backward's entry kernel (K1b, K2b, K4b) ---------------------------
//
// One block per (table row r, tile of tsb slices); K threads a slice (its
// parts), each ranking every K-th group of NI entries against the whole
// column, which the K read from one copy in shared memory (`entry_shape`:
// K = 4 from B = 25 with with_dw, from B = 33 without).  Warp w takes
// slices 32 (w % M) .. + 31 of the tile (M = tsb / 32) as part w / M, so a
// warp's lanes stay on 32 consecutive slices and its dP stores coalesce.
// For F frequencies f = F[s, k] and cotangents g = G[r, s, k] (K2b and K1b:
// F = 1) it writes
//   dP[r, i, s] = sum_k (1 + f) g sd_i                      (R, B, S)
//   dfr[r, s, k] = g (q + (1 + f) sum_i p_i phi_f,i)         this row's df
// and with with_dw the tile's partial sums of dwn and dpad:
//   dwn_j = sum_{s,k} (1 + f) g p_j 2 cos(A_j - pi f w_j) + T_j,
//   T_j   = sum_i dc_i M_ij,  M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)],
//   dpad  = sum_i dc_i [p_i > 0],  dc_i = sum_k (1 + f) g p_i (-4) sin(pi f
//           w_i) sin A_i.
//
// The transposed term in O(B).  The rank pass also counts each entry's
// position pos_i under the tie rule of M (rank_core<true>, one add a pair).
// The order is total, so j precedes-or-equals i exactly when
// pos_j <= pos_i, and T_j is the sum of dc over the positions from pos_j
// on: each thread scatters its entries' dc to their positions (x_sm), one
// thread a slice sums that column from the end once, and each entry reads
// its term at its position.  Per pair this costs three instructions (a
// compare to 0/1, a fused multiply-add for c, an add for the count), where
// the previous design's rank loop and its second B x B loop cost about
// three each; a bitonic sort of (p, index) in shared memory would cost
// about 14k operations a slice at B = 100 (1792 compare-exchanges of 8 at
// B' = 128, and a block barrier a stage) against the count's 10k.
// dwn therefore sums T in the columns' sorted order; the direct term and T
// are summed over each warp's slices by shuffles (warp_sum, a fixed tree),
// the M warps' sums added in order; dpad adds each thread's entries in its
// groups' order and the block's threads in the order t = 0 .. K tsb - 1.
//
// Occupancy.  A block holds one copy of its P columns, dc by position and
// the 16-bit positions (10 bytes an entry-slice with with_dw, 4 without),
// so K threads a slice share 10 B tsb bytes: at B = 100, K = 4, tsb = 32 a
// block is 4 warps in 33.2 KB, 6 blocks (24 warps) an SM; the previous
// design held two 4-byte columns for one thread a slice (8 warps an SM).
//
// Latency.  At narrow B a block's work is short, so the global loads of its
// prologue (the P columns, 8 rows a batch, the tile's frequencies and
// cotangents, the weights) are all issued before the first store to shared
// memory: one round trip, not one after another.
//
// Frequencies.  NF = 1 or NF_WIDE (the paths' F): each thread holds its q
// and qf sums of every frequency in registers and the parts fold them into
// the shared [F][tsb] arrays once, in the order h = 0 .. K-1.  NF = 0, any
// other F: K = 1, the sums accumulate in the shared arrays (the previous
// design's path).  The frequencies, 1/f, the cotangents (and the uniform
// row trig) of the tile stay in shared [F][tsb] arrays, staged coalesced
// from the (S, F) and (R, S, F) layouts.
//
// Lanes past S run on zeros (p = 0, f = 0, g = 0: every term exactly 0) so
// that every lane of a warp takes part in the shuffles; a warp wholly past
// S skips the loops.  P and dP may be the same buffer: the block stages its
// columns before any thread writes dP.  No float atomics: two calls give
// the same bits.

constexpr int KMAX = 4;       // threads a slice at most
constexpr int NF_WIDE = 8;    // the other frequency count with an instance

// The entry kernel's block: K threads a slice, tsb slices a tile.
struct EntryShape {
  int K, tsb;
};

// Dynamic shared memory of the entry kernel at width B, F frequencies and
// block shape (K, tsb): floats [B][tsb] P (and with with_dw dc by
// position), [F][tsb] f, 1/f, g, q, qf (and without with_dw the uniform
// row's sin and cos), [B] wn, with with_dw [tsb / 32][B] dwn sums and
// [K tsb] dpad terms; then with with_dw the [B][tsb] 16-bit positions.
inline size_t entry_need(int B, int F, int with_dw, int K, int tsb) {
  const size_t col = (size_t)B * tsb, fc = (size_t)F * tsb;
  const size_t floats =
      with_dw ? 2 * col + 5 * fc + B + (size_t)(tsb / 32) * B + (size_t)K * tsb
              : col + 7 * fc + B;
  return sizeof(float) * floats + (with_dw ? sizeof(unsigned short) * col : 0);
}

// The block shape at width B: a slice's groups of NI entries split over up
// to KMAX threads where the frequency sums live in registers, with with_dw
// or above B = 32 (narrower rows without with_dw need little shared memory,
// their blocks fill the SM already, and one thread a slice pays the fixed
// costs of a slice once); one thread a slice otherwise, 64 slices a tile
// where that fits and 32 where not.
inline EntryShape entry_shape(int B, int F, int with_dw) {
  int K = (F == 1 || F == NF_WIDE) && (with_dw || B > 32) ? cdiv(B, NI) : 1;
  K = K < 1 ? 1 : (K > KMAX ? KMAX : K);
  const int tsb =
      (K == 1 && entry_need(B, F, with_dw, 1, 64) <= SMEM_LIMIT) ? 64 : 32;
  return {K, tsb};
}

inline size_t entry_smem_bytes(int B, int F, int with_dw) {
  const EntryShape e = entry_shape(B, F, with_dw);
  return entry_need(B, F, with_dw, e.K, e.tsb);
}

// Slice tiles of the entry kernel's grid: the count of its partials.
inline int entry_tiles(int B, int S, int F, int with_dw) {
  return cdiv(S, entry_shape(B, F, with_dw).tsb);
}

template <int NF, bool DW>
__global__ void __launch_bounds__(KMAX * 32)
rank_bwd_entry_kernel(const float* P, float* dP, const float* __restrict__ wn,
                      const float* __restrict__ pad,
                      const float* __restrict__ freqs,
                      const float* __restrict__ G, float* __restrict__ dfr,
                      float* __restrict__ dwn_part,
                      float* __restrict__ dpad_part, int R, int B, int S,
                      int F, int K, int tsb, int unif) {
  extern __shared__ float smem[];
  if (NF > 0) F = NF;
  const int M = tsb >> 5;
  const int cn = B * tsb, fc = F * tsb;
  float* p_sm = smem;                     // [B][tsb]  projections
  float* x_sm = p_sm + cn;                // [B][tsb]  dc by position (DW)
  float* f_sm = x_sm + (DW ? cn : 0);     // [F][tsb]  frequencies
  float* if_sm = f_sm + fc;               // [F][tsb]  1 / f, 0 at f == 0
  float* g_sm = if_sm + fc;               // [F][tsb]  cotangents
  float* q_sm = g_sm + fc;                // [F][tsb]  sum p phi, then df
  float* qf_sm = q_sm + fc;               // [F][tsb]  sum p phi_f
  float* sr_sm = qf_sm + fc;              // [F][tsb]  row sin(pi f w) (!DW)
  float* cr_sm = sr_sm + (DW ? 0 : fc);   // [F][tsb]  row cos(pi f w) (!DW)
  float* w_sm = cr_sm + (DW ? 0 : fc);    // [B]       wn[r]
  float* d_sm = w_sm + B;                 // [M][B]    dwn sums (DW)
  float* r_sm = d_sm + (DW ? M * B : 0);  // [K tsb]   dpad terms (DW)
  unsigned short* pos_sm =                // [B][tsb]  positions (DW)
      reinterpret_cast<unsigned short*>(r_sm + (DW ? K * tsb : 0));

  const int r = blockIdx.x, st = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's slices (M is 1 or 2) and part
  const int m = warp & (M - 1), h = warp >> (M - 1);
  const int col = m * 32 + lane;
  const int nt = K * tsb;
  const int s0 = st * tsb;
  const int n_live = min(tsb, S - s0);
  const bool live = col < n_live;
  const bool warp_live = m * 32 < n_live;
  const size_t row = (size_t)r * B;
  const float* pr_in = P + row * S + s0 + col;
  float* dpr = dP + row * S + s0 + col;

  // the tile's F[s0 .., :] and G[r, s0 .., :] (one contiguous run each,
  // at NF > 0 at most NF elements a thread) and the row's first weights
  // are loaded before the P columns, so that the block waits for one round
  // of loads, not one after another
  const float w0 = tid < B ? wn[row + tid] : 0.f;
  const float* ft = freqs + (size_t)s0 * F;
  const float* gt = G + ((size_t)r * S + s0) * F;
  constexpr int NE = NF > 0 ? NF : 1;
  float fv[NE], gv[NE];
#pragma unroll
  for (int u = 0; u < NE; ++u) {
    const int e = tid + u * nt;
    const bool in = NF > 0 && e < fc && e / F < n_live;
    fv[u] = in ? ft[e] : 0.f;
    gv[u] = in ? gt[e] : 0.f;
  }
#pragma unroll 8
  for (int b = h; b < B; b += K)
    p_sm[b * tsb + col] = live ? pr_in[(size_t)b * S] : 0.f;
  if (tid < B) w_sm[tid] = w0;
  for (int b = tid + nt; b < B; b += nt) w_sm[b] = wn[row + b];
  auto stage = [&](int e, float f, float g) {
    const int sl = e / F, x = (e - sl * F) * tsb + sl;
    f_sm[x] = f;
    if_sm[x] = (f == 0.f) ? 0.f : 1.f / f;
    g_sm[x] = g;
    if (NF == 0) {
      q_sm[x] = 0.f;
      qf_sm[x] = 0.f;
    }
  };
  if constexpr (NF > 0) {
#pragma unroll
    for (int u = 0; u < NF; ++u)
      if (tid + u * nt < fc) stage(tid + u * nt, fv[u], gv[u]);
  } else {
    for (int e = tid; e < fc; e += nt) {
      const bool in = e / F < n_live;
      stage(e, in ? ft[e] : 0.f, in ? gt[e] : 0.f);
    }
  }
  __syncthreads();
  // uniform_w only without with_dw (cos(pi f w) is the row value at padded
  // entries, exact only where it is multiplied by w); part 0 fills its
  // slice's row values
  const bool unif_w = !DW && unif;
  if (unif_w) {
    if (h == 0) {
      float wr = 0.f;
      for (int j = 0; j < B; ++j) wr = fmaxf(wr, w_sm[j]);
      for (int k = 0; k < F; ++k) {
        const int x = k * tsb + col;
        sincospif(2.f * (0.5f * f_sm[x] * wr), &sr_sm[x], &cr_sm[x]);
      }
    }
    if (K > 1) __syncthreads();
  }

  // frequency slot x's constants; at one frequency read once a thread
  struct Freq {
    float f, c2f, inv2f, inv_pf, g1, sin_row, cos_row;
  };
  auto freq_at = [&](int x) {
    Freq z;
    z.f = f_sm[x];
    const float inv_f = if_sm[x];
    z.c2f = 0.636619772367581343f * inv_f;     // 2/(pi f)
    z.inv2f = 2.f * inv_f;
    z.inv_pf = 0.318309886183790672f * inv_f;  // 1/(pi f)
    z.g1 = (1.f + z.f) * g_sm[x];
    z.sin_row = unif_w ? sr_sm[x] : 0.f;
    z.cos_row = unif_w ? cr_sm[x] : 1.f;
    return z;
  };
  const Freq one = freq_at(NF == 1 ? col : 0);

  constexpr int NQ = NF > 0 ? NF : 1;
  float q[NQ], qf[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) q[k] = qf[k] = 0.f;
  float dpad_acc = 0.f;
  // entry i, of projection p_i, rank c_i and position pos: dP, its q and
  // qf terms, and with DW its dc (scattered to its position), dpad term
  // and direct dwn term (summed over the warp's slices)
  auto entry = [&](int i, float p_i, float c_i, int pos) {
    const float w = w_sm[i];
    const float two_c_w = 2.f * c_i - w;
    float dp = 0.f, dc = 0.f, dd = 0.f;
    auto term = [&](int x, float& qk, float& qfk) {
      const Freq z = NF == 1 ? one : freq_at(x);
      const float f = z.f;
      float sin_fw, cos_fw;
      if (unif_w) {
        // the row value; sin exactly 0 at the padded entries
        sin_fw = (w == 0.f) ? 0.f : z.sin_row;
        cos_fw = z.cos_row;
      } else {
        sincospif(2.f * (0.5f * f * w), &sin_fw, &cos_fw);
      }
      float sin_t, cos_t;
      sincospif(2.f * (0.5f * f * two_c_w), &sin_t, &cos_t);
      const float sd = (f == 0.f ? 2.f * w : z.c2f * sin_fw) * cos_t;
      dp += z.g1 * sd;
      qk = fmaf(p_i, sd, qk);
      const float phi_f = z.inv2f * (w * cos_fw * cos_t
                                     - z.inv_pf * sin_fw * cos_t
                                     - two_c_w * sin_fw * sin_t);
      qfk = fmaf(p_i, phi_f, qfk);
      if (DW) {
        dc += z.g1 * p_i * (-4.f) * sin_fw * sin_t;
        dd += z.g1 * p_i * 2.f * (cos_fw * cos_t + sin_fw * sin_t);
      }
    };
    if constexpr (NF > 0) {
#pragma unroll
      for (int k = 0; k < NF; ++k) term(k * tsb + col, q[k], qf[k]);
    } else {
      for (int k = 0; k < F; ++k)
        term(k * tsb + col, q_sm[k * tsb + col], qf_sm[k * tsb + col]);
    }
    if (live) dpr[(size_t)i * S] = dp;
    if constexpr (DW) {
      x_sm[pos * tsb + col] = dc;
      pos_sm[i * tsb + col] = (unsigned short)pos;
      dpad_acc += (p_i > 0.f) ? dc : 0.f;
      const float v = warp_sum(dd);
      if (lane == 0) d_sm[m * B + i] = v;
    }
  };
  if (warp_live) {
    const float pr = pad[r];
    for (int i0 = h * NI; i0 < B; i0 += K * NI) {
      float p[NI], c[NI];
      int n[NI];
      rank_core<DW>(p_sm, w_sm, B, tsb, col, i0, pr, p, c, n);
      if constexpr (NF > 1) {
        // entry i uses slot 0 of the arrays, which then shift down: one
        // copy of the frequency loop, and the arrays stay in registers
#pragma unroll 1
        for (int i = i0; i < min(i0 + NI, B); ++i) {
          const float p_i = p[0], c_i = c[0];
          const int pos = n[0];
#pragma unroll
          for (int k = 0; k + 1 < NI; ++k) {
            p[k] = p[k + 1];
            c[k] = c[k + 1];
            n[k] = n[k + 1];
          }
          entry(i, p_i, c_i, pos);
        }
      } else {
#pragma unroll
        for (int k = 0; k < NI; ++k)
          if (i0 + k < B) entry(i0 + k, p[k], c[k], n[k]);
      }
    }
  } else if (DW && lane == 0) {
    for (int i0 = h * NI; i0 < B; i0 += K * NI)
      for (int i = i0; i < min(i0 + NI, B); ++i) d_sm[m * B + i] = 0.f;
  }

  // this row's df terms, g (q + (1 + f) qf) for every frequency, each
  // slice's q and qf summed over its parts in the order h = 0 .. K-1 (at
  // NF = 0, K = 1 and the sums are in q_sm, qf_sm); one frequency goes
  // straight to dfr (coalesced), several through q_sm
  for (int hh = 0; hh < K; ++hh) {
    if (h == hh) {
#pragma unroll
      for (int k = 0; k < (NF > 0 ? NF : F); ++k) {
        const int x = k * tsb + col;
        float a, b;
        if constexpr (NF > 0) {
          a = q[k];
          b = qf[k];
        } else {
          a = q_sm[x];
          b = qf_sm[x];
        }
        if (hh > 0) {
          a += q_sm[x];
          b += qf_sm[x];
        }
        if (hh + 1 < K) {
          q_sm[x] = a;
          qf_sm[x] = b;
        } else {
          const float d = g_sm[x] * (a + (1.f + f_sm[x]) * b);
          if (NF == 1) {
            if (live) dfr[(size_t)r * S + s0 + col] = d;
          } else {
            q_sm[x] = d;
          }
        }
      }
    }
    if (hh + 1 < K) __syncthreads();
  }
  if (NF != 1) {
    __syncthreads();
    float* dt = dfr + ((size_t)r * S + s0) * F;
    for (int e = tid; e < n_live * F; e += nt) {
      const int sl = e / F;
      dt[e] = q_sm[(e - sl * F) * tsb + sl];
    }
  }

  if constexpr (DW) {
    // x_sm[pos] becomes the sum of dc over the positions from pos on, one
    // thread a slice, from the end
    __syncthreads();
    if (h == 0 && warp_live) {
      float acc = 0.f;
      for (int a = B - 1; a >= 0; --a) {
        acc += x_sm[a * tsb + col];
        x_sm[a * tsb + col] = acc;
      }
    }
    __syncthreads();
    if (warp_live) {
      for (int i0 = h * NI; i0 < B; i0 += K * NI)
        for (int i = i0; i < min(i0 + NI, B); ++i) {
          const float v = warp_sum(x_sm[pos_sm[i * tsb + col] * tsb + col]);
          if (lane == 0) d_sm[m * B + i] += v;
        }
    }
    r_sm[tid] = dpad_acc;
    __syncthreads();
    // the block's partials: dwn the M warps' sums in order, dpad the
    // threads' terms in the order t = 0 .. nt - 1
    float* wp = dwn_part + ((size_t)st * R + r) * B;
    for (int j = tid; j < B; j += nt) {
      float acc = 0.f;
      for (int a = 0; a < M; ++a) acc += d_sm[a * B + j];
      wp[j] = acc;
    }
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < nt; ++t) acc += r_sm[t];
      dpad_part[(size_t)st * R + r] = acc;
    }
  }
}

// The entry kernel's arguments.
struct EntryArgs {
  const float* P;
  float* dP;
  const float *wn, *pad, *freqs, *G;
  float *dfr, *dwn_part, *dpad_part;
  int R, B, S, F;
};

template <int NF, bool DW>
inline cudaError_t launch_entry(const EntryArgs& a, EntryShape e, size_t smem,
                                int unif, cudaStream_t stream) {
  const auto kern = rank_bwd_entry_kernel<NF, DW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3((unsigned)a.R, (unsigned)cdiv(a.S, e.tsb)), e.K * e.tsb, smem,
         stream>>>(a.P, a.dP, a.wn, a.pad, a.freqs, a.G, a.dfr, a.dwn_part,
                   a.dpad_part, a.R, a.B, a.S, a.F, e.K, e.tsb, unif);
  return cudaGetLastError();
}

// Launch rank_bwd_entry_kernel on an (R, entry_tiles) grid, the instance
// for F; returns the first CUDA error.
inline cudaError_t launch_rank_bwd_entry(const EntryArgs& a, int uniform_w,
                                         int with_dw, cudaStream_t stream) {
  const EntryShape e = entry_shape(a.B, a.F, with_dw);
  const size_t smem = entry_need(a.B, a.F, with_dw, e.K, e.tsb);
  if (smem > SMEM_LIMIT || cdiv(a.S, e.tsb) > 65535)
    return cudaErrorInvalidValue;
  const int u = uniform_w && !with_dw;
  if (a.F == 1)
    return with_dw ? launch_entry<1, true>(a, e, smem, u, stream)
                   : launch_entry<1, false>(a, e, smem, u, stream);
  if (a.F == NF_WIDE)
    return with_dw ? launch_entry<NF_WIDE, true>(a, e, smem, u, stream)
                   : launch_entry<NF_WIDE, false>(a, e, smem, u, stream);
  return with_dw ? launch_entry<0, true>(a, e, smem, u, stream)
                 : launch_entry<0, false>(a, e, smem, u, stream);
}

// out[y, m] = sum_{k = y kc}^{min(K, (y + 1) kc) - 1} in[k, m], in order
__global__ void sum_rows_kernel(const float* __restrict__ in,
                                float* __restrict__ out, int K, long long M,
                                int kc) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  float acc = 0.f;
  for (int k = k0; k < k1; ++k) acc += in[(size_t)k * M + m];
  out[(size_t)blockIdx.y * M + m] = acc;
}

// out (M) = column sums of in (K, M); two passes through tmp (at most
// MAX_SPLIT x M floats) when K > MAX_SPLIT.
inline cudaError_t reduce_rows(const float* in, float* out, float* tmp, int K,
                               long long M, cudaStream_t stream) {
  const unsigned gx = (unsigned)cdiv(M, RED_THREADS);
  if (K <= MAX_SPLIT) {
    sum_rows_kernel<<<dim3(gx, 1), RED_THREADS, 0, stream>>>(in, out, K, M,
                                                              K);
    return cudaGetLastError();
  }
  const int kc = cdiv(K, MAX_SPLIT);
  const int k1 = cdiv(K, kc);
  sum_rows_kernel<<<dim3(gx, k1), RED_THREADS, 0, stream>>>(in, tmp, K, M,
                                                             kc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_rows_kernel<<<dim3(gx, 1), RED_THREADS, 0, stream>>>(tmp, out, k1, M,
                                                            k1);
  return cudaGetLastError();
}

// df (S F), and with with_dw dwn (R B) and dpad (R), from the entry
// kernel's partials of n_st slice tiles; tmp holds MAX_SPLIT S F floats.
// dwn and dpad sum their tiles in one pass whatever n_st: R B and R
// columns keep the card busy.
inline cudaError_t reduce_entry_partials(const float* dfr,
                                         const float* dwn_part,
                                         const float* dpad_part, float* df,
                                         float* dwn, float* dpad, float* tmp,
                                         int R, int B, long long SF,
                                         int n_st, int with_dw,
                                         cudaStream_t stream) {
  cudaError_t e = reduce_rows(dfr, df, tmp, R, SF, stream);
  if (e != cudaSuccess || !with_dw) return e;
  const long long N = (long long)R * B;
  sum_rows_kernel<<<dim3((unsigned)cdiv(N, RED_THREADS), 1), RED_THREADS, 0,
                    stream>>>(dwn_part, dwn, n_st, N, n_st);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  sum_rows_kernel<<<dim3((unsigned)cdiv(R, RED_THREADS), 1), RED_THREADS, 0,
                    stream>>>(dpad_part, dpad, n_st, R, n_st);
  return cudaGetLastError();
}

// ---- K1's products on the tensor cores ------------------------------------
//
// C (64 x 64) = A (64 x K) B (K x 64) for one output tile, by the block's
// MMA_THREADS = 128 threads: warp w owns rows 16 w .. 16 w + 15 and all 64
// columns (eight m16n8k8 tiles, `mma.sync` on TF32).  K is walked in chunks
// of KC = 32, staged by `cp.async` (4-byte copies: the row strides D and S
// are any integers, so 16-byte alignment is not given) into a two-stage ring
// in shared memory; chunk c + 1 is in flight while chunk c is multiplied.
//
// Accuracy: every operand x is split as hi = tf32(x), lo = tf32(x - hi)
// (3xTF32), and each k-step adds lo_a hi_b, then hi_a lo_b, then hi_a hi_b
// (the lo_a lo_b term, 2^-22 of the product, is dropped).  A chunk's 12
// products go into an accumulator of their own, started at 0, which is then
// added to the tile's running sum with one float32 add: the tensor cores'
// own additions truncate, and this keeps them to the 12 additions inside a
// chunk, relative to the chunk's partial sum.  The result is float32's
// accuracy (tests/test_torch_tf32.py emulates the split against float64);
// a plain TF32 product keeps about three decimal digits, which moves ranks
// at near-ties and the 'spread' frequencies' outputs (f up to 2S - 1).
//
// Determinism: every element sums its chunks in the order c = 0, 1, ... and
// its k-steps in a fixed order, from 0, and its value depends only on its
// row of A and column of B, so two calls give the same bits and K1b's
// recomputed projection (fsw_rank_bwdp.cu, step 1) has K1f's bits: both
// project with `project_block` on the same row tiles (`proj_rows`).
//
// Operands are given as a pointer to the tile's element (0, 0), a leading
// stride and the valid extent; rows, columns and k past the extent are read
// as zeros (the copies' zero fill), so ragged tiles need no other care.
// K_CONTIG says that k is the contiguous axis in global memory (element
// (i, k) at p[i * ld + k]); otherwise i is (element (i, k) at p[k * ld + i]).
// Shared layouts, padded so that every fragment load is free of bank
// conflicts: [64][KC + 4] for a k-contiguous operand, [KC][64 + 8] for the
// other; both are 2304 floats.

constexpr int MT = 64;                  // rows of an output tile
constexpr int NT = 64;                  // columns of an output tile
constexpr int KC = 32;                  // depth of one staged chunk
constexpr int MMA_THREADS = 128;        // 4 warps: 16 rows x 64 columns each
constexpr int LD_K = KC + 4;            // row stride, [64][KC] layout
constexpr int LD_I = 64 + 8;            // row stride, [KC][64] layout
constexpr int OP_FLOATS = 64 * LD_K;    // == KC * LD_I == 2304
constexpr int STAGE_FLOATS = 2 * 2 * OP_FLOATS;  // 2 stages x (A, B)
static_assert(KC * LD_I == OP_FLOATS, "both layouts must have one size");

struct Operand {
  const float* p;   // element (0, 0) of the tile
  long long ld;     // stride between rows (K_CONTIG) or between k
  int n;            // valid rows (i < n)
};

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage chunk k0 .. k0 + KC - 1 of one 64-row operand into `dst`.
template <bool K_CONTIG>
__device__ __forceinline__ void stage_operand(float* dst, const Operand& op,
                                              int k0, int K, int tid) {
#pragma unroll 4
  for (int e = tid; e < 64 * KC; e += MMA_THREADS) {
    int i, k, s;
    if (K_CONTIG) {
      i = e / KC; k = e % KC; s = i * LD_K + k;
    } else {
      k = e / 64; i = e % 64; s = k * LD_I + i;
    }
    const bool ok = i < op.n && k0 + k < K;
    const float* src = ok ? (K_CONTIG ? op.p + i * op.ld + (k0 + k)
                                      : op.p + (long long)(k0 + k) * op.ld + i)
                          : op.p;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst + s)),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

// Element (i, k) of a staged operand.
template <bool K_CONTIG>
__device__ __forceinline__ float staged(const float* op, int i, int k) {
  return K_CONTIG ? op[i * LD_K + k] : op[k * LD_I + i];
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);   // exact
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile product: acc[j][q] gets C at row 16 warp + g (+ 8 for q >= 2),
// column 8 j + 2 t (+ 1 for odd q), with g = lane / 4 and t = lane % 4 (the
// m16n8k8 accumulator layout).  `stage` holds STAGE_FLOATS floats; every
// thread of the block must call it.  A is (64 x K) and B is (K x 64): B's
// "rows" are its 64 columns n (element (n, k)).
template <bool A_K, bool B_K>
__device__ __forceinline__ void tile_product(const Operand& A,
                                             const Operand& B, int K,
                                             float* stage, float (&acc)[8][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  const int nk = cdiv(K, KC);
  if (nk == 0) return;
  stage_operand<A_K>(stage, A, 0, K, tid);
  stage_operand<B_K>(stage + OP_FLOATS, B, 0, K, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) {
      float* nxt = stage + ((c + 1) & 1) * 2 * OP_FLOATS;
      stage_operand<A_K>(nxt, A, (c + 1) * KC, K, tid);
      stage_operand<B_K>(nxt + OP_FLOATS, B, (c + 1) * KC, K, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* As = stage + (c & 1) * 2 * OP_FLOATS;
    const float* Bs = As + OP_FLOATS;
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      unsigned ahi[4], alo[4];
      split_tf32(staged<A_K>(As, r0, kk + t), ahi[0], alo[0]);
      split_tf32(staged<A_K>(As, r0 + 8, kk + t), ahi[1], alo[1]);
      split_tf32(staged<A_K>(As, r0, kk + t + 4), ahi[2], alo[2]);
      split_tf32(staged<A_K>(As, r0 + 8, kk + t + 4), ahi[3], alo[3]);
      // four column tiles at a time, their three products interleaved, so
      // that no product waits on the one just issued to its accumulator
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        unsigned bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 8 * (j0 + j) + g;
          split_tf32(staged<B_K>(Bs, n, kk + t), bhi[j][0], blo[j][0]);
          split_tf32(staged<B_K>(Bs, n, kk + t + 4), bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[j0 + j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[j0 + j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[j0 + j], ahi, bhi[j][0], bhi[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
    __syncthreads();  // the buffer is staged again two chunks on
  }
}

// Table rows a K1 block projects: enough that a block holds at least 64
// entries when B <= 64 (8 rows at B = 8), one row above.
__host__ __device__ inline int proj_rows(int B) {
  return (B >= 64 || B <= 0) ? 1 : 64 / B;
}

// Dynamic shared memory of K1f at width B: the staging ring, the block's
// projections [rows * B][TS] and its weights [rows * B].  Where the block
// projects in one pass (rows * B <= MT, every B <= 64) the projections and
// weights reuse the ring once the product is done, so the block needs no
// more than K1b's product kernels; wider rows add them beside the ring.
// It does not depend on the feature width D.
inline size_t fwdp_smem_bytes(int B) {
  const size_t e = (size_t)proj_rows(B) * B, own = e * TS + e;
  return sizeof(float) * (e <= (size_t)MT
                              ? (own > STAGE_FLOATS ? own : STAGE_FLOATS)
                              : STAGE_FLOATS + own);
}

// K1's projection of one block's entries: P[e, s] = sum_d Z[e, d] V[d, s]
// for the E entries of the block (consecutive in Z, from `z`) and its
// columns s0 .. s0 + 63 (< S), in passes of MT entries; each value goes to
// store(e, col, value).  The one copy of the projection K1f and K1b run.
template <typename Store>
__device__ __forceinline__ void project_block(const float* z, const float* V,
                                              int E, int D, int S, int s0,
                                              float* stage, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int m0 = 0; m0 < E; m0 += MT) {
    float acc[8][4];
    tile_product<true, false>(Operand{z + (long long)m0 * D, D, min(MT, E - m0)},
                              Operand{V + s0, S, min(NT, S - s0)}, D, stage,
                              acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = m0 + 16 * warp + g + (q >> 1) * 8;
        const int col = 8 * j + 2 * t + (q & 1);
        if (e < E && s0 + col < S) store(e, col, acc[j][q]);
      }
  }
}

}  // namespace
