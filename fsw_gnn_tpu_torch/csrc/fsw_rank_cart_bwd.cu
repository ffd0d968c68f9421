// Cartesian-mode weighted-rank FSW aggregation, backward (float32).
//
// Replaces the TPU kernels `_bwdc_kernel` and `_mask_consume_kernel` behind
// the backward `_fswc_bwd` of `fsw_rank_aggregate_cart`
// (fsw_gnn_tpu/ops/fsw_rank_pallas.py).  Given the forward's inputs
// P (R, B, S), wn (R, B), pad (R), freqs F (S, NF) and the output cotangent
// G (R, S, NF), it recomputes the inclusive weighted rank c exactly as the
// forward kernel does, then, with f = F[s, k], g = G[r, s, k],
// A_i = pi f (2 c_i - w_i) and phi_i = (2/(pi f)) sin(pi f w_i) cos A_i
// (the exact f == 0 limit 2 w_i cos A_i):
//
//   dP[r,i,s] = sum_k (1 + f) g phi_i
//   df[s,k]   = sum_r g [ sum_i p_i phi_i + (1 + f) sum_i p_i phi_f,i ]
//   with_dw:  dc_i     = sum_k (1 + f) g p_i (-4) sin(pi f w_i) sin A_i,
//             dwn[r,j] = sum_{s,k} (1+f) g p_j 2 cos(A_j - pi f w_j)
//                        + sum_{i,s} dc_i M_ij,
//             dpad[r]  = sum_{i,s} dc_i [p_i > 0],
//             M_ij = 1[p_j < p_i or (p_j == p_i and j <= i)].
//
// Design: K2b's entry kernel (rank_bwd_entry_kernel, fsw_rank_common.cuh)
// with a frequency loop inside the entry loop.  One block per (table row,
// tile of 64 slices), one thread per slice:
//   1. the entry kernel stages the row's P columns in shared memory as
//      [b][thread], and the tile's frequencies and cotangents (a contiguous
//      run of 64 NF floats each) as [k][thread].  Each thread ranks its
//      column once, NI = 8 entries a pass (rank_group); for each entry it
//      loops over the NF frequencies, summing dp (written once), dc and the
//      direct dwn term in registers and this slice's q and qf sums of every
//      frequency in shared [k][thread] accumulators.  The direct dwn term
//      is summed over each warp's slices by shuffles; dc goes to a shared
//      column.  With with_dw the transposed-mask loop (mask_consume) then
//      turns dc into dwn and dpad in the same kernel: the TPU split it into
//      a second kernel, with dc through HBM, only because Mosaic took over
//      40 minutes to compile the two loops together.  The df terms of the
//      row go to an (R, S NF) workspace, written coalesced.
//   2. the column-sum kernel reduces the df terms over the rows (two passes
//      when R > 256) and the dwn / dpad partials over the slice tiles.
// Every cross-block sum is a partial reduced in a fixed order: no float
// atomics, so two calls give the same bits.
//
// Zero-weight entries get exactly dP = 0 and contribute nothing to df, to
// dpad or to another entry's dwn: see fsw_rank_common.cuh.  The uniform_w
// trig runs only without with_dw, as the TPU kernel does.
//
// What bounds it on an H100: the trig.  The least work a row with d real
// entries needs per slice is a sort (about d log2 d compares), a cumsum
// (d adds), and per entry and frequency the two sincospi and the dp, phi_f
// and df terms (about 45 NF d operations), with with_dw a reverse cumsum
// of dc (d adds); at the JAX package's cartesian benchmark shape (8192 rows,
// B = 32 with a fifth of the weights zero, S = 128, NF = 8) that is 9.8e9
// operations (0.147 ms) against 302 MB (0.090 ms).  The entry kernel needs
// 4 (64 B (2 with with_dw, else 1) + B (3 with with_dw, else 1) + 64
// + 64 NF (7 with uniform_w, else 5)) bytes of shared memory: B up to 423
// with with_dw at NF = 8, 853 without (837 with uniform_w).

#include "fsw_rank_common.cuh"

namespace {

// Dynamic shared memory of the entry kernel.
inline size_t cart_entry_smem_bytes(int B, int NF, int with_dw, int unif) {
  return sizeof(float) * ((size_t)B * TS * (with_dw ? 2 : 1) +
                          (size_t)B * (with_dw ? 1 + WARPS : 1) + TS +
                          (size_t)TS * NF * (unif ? 7 : 5));
}

__global__ void fsw_rank_cart_bwd_entry_kernel(
    const float* __restrict__ P, float* __restrict__ dP,
    const float* __restrict__ wn, const float* __restrict__ pad,
    const float* __restrict__ freqs, const float* __restrict__ G,
    float* __restrict__ dfr, float* __restrict__ dwn_part,
    float* __restrict__ dpad_part, int R, int B, int S, int NF, int unif,
    int with_dw) {
  extern __shared__ float smem[];
  float* p_sm = smem;                       // [B][TS]   projections
  float* w_sm = p_sm + B * TS;              // [B]       wn[r]
  float* r_sm = w_sm + B;                   // [TS]      dpad terms
  float* f_sm = r_sm + TS;                  // [NF][TS]  frequencies
  float* if_sm = f_sm + NF * TS;            // [NF][TS]  1 / f, 0 at f == 0
  float* g_sm = if_sm + NF * TS;            // [NF][TS]  cotangent
  float* q_sm = g_sm + NF * TS;             // [NF][TS]  sum p phi, then df
  float* qf_sm = q_sm + NF * TS;            // [NF][TS]  sum p phi_f
  float* dc_sm = qf_sm + NF * TS;           // [B][TS]   dc (with_dw)
  float* d_sm = dc_sm + (with_dw ? B * TS : 0);    // [WARPS][B] (with_dw)
  float* sr_sm = d_sm + (with_dw ? WARPS * B : 0);  // [NF][TS] (uniform_w)
  float* cr_sm = sr_sm + NF * TS;                   // [NF][TS] (uniform_w)

  const int r = blockIdx.x;
  const int st = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = st * TS;
  const int s = s0 + tid;
  const int n_live = min(TS, S - s0);
  const bool live = tid < n_live;
  const bool warp_live = warp * 32 < n_live;
  const float* pr_in = P + (size_t)r * B * S + s;
  float* dpr = dP + (size_t)r * B * S + s;

  for (int b = tid; b < B; b += TS) w_sm[b] = wn[(size_t)r * B + b];
  for (int b = 0; b < B; ++b)
    p_sm[b * TS + tid] = live ? pr_in[(size_t)b * S] : 0.f;
  // the tile's F[s0 .., :] and G[r, s0 .., :]: one contiguous run each
  const float* ft = freqs + (size_t)s0 * NF;
  const float* gt = G + ((size_t)r * S + s0) * NF;
  for (int e = tid; e < TS * NF; e += TS) {
    const int sl = e / NF, k = e - sl * NF;
    const bool in = sl < n_live;
    f_sm[k * TS + sl] = in ? ft[e] : 0.f;
    g_sm[k * TS + sl] = in ? gt[e] : 0.f;
  }
  __syncthreads();

  float dpad_acc = 0.f;
  if (warp_live) {
    // lanes past S run on zeros (p = 0, f = 0, g = 0: every term exactly
    // 0) so that every lane of a warp takes part in the shuffles
    const float pr = pad[r];
    float wr = 0.f;
    if (unif) {
      for (int j = 0; j < B; ++j) wr = fmaxf(wr, w_sm[j]);
    }
    for (int k = 0; k < NF; ++k) {
      const int x = k * TS + tid;
      const float f = f_sm[x];
      if_sm[x] = (f == 0.f) ? 0.f : 1.f / f;
      q_sm[x] = 0.f;
      qf_sm[x] = 0.f;
      if (unif) sincospif(2.f * (0.5f * f * wr), &sr_sm[x], &cr_sm[x]);
    }
    for (int i0 = 0; i0 < B; i0 += NI) {
      float p[NI], c[NI];
      rank_group(p_sm, w_sm, B, tid, i0, pr, p, c);
#pragma unroll
      for (int kk = 0; kk < NI; ++kk) {
        const int i = i0 + kk;
        if (i < B) {
          const float p_i = p[kk];
          const float w = w_sm[i];
          const float two_c_w = 2.f * c[kk] - w;
          float dp = 0.f, dc = 0.f, dd = 0.f;
          for (int k = 0; k < NF; ++k) {
            const int x = k * TS + tid;
            const float f = f_sm[x];
            const bool fz = f == 0.f;
            const float inv_f = if_sm[x];
            const float c2f = 0.636619772367581343f * inv_f;     // 2/(pi f)
            const float inv2f = 2.f * inv_f;
            const float inv_pf = 0.318309886183790672f * inv_f;  // 1/(pi f)
            const float g1 = (1.f + f) * g_sm[x];
            float sin_fw, cos_fw;
            if (unif) {
              // the row value; sin exactly 0 at the padded entries (cos is
              // the row value there, exact only where multiplied by w)
              sin_fw = (w == 0.f) ? 0.f : sr_sm[x];
              cos_fw = cr_sm[x];
            } else {
              sincospif(2.f * (0.5f * f * w), &sin_fw, &cos_fw);
            }
            float sin_t, cos_t;
            sincospif(2.f * (0.5f * f * two_c_w), &sin_t, &cos_t);
            const float sd = (fz ? 2.f * w : c2f * sin_fw) * cos_t;
            dp += g1 * sd;
            q_sm[x] = fmaf(p_i, sd, q_sm[x]);
            const float phi_f = inv2f * (w * cos_fw * cos_t
                                         - inv_pf * sin_fw * cos_t
                                         - two_c_w * sin_fw * sin_t);
            qf_sm[x] = fmaf(p_i, phi_f, qf_sm[x]);
            if (with_dw) {
              dc += g1 * p_i * (-4.f) * sin_fw * sin_t;
              dd += g1 * p_i * 2.f * (cos_fw * cos_t + sin_fw * sin_t);
            }
          }
          if (live) dpr[(size_t)i * S] = dp;
          if (with_dw) {
            dc_sm[i * TS + tid] = dc;
            dpad_acc += (p_i > 0.f) ? dc : 0.f;
            const float v = warp_sum(dd);
            if (lane == 0) d_sm[warp * B + i] = v;
          }
        }
      }
    }
    for (int k = 0; k < NF; ++k) {        // this row's df terms
      const int x = k * TS + tid;
      q_sm[x] = g_sm[x] * (q_sm[x] + (1.f + f_sm[x]) * qf_sm[x]);
    }
    if (with_dw) mask_consume(p_sm, dc_sm, d_sm, B, tid, lane, warp);
  } else if (with_dw && lane == 0) {
    for (int j = 0; j < B; ++j) d_sm[warp * B + j] = 0.f;
  }
  __syncthreads();
  float* dt = dfr + ((size_t)r * S + s0) * NF;
  for (int e = tid; e < n_live * NF; e += TS) {
    const int sl = e / NF;
    dt[e] = q_sm[(e - sl * NF) * TS + sl];
  }
  if (!with_dw) return;
  write_entry_partials(d_sm, r_sm, dpad_acc, dwn_part, dpad_part, R, B, r,
                       st, tid);
}

// Workspace layout, in floats; each region starts on a 256-byte boundary.
struct Plan {
  size_t dfr, tmp, dwnp, dpadp, total;
  int n_st;
};

Plan make_plan(int R, int B, int S, int NF, int with_dw) {
  Plan p;
  p.n_st = cdiv(S, TS);
  size_t off = 0;
  p.dfr = off;   off += align64((size_t)R * S * NF);
  p.tmp = off;   off += align64((size_t)MAX_SPLIT * S * NF);
  p.dwnp = off;  off += with_dw ? align64((size_t)p.n_st * R * B) : 0;
  p.dpadp = off; off += with_dw ? align64((size_t)p.n_st * R) : 0;
  p.total = off;
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, of the entry kernel at width B with NF
// frequencies (uniform_w counts only without with_dw).
size_t fsw_rank_cart_bwd_smem_bytes(int B, int NF, int with_dw,
                                    int uniform_w) {
  return cart_entry_smem_bytes(B, NF, with_dw, uniform_w && !with_dw);
}

// Bytes of device workspace a call at this shape needs (the caller
// allocates it; the kernels allocate nothing).
size_t fsw_rank_cart_bwd_workspace_bytes(int R, int B, int S, int NF,
                                         int with_dw) {
  return sizeof(float) * make_plan(R, B, S, NF, with_dw).total;
}

// P (R, B, S), wn (R, B), pad (R,), freqs (S, NF), G (R, S, NF) in;
// dP (R, B, S), df (S, NF) out, and with with_dw dwn (R, B) and dpad (R,)
// (else they may be null); ws the workspace.  Contiguous float32 on the
// current device, R, B, S, NF > 0.  Launches on `stream` and returns the
// first CUDA error (0 on success); does not synchronise.
int fsw_rank_cart_bwd_f32(const void* P, const void* wn, const void* pad,
                          const void* freqs, const void* G, void* dP,
                          void* dwn, void* dpad, void* df, void* ws, int R,
                          int B, int S, int NF, int uniform_w, int with_dw,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int unif = uniform_w && !with_dw;
  const Plan p = make_plan(R, B, S, NF, with_dw);
  const size_t smem = cart_entry_smem_bytes(B, NF, with_dw, unif);
  if (p.n_st > MAX_SPLIT || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fsw_rank_cart_bwd_entry_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float* w = (float*)ws;
  fsw_rank_cart_bwd_entry_kernel<<<dim3((unsigned)R, (unsigned)p.n_st), TS,
                                   smem, st>>>(
      (const float*)P, (float*)dP, (const float*)wn, (const float*)pad,
      (const float*)freqs, (const float*)G, w + p.dfr, w + p.dwnp,
      w + p.dpadp, R, B, S, NF, unif, with_dw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = reduce_rows(w + p.dfr, (float*)df, w + p.tmp, R,
                       (long long)S * NF, st)) != cudaSuccess ||
      !with_dw)
    return (int)e;
  if ((e = reduce_rows(w + p.dwnp, (float*)dwn, w + p.tmp, p.n_st,
                       (long long)R * B, st)) != cudaSuccess)
    return (int)e;
  return (int)reduce_rows(w + p.dpadp, (float*)dpad, w + p.tmp, p.n_st, R,
                          st);
}

}  // extern "C"
