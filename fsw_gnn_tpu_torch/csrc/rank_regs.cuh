// The rank loop with a slice's column held in registers (float32): the
// loop of the probes P6 (probe_select.cu, its `fma_anchor`, `select_add`
// and `rank` bodies) and P4 (probe_stage.cu).  The six rank kernels keep
// `rank_core` (fsw_rank_common.cuh), which reads the column from shared
// memory.
//
// For one table row of B <= W entries and one slice, a thread holds the
// column p[0 .. W-1] and the row's weights w[0 .. W-1] in registers,
// entries past B with weight 0 (and any projection: fmaf(0, s, c) is c, so
// they change no rank), and computes
//
//   c[i] = sum_j w[j] * 1[p[j] < p[i] or (p[j] == p[i] and j <= i)],
//
// summed in the order j = 0 .. W-1, as `_rank_c` and `rank_core` sum it
// (fsw_rank_common.cuh explains why that keeps the plain version's bits).
// W is fixed at compile time and the pairs are fully unrolled, so whether
// j <= i is known for every pair and the tie rule is settled without an
// integer compare: j < i counts on p[j] <= p[i], the self pair on
// p[i] == p[i] (0 for a NaN), j > i on p[j] < p[i].  A pair is then one
// compare to 1.f or 0.f (FSET) and one fused multiply-add c = w s + c,
// which rounds exactly as c + (pred ? w : 0), and nothing is loaded inside
// the pair loop: j runs outside i, so each w[j] and p[j] feeds W
// independent sums.  Zero-weight entries need no compaction: their terms
// are exact zeros.
//
// What bounds it on an H100: issue.  Two instructions a pair at the FFMA
// issue rate (half of the 67 TFLOP/s float32 peak, an FFMA counted as two
// operations) is the floor `pairs x 2 / 33.5e12` s.  A thread holds 3 W
// floats of column, weights and sums, so W = 32 (about 100 registers) is
// the one width with an instance; wider rows keep the shared-memory loops
// of their callers.  The callers choose by width and report which loop a
// launch took (`*_loop` in their C interfaces).

#pragma once

namespace rank_regs {

constexpr int W = 32;     // the widest row the register loop takes

// c[i] of the inclusive weighted ranks of p under weights w (see above).
template <int N>
__device__ __forceinline__ void rank(const float (&p)[N], const float (&w)[N],
                                     float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool before = j < i ? p[j] <= p[i]
                                : (j == i ? p[i] == p[i] : p[j] < p[i]);
      c[i] = fmaf(w[j], before ? 1.f : 0.f, c[i]);
    }
  }
}

}  // namespace rank_regs
