// K2f with explicitly staged loads (float32): the probe P4.
//
// Replaces the TPU probe `fwd_emit` (benchmarks/probe_emit_pipeline.py,
// `_outer` / `_inner` over `emit_pipeline`), which runs the rank forward
// with explicit double-buffered copies against the implicit grid pipeline
// (`fwd_implicit`, whose H100 counterpart is K2f itself, fsw_rank_fwd.cu).
// It computes K2f's function, out (R, S) from P (R, B, S), wn (R, B),
// pad (R,) and freqs (S,), and answers one question: does K2f wait on its
// loads?  K2f loads a row's columns with plain loads and ranks them only
// when they have arrived; here the rows are staged ahead by the card's own
// copy engine.  P must have S a multiple of 4 and a 16-byte aligned base
// (the wrapper checks).  The output is K2f's to the bit.
//
// Rows of B <= rank_regs::W (32) entries (`probe_stage_loop` 1 or 2):
//   persistent blocks, as many as fit the card, each walking rows
//   blockIdx.x, + gridDim.x, ...; one thread a slice.  Where S <= TSB =
//   128 a block covers all of a row's slices and one `cp.async.bulk` of
//   the row's contiguous B x S block stages it; wider rows go in tiles of
//   TILE = 64 slices (blockIdx.y) by a tensor map (box 64 slices x B
//   entries, zeros past S: 64-slice tiles leave less of a ragged edge
//   idle than 128-slice ones; scripts/torch_p4_breakdown.py).  A ring
//   of STAGES = 3 rows in shared memory: thread 0 issues a row's copies,
//   STAGES - 1 rows ahead of the one that ranks, and they complete on the
//   stage's `mbarrier` (`full`), so no thread spends an instruction on
//   the copy; the weights come with the row by a bulk copy where B is a
//   multiple of 4 and wn 16-byte aligned (every row then is), else by
//   warp 0's 4-byte `cp.async` copies, which arrive on the same barrier.
//   Each thread reads its column and the weights into registers and ranks
//   them on the register loop of rank_regs.cuh (no compaction: a zero
//   weight adds exactly 0 to every rank, fmaf(0, s, c) is c, so c is
//   K2f's); adds K2f's pad term; keeps c in shared memory ([W][128] or
//   [W][64], its own column); and runs K2f's quadrature (`fwd_freq`, `fwd_sd`,
//   fsw_rank_common.cuh), fmaf over the nonzero-weight entries in their
//   order, as a loop unrolled by 4 over the stage's column that ends at
//   the row's last nonzero weight.  A zero-weight entry before it is
//   computed and its term selected away, exactly 0 whatever its
//   projection (a branch an entry, and the trig unrolled from registers,
//   ran slower: scripts/torch_p4_breakdown.py).
//   Then the thread arrives on the stage's `empty` barrier, which thread 0
//   waits on before it refills the stage.
// Wider rows (`probe_stage_loop` 0): each block walks rows of one tile of
//   TS = 64 slices; while it ranks row r, the next row's B x TS
//   projections and B weights are in flight into the second of two
//   buffers, by `cp.async` copies of 16 bytes (four slices) for P and 4
//   bytes for the weights; then every thread keeps its column's entries
//   of nonzero weight in their order (the rule of `stage_kept`), warp 0
//   compacts the weights alike (`compact_kept_weights`), and
//   `rank_fwd_slice` ranks and sums exactly as K2f does.  Slices past S
//   are zero-filled by the copies.
//
// What bounds it on an H100: K2f's bound, the real entries' columns of P
// read once (it reads every entry's column, which K2f does not), and on the
// register path the pair loop's issue, pairs x 2 / (67e12 / 2) s, above
// it at the probe's shape (8192 x 32 x 128: 0.0641 ms against 0.0416).
// Shared memory: the ring, 3 (B c + B) floats at c = S or 64 columns, the
// ranks' 32 a thread and the barriers, B <= 32 (66 KB at the probe's
// shape); two rows, 8 (64 B + B) bytes and some, wider (B up to 447).

#include "fsw_rank_common.cuh"
#include "rank_regs.cuh"
#include "tf32x3_wgmma.cuh"

namespace {

__host__ __device__ inline int stage_stride(int B) {
  return B * TS + ((B + 3) / 4) * 4;       // floats a buffer, 16-byte multiple
}

__device__ __forceinline__ void stage_row(float* buf, const float* P,
                                          const float* wn, int r, int B,
                                          int S, int s0, int tid) {
  float* p_dst = buf;
  float* w_dst = buf + B * TS;
  const float* prow = P + (size_t)r * B * S;
  const int chunks = B * (TS / 4);
  for (int e = tid; e < chunks; e += TS) {
    const int b = e / (TS / 4), q = e % (TS / 4);
    const int s = s0 + 4 * q;
    const bool ok = s < S;
    const float* src = ok ? prow + (size_t)b * S + s : P;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(p_dst + b * TS + 4 * q)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
  for (int b = tid; b < B; b += TS)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(w_dst + b)),
                 "l"(wn + (size_t)r * B + b));
}

__global__ void probe_stage_kernel(const float* __restrict__ P,
                                   const float* __restrict__ wn,
                                   const float* __restrict__ pad,
                                   const float* __restrict__ freqs,
                                   float* __restrict__ out, int R, int B,
                                   int S, int uniform_w) {
  extern __shared__ __align__(16) float smem[];
  const int stride = stage_stride(B);
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * TS, s = s0 + tid;
  const bool live = s < S;
  const float f = live ? freqs[s] : 0.f;

  int r = blockIdx.x;
  if (r < R) stage_row(smem, P, wn, r, B, S, s0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; r < R; ++it, r += gridDim.x) {
    float* cur = smem + (it & 1) * stride;
    float* nxt = smem + ((it + 1) & 1) * stride;
    __syncthreads();   // every thread is done with the previous row's buffer
    if (r + (int)gridDim.x < R)
      stage_row(nxt, P, wn, r + gridDim.x, B, S, s0, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();   // the row in `cur` has arrived for every thread
    float* p_sm = cur;
    float* w_sm = cur + B * TS;
    int d = 0;
    for (int b = 0; b < B; ++b)
      if (w_sm[b] != 0.f) p_sm[(d++) * TS + tid] = p_sm[b * TS + tid];
    __syncthreads();
    compact_kept_weights(w_sm, B, tid);
    if (live)
      out[(size_t)r * S + s] =
          rank_fwd_slice(p_sm, w_sm, d, tid, f, pad[r], uniform_w);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- rows of B <= W entries: the ring and the register loop ----------------

constexpr int W = rank_regs::W;
constexpr int STAGES = 3;          // rows in the ring
constexpr int TSB = 128;           // slices a block at most: a whole row
constexpr int TILE = 64;           // slices a block of the tensor map's

// A stage's columns of a row (its P block is B x cols) at S slices: the
// whole row where S <= TSB, else a tensor map's tile.
__host__ __device__ inline int cols_of(int S) { return S <= TSB ? S : TILE; }

// Floats of one stage: the P block, then the weights; a multiple of 32
// floats, so every stage starts 128-byte aligned.
__host__ __device__ inline int ring_stage_floats(int B, int cols) {
  return (B * cols + (B + 3) / 4 * 4 + 31) / 32 * 32;
}

// The ring, then the ranks c as [W][TSB] (or [W][TILE] by a tensor map),
// then the barriers, after up to 128 bytes that align the ring.
inline size_t ring_smem_bytes(int B, int S) {
  return 128 +
         sizeof(float) * (STAGES * (size_t)ring_stage_floats(B, cols_of(S)) +
                          W * (size_t)(S <= TSB ? TSB : TILE)) +
         2 * STAGES * sizeof(uint64_t);
}

// one bulk copy of `bytes` (a multiple of 16) from global src to shared
// dst (both 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tf32x3::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(tf32x3::smem_u32(bar))
      : "memory");
}

// Row r's copies into `dst` (its P block B x cols, then the weights),
// completing on `bar`; called by warp 0.  The weights by a bulk copy where
// bulk_w (B a multiple of 4 and wn 16-byte aligned), else by one 4-byte
// cp.async a lane.
template <bool TMAP>
__device__ __forceinline__ void stage_ring_row(
    float* dst, uint64_t* bar, const CUtensorMap* map, const float* P,
    const float* wn, int r, int B, int S, int cols, int s0, bool bulk_w,
    int lane) {
  if (lane == 0) {
    const uint32_t p_bytes = 4u * (uint32_t)B * cols;
    tf32x3::bar_arrive_tx(bar, p_bytes + (bulk_w ? 4u * B : 0u));
    if (TMAP)
      tf32x3::tma_mn(dst, map, bar, s0, 0, r);    // box (TILE, B, 1)
    else
      bulk_copy(dst, P + (size_t)r * B * S, p_bytes, bar);
    if (bulk_w) bulk_copy(dst + B * cols, wn + (size_t)r * B, 4u * B, bar);
  }
  if (!bulk_w) {
    if (lane < B)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       tf32x3::smem_u32(dst + B * cols + lane)),
                   "l"(wn + (size_t)r * B + lane)
                   : "memory");
    tf32x3::bar_arrive_cp(bar);
  }
}

template <bool TMAP, bool UNIF>
__global__ void __launch_bounds__(TSB, 3)
    probe_stage_regs_kernel(const __grid_constant__ CUtensorMap map,
                            const float* __restrict__ P,
                            const float* __restrict__ wn,
                            const float* __restrict__ pad,
                            const float* __restrict__ freqs,
                            float* __restrict__ out, int R, int B, int S,
                            int bulk_w) {
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  const int ld = TMAP ? TILE : S;         // a stage's floats from b to b + 1
  constexpr int NT = TMAP ? TILE : TSB;   // the threads a block at most
  const int stage = ring_stage_floats(B, ld);
  float* c_sm = ring + STAGES * stage;    // [W][NT], the thread's column
  uint64_t* full = reinterpret_cast<uint64_t*>(c_sm + W * NT);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int s0 = TMAP ? blockIdx.y * TILE : 0;
  const int s = s0 + tid;
  const bool live = s < S;
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) {
      // thread 0's expect_tx, and warp 0's cp.async arrivals if any
      tf32x3::bar_init(full + k, bulk_w ? 1 : 33);
      tf32x3::bar_init(empty + k, blockDim.x);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int rows =
      (int)blockIdx.x < R ? (R - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  if (tid < 32)
    for (int n = 0; n < STAGES - 1 && n < rows; ++n)
      stage_ring_row<TMAP>(ring + n * stage, full + n, &map, P, wn,
                           blockIdx.x + n * gridDim.x, B, S, ld, s0, bulk_w,
                           tid);
  const float f = live ? freqs[s] : 0.f;
  float pr_next = rows > 0 ? pad[blockIdx.x] : 0.f;
  for (int n = 0; n < rows; ++n) {
    const int r = blockIdx.x + n * gridDim.x;
    const float pr = pr_next;
    if (n + 1 < rows) pr_next = pad[r + gridDim.x];
    // the row STAGES - 1 ahead, into the stage of row n - 1 once every
    // thread has read that row
    const int m = n + STAGES - 1;
    if (tid < 32 && m < rows) {
      if (n > 0)
        tf32x3::bar_wait(empty + (n - 1) % STAGES, ((n - 1) / STAGES) & 1);
      stage_ring_row<TMAP>(ring + (m % STAGES) * stage, full + m % STAGES,
                           &map, P, wn, blockIdx.x + m * gridDim.x, B, S, ld,
                           s0, bulk_w, tid);
    }
    const int k = n % STAGES;
    tf32x3::bar_wait(full + k, (n / STAGES) & 1);
    const float* p_sm = ring + k * stage;
    const float* w_sm = p_sm + B * ld;
    float p[W], w[W], c[W];
#pragma unroll
    for (int b = 0; b < W; ++b) {
      p[b] = b < B ? p_sm[b * ld + tid] : 0.f;
      w[b] = b < B ? w_sm[b] : 0.f;
    }
    // one past the last real entry: bit b of `real` says that entry b
    // weighs nonzero, one weight a lane, the same on every lane, so the
    // quadrature's loop is uniform
    const int lane = tid & 31;
    const unsigned real =
        __ballot_sync(0xffffffffu, lane < B && w_sm[lane] != 0.f);
    const int end = 32 - __clz(real);
    if (!live) {
      tf32x3::bar_arrive(empty + k);
      continue;
    }
    rank_regs::rank(p, w, c);
    float wr = 0.f;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      if (UNIF) wr = fmaxf(wr, w[b]);
      c_sm[b * NT + tid] = c[b] + ((p[b] > 0.f) ? pr : 0.f);
    }
    // K2f's quadrature over the real entries in order: a loop over the
    // column in shared memory (the stage is released after it), which
    // ends at the last real entry; a zero-weight entry before it is
    // computed and its term selected away (exactly 0, whatever its
    // projection)
    const FwdFreq z = fwd_freq(f, UNIF, wr);
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < end; ++i) {
      const float wi = w_sm[i];
      const float t = fmaf(p_sm[i * ld + tid],
                           fwd_sd(z, wi, c_sm[i * NT + tid], UNIF), acc);
      acc = wi != 0.f ? t : acc;
    }
    tf32x3::bar_arrive(empty + k);
    out[(size_t)r * S + s] = (1.f + f) * acc;
  }
}

// 0: the shared-memory loop and its cp.async rows; 1: the register loop,
// one bulk copy a row; 2: the register loop, a tensor map's tiles.
inline int loop_of(int B, int S) {
  return B > W ? 0 : (S <= TSB ? 1 : 2);
}

inline size_t smem_of(int B, int S) {
  return B <= W ? ring_smem_bytes(B, S)
                : sizeof(float) * 2 * (size_t)stage_stride(B);
}

// Blocks of `kern` (threads a block, dynamic shared memory smem) that the
// card holds at once; 0 on an error (in *e).
template <typename K>
long long resident_blocks(K kern, int threads, size_t smem, cudaError_t* e) {
  if (smem > 48 * 1024 &&
      (*e = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*e = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess)
    return 0;
  if ((*e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return 0;
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

template <bool TMAP, bool UNIF>
int launch_regs(const CUtensorMap& map, const float* P, const float* wn,
                const float* pad, const float* freqs, float* out, int R,
                int B, int S, cudaStream_t stream) {
  auto kern = probe_stage_regs_kernel<TMAP, UNIF>;
  const int tiles = TMAP ? cdiv(S, TILE) : 1;
  const int threads = TMAP ? TILE : cdiv(S, 32) * 32;
  const size_t smem = ring_smem_bytes(B, S);
  cudaError_t e = cudaSuccess;
  const long long resident = resident_blocks(kern, threads, smem, &e);
  if (e != cudaSuccess) return (int)e;
  const long long gx = resident / tiles > 0 ? resident / tiles : 1;
  const dim3 grid((unsigned)(gx < R ? gx : R), (unsigned)tiles);
  const int bulk_w = B % 4 == 0 && (reinterpret_cast<uintptr_t>(wn) & 15) == 0;
  kern<<<grid, threads, smem, stream>>>(map, P, wn, pad, freqs, out, R, B, S,
                                        bulk_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that a launch at width B and S slices
// needs.
size_t probe_stage_smem_bytes(int B, int S) { return smem_of(B, S); }

// The loop and staging a launch at width B and S slices takes: 0 the
// shared-memory loop (rows wider than rank_regs::W), 1 the register loop
// with one bulk copy a row, 2 the register loop with a tensor map.
int probe_stage_loop(int B, int S) { return loop_of(B, S); }

// K2f's arguments (see fsw_rank_fwd.cu), S a multiple of 4 and P 16-byte
// aligned.  The grid holds as many blocks as fit the card at once, each
// walking its rows.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); does not synchronise.
int probe_stage_f32(const void* P, const void* wn, const void* pad,
                    const void* freqs, void* out, int R, int B, int S,
                    int uniform_w, void* stream) {
  const float* Pf = (const float*)P;
  const float* wf = (const float*)wn;
  const float* pf = (const float*)pad;
  const float* ff = (const float*)freqs;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int loop = loop_of(B, S);
  if (smem_of(B, S) > SMEM_LIMIT || S % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(P) & 15) ||
      cdiv(S, loop == 0 ? TS : TILE) > 65535)
    return (int)cudaErrorInvalidValue;
  if (loop > 0) {
    CUtensorMap map;
    memset(&map, 0, sizeof(map));
    if (loop == 2) {
      const tf32x3::EncodeTiled fn = tf32x3::encoder();
      const cuuint64_t dims[3] = {(cuuint64_t)S, (cuuint64_t)B,
                                  (cuuint64_t)R};
      const cuuint64_t strides[2] = {(cuuint64_t)S * sizeof(float),
                                     (cuuint64_t)B * S * sizeof(float)};
      const cuuint32_t box[3] = {TILE, (cuuint32_t)B, 1};
      const cuuint32_t estr[3] = {1, 1, 1};
      if (!fn ||
          fn(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)P, dims,
             strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
      return uniform_w
                 ? launch_regs<true, true>(map, Pf, wf, pf, ff, of, R, B, S, st)
                 : launch_regs<true, false>(map, Pf, wf, pf, ff, of, R, B, S,
                                            st);
    }
    return uniform_w
               ? launch_regs<false, true>(map, Pf, wf, pf, ff, of, R, B, S, st)
               : launch_regs<false, false>(map, Pf, wf, pf, ff, of, R, B, S,
                                           st);
  }
  const size_t smem = smem_of(B, S);
  const int tiles = cdiv(S, TS);
  cudaError_t e = cudaSuccess;
  const long long resident = resident_blocks(probe_stage_kernel, TS, smem,
                                             &e);
  if (e != cudaSuccess) return (int)e;
  const long long gx = resident / tiles > 0 ? resident / tiles : 1;
  const dim3 grid((unsigned)(gx < R ? gx : R), (unsigned)tiles);
  probe_stage_kernel<<<grid, TS, smem, st>>>(Pf, wf, pf, ff, of, R, B, S,
                                             uniform_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
