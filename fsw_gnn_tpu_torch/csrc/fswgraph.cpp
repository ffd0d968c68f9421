// Host-side graph loops of the port: uniform neighbor sampling for
// minibatch training and coalesced CSR construction.
//
// The port's own copy of the JAX package's native helper, with the same C
// interface and the same arithmetic, so that one seed draws the same
// samples in both packages.  It is plain C++ for the host compiler, not a
// CUDA source: `kernels.load_host('fswgraph')` builds it at first use
// (c++ -O3 -fPIC -std=c++17 -shared) and `data/sampler.py` binds it with
// ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

// SplitMix64: tiny, fast, seedable PRNG for sampling decisions.
struct SplitMix64 {
    uint64_t state;
    explicit SplitMix64(uint64_t seed) : state(seed) {}
    uint64_t next() {
        uint64_t z = (state += 0x9E3779B97f4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    // unbiased bounded sample via rejection
    uint64_t bounded(uint64_t n) {
        uint64_t threshold = (~n + 1) % n; // 2^64 mod n
        for (;;) {
            uint64_t r = next();
            if (r >= threshold) return r % n;
        }
    }
};

}  // namespace

extern "C" {

// Uniform in-neighbor sampling: for each seed, emit up to `fanout` distinct
// in-neighbors (all of them when degree <= fanout; otherwise a Floyd sample
// without replacement).  Writes (src, dst) pairs; returns the number of
// emitted edges.
long long fsw_sample_neighbors(const long long* row_ptr,
                               const long long* col_idx,
                               const long long* seeds,
                               long long num_seeds,
                               long long fanout,
                               unsigned long long rng_seed,
                               long long* out_src,
                               long long* out_dst) {
    SplitMix64 rng(rng_seed);
    long long* chosen = new long long[std::max(fanout, 1LL)];
    long long out = 0;
    for (long long i = 0; i < num_seeds; ++i) {
        const long long s = seeds[i];
        const long long lo = row_ptr[s], hi = row_ptr[s + 1];
        const long long deg = hi - lo;
        if (deg <= fanout) {
            for (long long e = lo; e < hi; ++e) {
                out_src[out] = col_idx[e];
                out_dst[out] = s;
                ++out;
            }
        } else {
            // Floyd's algorithm over OFFSETS in [0, deg): the membership
            // test compares chosen offsets, not node ids, so duplicate
            // edges (the CSC is not coalesced) are sampled like any other
            // offset, as the numpy path's choice without replacement does.
            long long n_chosen = 0;
            for (long long j = deg - fanout; j < deg; ++j) {
                long long t = (long long)rng.bounded((uint64_t)(j + 1));
                bool seen = false;
                for (long long k = 0; k < n_chosen; ++k) {
                    if (chosen[k] == t) { seen = true; break; }
                }
                long long pick = seen ? j : t;
                chosen[n_chosen++] = pick;
                out_src[out] = col_idx[lo + pick];
                out_dst[out] = s;
                ++out;
            }
        }
    }
    delete[] chosen;
    return out;
}

// Coalesced CSR construction from an unsorted (src, dst, weight) edge list:
// counting sort by dst then src, duplicate (dst, src) pairs merged by
// weight summation.  Returns the number of unique edges; out arrays must
// have capacity num_edges.  row_ptr_out must have capacity num_recipients+1.
long long fsw_build_csr(const long long* src,
                        const long long* dst,
                        const double* weight,
                        long long num_edges,
                        long long num_nodes,
                        long long num_recipients,
                        long long* out_src,
                        long long* out_dst,
                        double* out_weight,
                        long long* row_ptr_out) {
    (void)num_nodes;
    // counting sort by dst
    long long* cnt = new long long[num_recipients + 1];
    std::memset(cnt, 0, sizeof(long long) * (num_recipients + 1));
    for (long long e = 0; e < num_edges; ++e) cnt[dst[e] + 1]++;
    for (long long r = 0; r < num_recipients; ++r) cnt[r + 1] += cnt[r];

    long long* tmp_src = new long long[num_edges];
    double* tmp_w = new double[num_edges];
    long long* cursor = new long long[num_recipients];
    for (long long r = 0; r < num_recipients; ++r) cursor[r] = cnt[r];
    for (long long e = 0; e < num_edges; ++e) {
        long long pos = cursor[dst[e]]++;
        tmp_src[pos] = src[e];
        tmp_w[pos] = weight ? weight[e] : 1.0;
    }

    // sort each dst-segment by src (weights follow via pair packing) and
    // merge duplicate (dst, src) entries by weight summation
    std::pair<long long, double>* seg =
        new std::pair<long long, double>[num_edges];
    long long out = 0;
    for (long long r = 0; r < num_recipients; ++r) {
        long long lo = cnt[r], hi = cnt[r + 1];
        row_ptr_out[r] = out;
        if (lo == hi) continue;
        for (long long e = lo; e < hi; ++e)
            seg[e - lo] = {tmp_src[e], tmp_w[e]};
        std::sort(seg, seg + (hi - lo));
        long long seg_start = out;
        for (long long e = 0; e < hi - lo; ++e) {
            if (out > seg_start && out_src[out - 1] == seg[e].first) {
                out_weight[out - 1] += seg[e].second;
            } else {
                out_src[out] = seg[e].first;
                out_dst[out] = r;
                out_weight[out] = seg[e].second;
                ++out;
            }
        }
    }
    row_ptr_out[num_recipients] = out;
    delete[] seg;

    delete[] cnt;
    delete[] tmp_src;
    delete[] tmp_w;
    delete[] cursor;
    return out;
}

}  // extern "C"
