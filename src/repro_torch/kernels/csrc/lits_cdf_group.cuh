// GetCDF (paper Alg. 1) with G = kCdfGroup lanes per query, for the
// standalone GetCDF (K2, hpt_cdf.cu), one-hot GetCDF (K7, hpt_cdf_onehot.cu)
// and locate (K1, hpt_locate.cu) kernels.
// K4 keeps one thread per query for its GetCDF steps (lits_words.cuh,
// cdf_row), inline in its walk.
//
// One thread per query pays two dependent round trips per step: the step's
// byte, then the two table floats the byte and the hash select.  Here the
// steps of a chunk of kChunk are dealt out, step k to lane k % G, and
//   1. the group loads the chunk's bytes in one coalesced pass (consecutive
//      lanes, consecutive bytes), each lane packing its own in 32-bit words;
//   2. every lane folds the FNV-1a state over all of the chunk's bytes,
//      taking them from the others with __shfl_sync (integer ALU work, no
//      memory), and keeps the state before each of its own steps;
//   3. every lane issues all of its table reads at once, so the chunk's
//      reads cost one round trip;
//   4. every lane runs the sum in the reference's order, k = 0 upward, over
//      the values taken from their owners with __shfl_sync:
//      cdf = cdf + prob * cval; prob = prob * pval, each op rounded on its
//      own (mul_ftz, add_ftz).  No tree or warp reduction: a reordered
//      float32 sum would move slots.
// Steps past the query's end are inactive and add nothing, as in the
// reference; they form a suffix, since a step is active while
// start + k < qlen.  Loop bounds are the warp's largest active count, so
// every lane of the warp reaches every shuffle.
//
// What is left, measured on an H100 (PERF.md): a launch of a few dozen
// rows, as the bulk load makes, takes a few microseconds, a third of them
// the launch itself.  At 65,536 rows the scattered table reads still set
// the pace, as they did for one thread per query; with every read served
// from L1 the walk's own work (about a dozen instructions per step for
// 32 / G queries: two shuffles, the hash, the sum) takes two thirds of
// that time, about twice what one thread per query takes.
#pragma once

#include "lits_walk.cuh"

namespace lits {

constexpr int kChunk = 64;              // steps dealt out per pass (MAX_CDF_STEPS)
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// Lanes per query.  8 was the fastest of 8, 16 and 32 at 65,536 rows on an
// H100 and as fast as the others at the bulk load's launch shapes (PERF.md).
constexpr int kCdfGroup = 8;

// What a step makes of the two table values it read at column c: K2 and K1
// take them as they are; K7 (hpt_cdf_onehot.cu) passes its own.
struct TableValues {
  __device__ __forceinline__ void operator()(int c, float& cval, float& pval) const {}
};

// Active steps of a query: start + k < qlen, for k < steps.
__device__ __forceinline__ int cdf_active_steps(int qlen, int start, int steps) {
  return min(max(qlen - start, 0), steps);
}

// GetCDF of row `q` (L bytes) with `n_act` active steps from `start`; `lane`
// is the thread's rank in its group of kCdfGroup.  Every lane of the warp must call
// it (a thread without a query passes n_act = 0); every lane of the group
// returns the same value.  `values` sees each active step's two reads.
template <class Values = TableValues>
__device__ __forceinline__ float group_cdf(const uint8_t* __restrict__ q, int L, int n_act,
                                           int start, const float* __restrict__ cdf_tab,
                                           const float* __restrict__ prob_tab, int R, int C,
                                           int lane, Values values = Values()) {
  constexpr int G = kCdfGroup;
  constexpr int kPer = kChunk / G;          // steps a lane owns per chunk
  constexpr int kWords = (kPer + 3) / 4;    // its bytes, four to a word
  const uint32_t row_mask = static_cast<uint32_t>(R - 1);
  const int warp_act = __reduce_max_sync(kFullMask, n_act);
  uint32_t h = 0u;
  float cdf = 0.0f;
  float prob = 1.0f;
  for (int base = 0; base < warp_act; base += kChunk) {
    const int span = min(warp_act - base, kChunk);  // the same in every lane of the warp
    // 1. bytes, clamped to the row and the character to C - 1
    uint32_t word[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) word[w] = 0u;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = base + r * G + lane;
      if (k < n_act) {
        const int pos = min(max(start + k, 0), L - 1);
        const uint32_t c = min(static_cast<uint32_t>(__ldg(q + pos)),
                               static_cast<uint32_t>(C - 1));
        word[r / 4] |= c << (8 * (r % 4));
      }
    }
    // 2. FNV-1a states: the state before step base + r*G + lane
    uint32_t hk[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) hk[r] = 0u;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (4 * w * G >= span) break;
      uint32_t x[G];
#pragma unroll
      for (int j = 0; j < G; ++j) x[j] = __shfl_sync(kFullMask, word[w], j, G);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = 4 * w + t;
        if (r >= kPer || r * G >= span) break;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (lane == j) hk[r] = h;
          h = (h ^ ((x[j] >> (8 * t)) & 0xFFu)) * kFnvPrime;
        }
      }
    }
    // 3. table reads, all in flight together
    float cv[kPer], pv[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      cv[r] = 0.0f;
      pv[r] = 1.0f;
      if (base + r * G + lane < n_act) {
        const int c = static_cast<int>((word[r / 4] >> (8 * (r % 4))) & 0xFFu);
        const int idx = static_cast<int>(hk[r] & row_mask) * C + c;
        cv[r] = __ldg(cdf_tab + idx);
        pv[r] = __ldg(prob_tab + idx);
        values(c, cv[r], pv[r]);
      }
    }
    // 4. the sum, in step order
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (r * G >= span) break;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float cval = __shfl_sync(kFullMask, cv[r], j, G);
        const float pval = __shfl_sync(kFullMask, pv[r], j, G);
        if (base + r * G + j < n_act) {
          cdf = add_ftz(cdf, mul_ftz(prob, cval));
          prob = mul_ftz(prob, pval);
        }
      }
    }
  }
  return cdf;
}

}  // namespace lits
