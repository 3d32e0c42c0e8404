// Device functions of the ordered side (K5 rank, K6 scan): the full-key
// compare and the lower-bound binary search.  They reproduce
// repro/kernels/strops.py (_cmp_tail, str_cmp_full, str_cmp_pools) and
// repro/core/walk.py::rank_sorted bit for bit:
//   * one ordering rule: the first differing byte of the two zero-padded
//     W-byte windows decides, else the sign of the length difference;
//   * a key is read as W bytes from its pool, every index clamped into the
//     pool, and masked to 0 past its length; a query row is taken as it is
//     (its padding is zero, and an over-width row carries length W + 1);
//   * the search runs its fixed number of steps, and a lane whose interval
//     is empty keeps lo, so stopping there gives the same rank.
#pragma once

#include "lits_walk.cuh"

namespace lits {

__device__ __forceinline__ int sign(int d) { return (d > 0) - (d < 0); }

// sign(strcmp) of the zero-padded query row q (W bytes, length qlen)
// against pool[off : off + klen].
__device__ __forceinline__ int str_cmp_full(const uint8_t* __restrict__ q, int W, int qlen,
                                            const uint8_t* __restrict__ pool, long long npool,
                                            long long off, int klen) {
  for (int j = 0; j < W; ++j) {
    const int kv = j < klen ? __ldg(pool + clamp_index(off + j, npool)) : 0;
    const int qv = __ldg(q + j);
    if (qv != kv) return qv < kv ? -1 : 1;
  }
  return sign(qlen - klen);
}

// sign(strcmp(a, b)) of two pool keys, each read as a W-byte window.
__device__ __forceinline__ int str_cmp_pools(const uint8_t* __restrict__ pa, long long na,
                                             long long off_a, int len_a,
                                             const uint8_t* __restrict__ pb, long long nb,
                                             long long off_b, int len_b, int W) {
  for (int j = 0; j < W; ++j) {
    const int va = j < len_a ? __ldg(pa + clamp_index(off_a + j, na)) : 0;
    const int vb = j < len_b ? __ldg(pb + clamp_index(off_b + j, nb)) : 0;
    if (va != vb) return va < vb ? -1 : 1;
  }
  return sign(len_a - len_b);
}

// First rank r in [0, hi) with key(sorted[r]) >= q, by `iters` halvings of
// [lo, hi); sorted has n_sorted rows, and each names an entry of the
// (off, len) tables of n_ent rows over pool.
__device__ __forceinline__ int rank_sorted(const uint8_t* __restrict__ q, int W, int qlen,
                                           const int* __restrict__ sorted, long long n_sorted,
                                           const int* __restrict__ ent_off,
                                           const int* __restrict__ ent_len, long long n_ent,
                                           const uint8_t* __restrict__ pool, long long npool,
                                           int hi, int iters) {
  int lo = 0;
  for (int it = 0; it < iters && lo < hi; ++it) {
    const int mid = (lo + hi) >> 1;
    const long long e = clamp_index(__ldg(sorted + min(static_cast<long long>(mid), n_sorted - 1)),
                                    n_ent);
    if (str_cmp_full(q, W, qlen, pool, npool, __ldg(ent_off + e), __ldg(ent_len + e)) > 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace lits
