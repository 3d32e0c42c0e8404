// The byte-wise compare of two pool keys, the byte path that
// lits_words.cuh's cmp_pool_keys (K6's merge) takes where a key's aligned
// chunks would leave its pool.  It reproduces repro/kernels/strops.py
// (_cmp_tail, str_cmp_pools) bit for bit: the first differing byte of the
// two zero-padded W-byte windows decides, else the sign of the length
// difference; each key is read as W bytes from its pool, every index
// clamped into the pool, and masked to 0 past its length.
#pragma once

#include "lits_walk.cuh"

namespace lits {

__device__ __forceinline__ int sign(int d) { return (d > 0) - (d < 0); }

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

}  // namespace lits
