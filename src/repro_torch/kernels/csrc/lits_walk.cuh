// Device functions shared by the LITS kernels (K1 locate, K2 GetCDF,
// K3 h-pointer probe, K4 fused walk; the string compares are in
// lits_rank.cuh and lits_words.cuh).  Each reproduces the reference's
// arithmetic bit for bit:
//   * the CDF step is two separately rounded float32 ops (__fmul_rn then
//     __fadd_rn): the reference does not contract it, and nvcc would;
//   * the locate step is one fused multiply-add (__fmaf_rn): the reference
//     contracts it;
//   * every pool index is clamped into its pool, as the reference's gathers
//     clip;
//   * the FNV-1a hashes are uint32 with wraparound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lits {

constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr int kTagEntry = 1;
constexpr int kTagMnode = 2;
constexpr int kTagCnode = 3;
constexpr int kTagTrie = 4;
constexpr int kPayloadBits = 28;
constexpr int kPayloadMask = (1 << kPayloadBits) - 1;
constexpr int kBlock = 256;

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int item_tag(int item) {
  return static_cast<int>((static_cast<uint32_t>(item) >> kPayloadBits) & 0x7u);
}

// clip(floor(fma(alpha, cdf, beta)), 1, nslots - 2); the conversion
// saturates and maps NaN to 0, as XLA's does.
__device__ __forceinline__ int locate(float cdf, float alpha, float beta, int nslots) {
  const int pos = __float2int_rd(__fmaf_rn(alpha, cdf, beta));
  return min(max(pos, 1), nslots - 2);
}

// First j in [frm, min(cnt, cap)) with hashes[base + j] == qh, else -1.
__device__ __forceinline__ int probe(const int* __restrict__ hashes, long long base,
                                     long long n, int qh, int cnt, int frm, int cap) {
  const int end = min(cnt, cap);
  for (int j = max(frm, 0); j < end; ++j) {
    if (__ldg(hashes + clamp_index(base + j, n)) == qh) return j;
  }
  return -1;
}

}  // namespace lits
