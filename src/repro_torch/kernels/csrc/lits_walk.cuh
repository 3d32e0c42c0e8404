// Device functions shared by the LITS kernels (K1 locate, K2 GetCDF,
// K3 h-pointer probe, K4 fused walk).  Each reproduces the reference's
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

// Paper Alg. 1 from character `start` with a fresh hash state, for at most
// `steps` characters.  A step is active while start + k < qlen; once a step
// is inactive every later one is, so the loop ends there.
__device__ __forceinline__ float hpt_cdf(const uint8_t* __restrict__ q, int L, int qlen,
                                         int start, const float* __restrict__ cdf_tab,
                                         const float* __restrict__ prob_tab, int R, int C,
                                         int steps) {
  float cdf = 0.0f;
  float prob = 1.0f;
  uint32_t h = 0u;
  for (int k = 0; k < steps; ++k) {
    const int pos = start + k;
    if (pos >= qlen) break;
    const int c = min(static_cast<int>(__ldg(q + min(max(pos, 0), L - 1))), C - 1);
    const int idx = static_cast<int>(h & static_cast<uint32_t>(R - 1)) * C + c;
    cdf = __fadd_rn(cdf, __fmul_rn(prob, __ldg(cdf_tab + idx)));
    prob = __fmul_rn(prob, __ldg(prob_tab + idx));
    h = (h ^ static_cast<uint32_t>(c)) * kFnvPrime;
  }
  return cdf;
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

// Exact equality of the zero-padded query row (W bytes) with pool[off:off+klen].
__device__ __forceinline__ bool str_eq(const uint8_t* __restrict__ q, int W, int qlen,
                                       const uint8_t* __restrict__ pool, long long npool,
                                       long long off, int klen) {
  if (qlen != klen) return false;
  for (int j = 0; j < W; ++j) {
    const int kv = j < klen ? __ldg(pool + clamp_index(off + j, npool)) : 0;
    if (kv != __ldg(q + j)) return false;
  }
  return true;
}

// sign(strncmp(q, pool[off:], pl)) over the first min(pl, W) bytes.
__device__ __forceinline__ int str_cmp_prefix(const uint8_t* __restrict__ q, int W,
                                              const uint8_t* __restrict__ pool,
                                              long long npool, long long off, int pl) {
  const int n = min(pl, W);
  for (int j = 0; j < n; ++j) {
    const int kv = __ldg(pool + clamp_index(off + j, npool));
    const int qv = __ldg(q + j);
    if (kv != qv) return qv < kv ? -1 : 1;
  }
  return 0;
}

// 16-bit h-pointer hash over min(qlen, W) bytes.
__device__ __forceinline__ int hash16(const uint8_t* __restrict__ q, int W, int qlen) {
  uint32_t h = kFnvOffset;
  const int n = min(qlen, W);
  for (int k = 0; k < n; ++k) h = (h ^ static_cast<uint32_t>(__ldg(q + k))) * kFnvPrime;
  return static_cast<int>((h ^ (h >> 16)) & 0xFFFFu);
}

}  // namespace lits
