// Device functions shared by the LITS kernels (K1 locate, K2 GetCDF,
// K3 h-pointer probe, K4 fused walk; the string compares are in
// lits_rank.cuh and lits_words.cuh).  Each reproduces the reference's
// arithmetic bit for bit:
//   * the CDF step is two separately rounded float32 ops (mul_ftz then
//     add_ftz): the reference does not contract it, and nvcc would;
//   * the locate step is one fused multiply-add (fma_ftz): the reference
//     contracts it;
//   * subnormals are flushed as XLA on the CPU flushes them: a subnormal
//     operand counts as a zero of its sign, a subnormal result becomes one;
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

// The float32 ops of the GetCDF and locate arithmetic, round to nearest
// even, with subnormal operands and results flushed to zeros of their sign.
// Written as PTX .ftz instructions so that no compiler flag decides it.
// A result is tiny when its 24-bit rounding with an unbounded exponent is
// below 2**-126, as on x86 (tests/test_torch_cuda.py holds these ops to
// the plain versions' rule around 2**-126).
#ifdef __CUDACC__
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
#endif  // a host compiler takes tests/csrc/host/cuda_runtime.h's stand-ins

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int item_tag(int item) {
  return static_cast<int>((static_cast<uint32_t>(item) >> kPayloadBits) & 0x7u);
}

// clip(floor(fma(alpha, cdf, beta)), 1, nslots - 2); the conversion
// saturates and maps NaN to 0, as XLA's does.
__device__ __forceinline__ int locate(float cdf, float alpha, float beta, int nslots) {
  const int pos = __float2int_rd(fma_ftz(alpha, cdf, beta));
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
