// Device functions shared by the LITS kernels (K1 locate, K2 GetCDF, K4
// fused walk and its one-thread h-pointer probe; the string compares are
// in lits_rank.cuh and lits_words.cuh).  Each reproduces the reference's
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

// The h-pointer probe of one thread (K4's compact-node resolve), over
// chunks of kProbeChunk slots: one uint32_t match mask a chunk.
constexpr int kProbeChunk = 32;

// Bit j set where slot s = c0 + j lies in [max(frm, 0), min(cnt, cap)) and
// hashes[clamp(base + s)] == qh: the reference's gather clip, so a slot past
// the pool's end reads its last element.  Every load of the chunk is issued
// before any compare, so a chunk costs one round trip to L2 or memory, not
// one per slot; a slot past the window is not loaded.
__device__ __forceinline__ uint32_t probe_mask(const int* __restrict__ hashes, long long base,
                                               long long n, int qh, int cnt, int frm, int cap,
                                               int c0) {
  const int lo = max(max(frm, 0) - c0, 0);
  const int end = min(min(cnt, cap) - c0, kProbeChunk);
  if (end <= lo) return 0;
  int h[kProbeChunk];
#pragma unroll
  for (int j = 0; j < kProbeChunk; ++j) {
    h[j] = j < end ? __ldg(hashes + clamp_index(base + c0 + j, n)) : 0;
  }
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < kProbeChunk; ++j) m |= static_cast<uint32_t>(h[j] == qh) << j;
  const uint32_t below_end = end >= 32 ? ~0u : (1u << end) - 1u;
  return m & below_end & ~((1u << lo) - 1u);
}

// The lowest slot j in [max(frm, 0), min(cnt, cap)) whose hash equals qh and
// for which is_key(j) holds, else -1: the CNODE loop of the reference's
// resolve_terminal (repro/core/walk.py) with is_key the key compare, K3's
// function with is_key always true.  A chunk's hash matches are tried
// lowest first (__ffs, then the lowest bit cleared), so a false 16-bit
// match costs one key compare and no new probe.
template <class IsKey>
__device__ __forceinline__ int probe_first(const int* __restrict__ hashes, long long base,
                                           long long n, int qh, int cnt, int frm, int cap,
                                           IsKey is_key) {
  const int end = min(cnt, cap);
  int first = -1;
  for (int c0 = max(frm, 0); c0 < end && first < 0; c0 += kProbeChunk) {
    for (uint32_t m = probe_mask(hashes, base, n, qh, cnt, frm, cap, c0); m; m &= m - 1) {
      const int j = c0 + __ffs(static_cast<int>(m)) - 1;
      if (is_key(j)) {
        first = j;
        break;
      }
    }
  }
  return first;
}

}  // namespace lits
