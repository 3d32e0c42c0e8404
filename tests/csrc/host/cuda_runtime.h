// Host stand-ins for the CUDA types and intrinsics that the port's
// single-thread device functions use, so that words_check.cpp and
// probe_check.cpp can compile src/repro_torch/kernels/csrc/lits_words.cuh
// and lits_walk.cuh with a host C++ compiler.
// Warp-level intrinsics abort: the group functions are checked on the card.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#define __device__
#define __host__
#define __forceinline__ inline
#define __global__

struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct int4 { int x, y, z, w; };
struct dim3 { unsigned x, y, z; };
extern dim3 threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;

// Loads outside [g_lo, g_hi) abort when g_hi is set: the word path must read
// only inside the pool it is given.
extern uintptr_t g_lo, g_hi;
template <class T>
inline T __ldg(const T* p) {
  if (g_hi && (reinterpret_cast<uintptr_t>(p) < g_lo ||
               reinterpret_cast<uintptr_t>(p) + sizeof(T) > g_hi)) {
    std::fprintf(stderr, "load outside the pool\n");
    std::abort();
  }
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return static_cast<unsigned>(((static_cast<uint64_t>(hi) << 32) | lo) >> (sh & 31));
}
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(b) << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= ((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __float2int_rd(float x) { return static_cast<int>(std::floor(x)); }
inline void __syncthreads() {}
inline unsigned __ballot_sync(unsigned, bool) { std::abort(); }
template <class T> T __shfl_sync(unsigned, T, int, int = 32) { std::abort(); }
using std::max;
using std::min;

// lits_walk.cuh's PTX .ftz float ops: subnormal operands and results
// become zeros of their sign; a product is tiny when, rounded to 24 bits
// with an unbounded exponent, it is below 2**-126 (x86's and the card's
// rule), checked on the product scaled by 2**64.
namespace lits {
inline float flush(float x) { return std::fabs(x) < 0x1p-126f ? x * 0.0f : x; }
inline float mul_ftz(float a, float b) {
  a = flush(a);
  b = flush(b);
  volatile float r = a * b;
  volatile float scaled = (a * 0x1p64f) * b;
  return std::fabs(scaled) < 0x1p-62f ? r * 0.0f : r;
}
inline float add_ftz(float a, float b) {
  volatile float r = flush(a) + flush(b);
  return flush(r);
}
inline float fma_ftz(float a, float b, float c) {
  return flush(std::fmaf(flush(a), flush(b), flush(c)));
}
}  // namespace lits
