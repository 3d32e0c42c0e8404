// The float32 ops of csrc/lits_walk.cuh (mul_ftz, add_ftz, fma_ftz), one
// row of operands per thread, for tests/test_torch_cuda.py to hold against
// the plain versions' flush rule on operands around 2**-126.
#include "lits_walk.cuh"

__global__ void ftz_ops(const float* a, const float* b, const float* c, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[3 * i] = lits::mul_ftz(a[i], b[i]);
    out[3 * i + 1] = lits::add_ftz(a[i], b[i]);
    out[3 * i + 2] = lits::fma_ftz(a[i], b[i], c[i]);
  }
}

extern "C" int lits_ftz_ops(const float* a, const float* b, const float* c, float* out, int n,
                            void* stream) {
  ftz_ops<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, out, n);
  return static_cast<int>(cudaGetLastError());
}
