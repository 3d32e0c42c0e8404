// K1: fused HPT GetCDF + model-node locate (paper Alg. 2, l.35-37).
//
// Replaces repro/kernels/hpt_locate.py::_locate_kernel:
//   pos = clip(floor(fma(alpha, GetCDF(s + start), beta)), 1, nslots - 2)
// The builder launches this entry once per model node to place that node's
// keys; K4 runs the same lits::hpt_cdf + lits::locate inline at every
// model-node step of a lookup.
//
// Bound: bytes, as K2 (the query row, four per-query scalars in and one
// out, two table floats per character).  The tables stay in device memory
// behind __ldg and L2 instead of the TPU's whole-table VMEM blocks, which
// would not fit shared memory; one thread walks one query.
#include "lits_walk.cuh"

namespace {

__global__ void __launch_bounds__(lits::kBlock)
hpt_locate_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
                  const int* __restrict__ start, const float* __restrict__ alpha,
                  const float* __restrict__ beta, const int* __restrict__ nslots,
                  const float* __restrict__ cdf_tab, const float* __restrict__ prob_tab,
                  int B, int L, int R, int C, int steps, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float cdf = lits::hpt_cdf(q + static_cast<long long>(b) * L, L, qlens[b], start[b],
                                  cdf_tab, prob_tab, R, C, steps);
  out[b] = lits::locate(cdf, alpha[b], beta[b], nslots[b]);
}

}  // namespace

extern "C" int lits_hpt_locate(const uint8_t* q, const int* qlens, const int* start,
                               const float* alpha, const float* beta, const int* nslots,
                               const float* cdf_tab, const float* prob_tab, int B, int L,
                               int R, int C, int max_steps, int* out, void* stream) {
  const int grid = (B + lits::kBlock - 1) / lits::kBlock;
  hpt_locate_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, start, alpha, beta, nslots, cdf_tab, prob_tab, B, L, R, C,
      max_steps < L ? max_steps : L, out);
  return static_cast<int>(cudaGetLastError());
}
