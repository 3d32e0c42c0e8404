// K2: batched HPT GetCDF (paper Alg. 1).
//
// Replaces repro/kernels/hpt_cdf.py::_cdf_kernel_gather, which pinned both
// HPT tables whole in VMEM and walked a block of queries in vector lanes.
// On Hopper the default table pair (1024 x 128 x 2 x 4 B = 1 MB) does not
// fit a block's 227 KB of shared memory, so the tables stay in device memory
// and are read through the read-only path (__ldg); the rows the walk touches
// most stay in the 50 MB L2.
//
// Bound: bytes.  Per query the kernel reads its row and lengths once and
// two table floats per character; there are a handful of integer and float
// ops per byte moved.  One thread walks one query, so the per-character
// loop (a chain of dependent table reads through the rolling hash) runs in
// each thread while 256-thread blocks keep enough loads in flight to hide
// their latency.  Warp-cooperative or shared-memory variants are later work.
#include "lits_walk.cuh"

namespace {

__global__ void __launch_bounds__(lits::kBlock)
hpt_cdf_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
               const int* __restrict__ start, const float* __restrict__ cdf_tab,
               const float* __restrict__ prob_tab, int B, int L, int R, int C,
               int steps, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = lits::hpt_cdf(q + static_cast<long long>(b) * L, L, qlens[b], start[b],
                         cdf_tab, prob_tab, R, C, steps);
}

}  // namespace

extern "C" int lits_hpt_cdf(const uint8_t* q, const int* qlens, const int* start,
                            const float* cdf_tab, const float* prob_tab, int B, int L,
                            int R, int C, int max_steps, float* out, void* stream) {
  const int grid = (B + lits::kBlock - 1) / lits::kBlock;
  hpt_cdf_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, start, cdf_tab, prob_tab, B, L, R, C, max_steps < L ? max_steps : L, out);
  return static_cast<int>(cudaGetLastError());
}
