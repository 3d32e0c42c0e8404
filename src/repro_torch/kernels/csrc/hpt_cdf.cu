// K2: batched HPT GetCDF (paper Alg. 1).
//
// Replaces repro/kernels/hpt_cdf.py::_cdf_kernel_gather, which pinned both
// HPT tables whole in VMEM and walked a block of queries in vector lanes.
// On Hopper the default table pair (1024 x 128 x 2 x 4 B = 1 MB) does not
// fit a block's 227 KB of shared memory, so the tables stay in device memory
// and are read through the read-only path (__ldg); the rows the walk touches
// most stay in the 50 MB L2.
//
// Bound: bytes.  Per query the function reads its row, length and start
// once, two table floats per active step, and writes one float; it does
// three float ops per step.  What a walk of one thread per query costs
// instead is latency: a byte, then the two table floats, per step, one
// after the other.  So a group of G lanes walks each query
// (lits_cdf_group.cuh): one coalesced pass over the row's bytes, the FNV
// states folded from shuffled bytes, every table read of the walk in
// flight at once, then the sum in the reference's step order.  A block of
// 256 threads holds 256 / G queries.
#include "lits_cdf_group.cuh"

namespace {

constexpr int G = lits::kCdfGroup;

__global__ void __launch_bounds__(lits::kBlock)
hpt_cdf_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
               const int* __restrict__ start, const float* __restrict__ cdf_tab,
               const float* __restrict__ prob_tab, int B, int L, int R, int C,
               int steps, float* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * (lits::kBlock / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  int n_act = 0, st = 0;
  if (b < B) {  // no early return: every lane of the warp takes part in the shuffles
    st = __ldg(start + b);
    n_act = lits::cdf_active_steps(__ldg(qlens + b), st, steps);
  }
  const float cdf = lits::group_cdf(q + (b < B ? b : 0) * L, L, n_act, st, cdf_tab,
                                    prob_tab, R, C, lane);
  if (b < B && lane == 0) out[b] = cdf;
}

}  // namespace

extern "C" int lits_hpt_cdf(const uint8_t* q, const int* qlens, const int* start,
                            const float* cdf_tab, const float* prob_tab, int B, int L,
                            int R, int C, int max_steps, float* out, void* stream) {
  constexpr int per_block = lits::kBlock / G;
  const int grid = (B + per_block - 1) / per_block;
  hpt_cdf_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, start, cdf_tab, prob_tab, B, L, R, C, max_steps < L ? max_steps : L, out);
  return static_cast<int>(cudaGetLastError());
}
