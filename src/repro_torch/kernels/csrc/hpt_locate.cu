// K1: fused HPT GetCDF + model-node locate (paper Alg. 2, l.35-37).
//
// Replaces repro/kernels/hpt_locate.py::_locate_kernel:
//   pos = clip(floor(fma(alpha, GetCDF(s + start), beta)), 1, nslots - 2)
// The builder launches this entry once per model node to place that node's
// keys; K4 runs lits::cdf_row + lits::locate inline, one thread per query,
// at every model-node step of a lookup.
//
// Bound: bytes, as K2 (the query row, five per-query scalars in and one
// out, two table floats per active step).  The tables stay in device memory
// behind __ldg and L2 instead of the TPU's whole-table VMEM blocks, which
// would not fit shared memory.  The GetCDF is K2's group walk
// (lits_cdf_group.cuh: G lanes per query, the walk's table reads in flight
// together, the sum in step order); the lane that holds the sum applies
// lits::locate (fma_ftz, saturating __float2int_rd).
#include "lits_cdf_group.cuh"

namespace {

constexpr int G = lits::kCdfGroup;

__global__ void __launch_bounds__(lits::kBlock)
hpt_locate_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
                  const int* __restrict__ start, const float* __restrict__ alpha,
                  const float* __restrict__ beta, const int* __restrict__ nslots,
                  const float* __restrict__ cdf_tab, const float* __restrict__ prob_tab,
                  int B, int L, int R, int C, int steps, int* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * (lits::kBlock / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  int n_act = 0, st = 0, ns = 0;
  float a = 0.0f, be = 0.0f;
  if (b < B) {  // no early return: every lane of the warp takes part in the shuffles
    st = __ldg(start + b);
    n_act = lits::cdf_active_steps(__ldg(qlens + b), st, steps);
    a = __ldg(alpha + b);
    be = __ldg(beta + b);
    ns = __ldg(nslots + b);
  }
  const float cdf = lits::group_cdf(q + (b < B ? b : 0) * L, L, n_act, st, cdf_tab,
                                    prob_tab, R, C, lane);
  if (b < B && lane == 0) out[b] = lits::locate(cdf, a, be, ns);
}

}  // namespace

extern "C" int lits_hpt_locate(const uint8_t* q, const int* qlens, const int* start,
                               const float* alpha, const float* beta, const int* nslots,
                               const float* cdf_tab, const float* prob_tab, int B, int L,
                               int R, int C, int max_steps, int* out, void* stream) {
  constexpr int per_block = lits::kBlock / G;
  const int grid = (B + per_block - 1) / per_block;
  hpt_locate_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, start, alpha, beta, nslots, cdf_tab, prob_tab, B, L, R, C,
      max_steps < L ? max_steps : L, out);
  return static_cast<int>(cudaGetLastError());
}
