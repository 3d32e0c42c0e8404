// K7: batched HPT GetCDF (paper Alg. 1) with the table read done as a
// one-hot contraction.
//
// Replaces repro/kernels/hpt_cdf.py::_cdf_kernel_onehot, which selected each
// step's table values on the TPU's matrix unit: a (B, R) one-hot of the
// hash rows times the (R, C) table, then a one-hot column select.  Here the
// same contraction runs on the CUDA cores in float32, one warp per query:
// the 32 lanes sweep the R rows of the step's column, each summing
// (r == row) * tab[r][c] over its rows, and a butterfly shuffle adds the 32
// partial sums.  Exactly one weight is 1 and the rest are 0, so on a finite
// table the sum is that one entry exactly, whatever the order of the adds,
// and the walk equals K2's bit for bit.  The CDF step itself is K2's: two
// separately rounded float32 ops (__fmul_rn, __fadd_rn).
//
// Bound: operations.  Every active step does 4 * R float ops (a multiply
// and an add per row, for both tables) where K2 does three; the bytes the
// function must move are K2's.  In practice the column reads dominate: 2 * R
// floats, C * 4 bytes apart, so each is its own L2 sector.  No tensor cores
// and no TF32; this kernel is expected to be far slower than K2.
#include "lits_walk.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__global__ void __launch_bounds__(lits::kBlock)
hpt_cdf_onehot_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
                      const int* __restrict__ start, const float* __restrict__ cdf_tab,
                      const float* __restrict__ prob_tab, int B, int L, int R, int C,
                      int steps, float* __restrict__ out) {
  const long long b = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (b >= B) return;  // the whole warp leaves together
  const uint8_t* qr = q + b * L;
  const int qlen = qlens[b];
  const int st = start[b];
  float cdf = 0.0f;
  float prob = 1.0f;
  uint32_t h = 0u;
  for (int k = 0; k < steps; ++k) {
    const int pos = st + k;
    if (pos >= qlen) break;
    const int c = min(static_cast<int>(__ldg(qr + min(max(pos, 0), L - 1))), C - 1);
    const int row = static_cast<int>(h & static_cast<uint32_t>(R - 1));
    float cv = 0.0f;
    float pv = 0.0f;
    for (int r = lane; r < R; r += kWarp) {
      const float w = r == row ? 1.0f : 0.0f;
      const long long idx = static_cast<long long>(r) * C + c;
      cv = __fadd_rn(cv, __fmul_rn(w, __ldg(cdf_tab + idx)));
      pv = __fadd_rn(pv, __fmul_rn(w, __ldg(prob_tab + idx)));
    }
    for (int o = kWarp / 2; o > 0; o /= 2) {
      cv = __fadd_rn(cv, __shfl_xor_sync(kFullMask, cv, o));
      pv = __fadd_rn(pv, __shfl_xor_sync(kFullMask, pv, o));
    }
    cdf = __fadd_rn(cdf, __fmul_rn(prob, cv));
    prob = __fmul_rn(prob, pv);
    h = (h ^ static_cast<uint32_t>(c)) * lits::kFnvPrime;
  }
  if (lane == 0) out[b] = cdf;
}

}  // namespace

extern "C" int lits_hpt_cdf_onehot(const uint8_t* q, const int* qlens, const int* start,
                                   const float* cdf_tab, const float* prob_tab, int B, int L,
                                   int R, int C, int max_steps, float* out, void* stream) {
  const long long threads = static_cast<long long>(B) * kWarp;
  const int grid = static_cast<int>((threads + lits::kBlock - 1) / lits::kBlock);
  hpt_cdf_onehot_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, start, cdf_tab, prob_tab, B, L, R, C, max_steps < L ? max_steps : L, out);
  return static_cast<int>(cudaGetLastError());
}
