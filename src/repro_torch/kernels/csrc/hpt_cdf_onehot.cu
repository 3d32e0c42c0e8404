// K7: batched HPT GetCDF (paper Alg. 1) with each table value taken as a
// one-hot contraction gives it.
//
// Replaces repro/kernels/hpt_cdf.py::_cdf_kernel_onehot, which selected each
// step's table values on the TPU's matrix unit: a (B, R) one-hot of the
// hash rows times the (R, C) table in true float32, then a select of the
// step's column c.  Only one weight is non-zero, and its row and column are
// known before any read, so the contraction's value is one table entry,
// with one exception: in a true float32 product a zero weight on an inf or
// NaN gives NaN.  So a step's value is tab[row, c], or NaN where column c
// holds a non-finite entry in another row.
//
// Doing the product on the tensor cores would cost 2 * B * R * C flops per
// step and table (about 2.2 TFLOP over 64 steps at 65,536 rows and the
// default 1024 x 128 table, three times that for exact float32 from bf16
// pieces): some 8 ms at best, 200 times what the function needs.  Instead
// this is K2's walk (lits_cdf_group.cuh: a group of 8 lanes per query, the
// row's bytes in one coalesced pass, FNV states folded from shuffles, all
// table reads in flight, the sum in step order with mul_ftz/add_ftz),
// with a hook that turns a value read into NaN where
// count[c] - !isfinite(tab[row, c]) > 0; the wrapper makes the (C,) count
// of non-finite entries per column once per table (kernels/hpt_cdf.py,
// nonfinite_columns).
//
// Bound: bytes, K2's (the row, three per-query words, two table floats per
// active step) and the two C-entry count tables; K7 computes K2's function
// on finite tables.
#include "lits_cdf_group.cuh"

namespace {

constexpr int G = lits::kCdfGroup;

// The one-hot contraction's value of a table entry read at column c.
struct OneHotValues {
  const int* cdf_bad;   // (C,) non-finite entries per column of cdf_tab
  const int* prob_bad;  // the same of prob_tab

  // NaN where the column holds a non-finite entry other than v itself
  static __device__ __forceinline__ float pick(float v, int bad_in_column) {
    const int v_bad = (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;  // inf or NaN
    return bad_in_column - v_bad > 0 ? __uint_as_float(0x7fc00000u) : v;
  }

  __device__ __forceinline__ void operator()(int c, float& cval, float& pval) const {
    cval = pick(cval, __ldg(cdf_bad + c));
    pval = pick(pval, __ldg(prob_bad + c));
  }
};

__global__ void __launch_bounds__(lits::kBlock)
hpt_cdf_onehot_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
                      const int* __restrict__ start, const float* __restrict__ cdf_tab,
                      const float* __restrict__ prob_tab, const int* __restrict__ cdf_bad,
                      const int* __restrict__ prob_bad, int B, int L, int R, int C, int steps,
                      float* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * (lits::kBlock / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  int n_act = 0, st = 0;
  if (b < B) {  // no early return: every lane of the warp takes part in the shuffles
    st = __ldg(start + b);
    n_act = lits::cdf_active_steps(__ldg(qlens + b), st, steps);
  }
  const float cdf = lits::group_cdf(q + (b < B ? b : 0) * L, L, n_act, st, cdf_tab, prob_tab,
                                    R, C, lane, OneHotValues{cdf_bad, prob_bad});
  if (b < B && lane == 0) out[b] = cdf;
}

}  // namespace

extern "C" int lits_hpt_cdf_onehot(const uint8_t* q, const int* qlens, const int* start,
                                   const float* cdf_tab, const float* prob_tab,
                                   const int* cdf_bad, const int* prob_bad, int B, int L, int R,
                                   int C, int max_steps, float* out, void* stream) {
  constexpr int per_block = lits::kBlock / G;
  const int grid = (B + per_block - 1) / per_block;
  hpt_cdf_onehot_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, start, cdf_tab, prob_tab, cdf_bad, prob_bad, B, L, R, C,
      max_steps < L ? max_steps : L, out);
  return static_cast<int>(cudaGetLastError());
}
