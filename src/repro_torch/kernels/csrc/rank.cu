// K5: ordered rank, the first half of every range scan.
//
// Replaces repro/kernels/rank.py::_rank_kernel, which pinned the sorted
// order, the entry tables and the key pool whole in VMEM and ran
// core.walk.rank_sorted over a block of queries in vector lanes.  On Hopper
// the key pool of a real index is tens of MB, so the tables stay in device
// memory and are read through __ldg; the top levels of the search (the
// same few midpoints for every query) stay in L1 and L2.
//
// Bound: bytes, in the sense that a step does a handful of integer ops per
// byte read.  Each query is rank_iters dependent steps (a sorted-order
// read, an entry read, then up to W key bytes), so the kernel is bound by
// the latency of those chains; one thread walks one query and 256-thread
// blocks keep many chains in flight.  Warp-cooperative compares and
// caching the query row in registers are later work.
#include "lits_rank.cuh"

namespace {

__global__ void __launch_bounds__(lits::kBlock)
rank_kernel(const uint8_t* __restrict__ q, const int* __restrict__ qlens,
            const int* __restrict__ ent_sorted, long long n_sorted,
            const int* __restrict__ ent_off, const int* __restrict__ ent_len, long long n_ent,
            const uint8_t* __restrict__ key_bytes, long long n_key, int B, int W,
            int rank_iters, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = lits::rank_sorted(q + static_cast<long long>(b) * W, W, qlens[b], ent_sorted,
                             n_sorted, ent_off, ent_len, n_ent, key_bytes, n_key,
                             static_cast<int>(n_sorted), rank_iters);
}

}  // namespace

extern "C" int lits_rank(const uint8_t* q, const int* qlens, const int* ent_sorted,
                         long long n_sorted, const int* ent_off, const int* ent_len,
                         long long n_ent, const uint8_t* key_bytes, long long n_key, int B,
                         int W, int rank_iters, int* out, void* stream) {
  const int grid = (B + lits::kBlock - 1) / lits::kBlock;
  rank_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qlens, ent_sorted, n_sorted, ent_off, ent_len, n_ent, key_bytes, n_key, B, W,
      rank_iters, out);
  return static_cast<int>(cudaGetLastError());
}
