// K3: compact-leaf h-pointer probe (paper Sec. 3.3, Alg. 2 l.21-27).
//
// Replaces repro/kernels/cnode_probe.py::_probe_kernel, which compared a
// (block, K) tile of 16-bit hash codes in vector lanes.  Here one thread
// scans its query's row of K codes in slot order and stops at the first
// match in [frm, cnt), so a false 16-bit match is resolved by probing again
// from idx + 1.  K4's compact-node resolve calls the same lits::probe.
//
// Bound: bytes (K + 3 int32 in, one out per query, one compare per code).
#include "lits_walk.cuh"

namespace {

__global__ void __launch_bounds__(lits::kBlock)
cnode_probe_kernel(const int* __restrict__ hashes, const int* __restrict__ qhash,
                   const int* __restrict__ cnt, const int* __restrict__ frm, int B, int K,
                   int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  out[b] = lits::probe(hashes + static_cast<long long>(b) * K, 0, K, qhash[b], cnt[b], frm[b], K);
}

}  // namespace

extern "C" int lits_cnode_probe(const int* hashes, const int* qhash, const int* cnt,
                                const int* frm, int B, int K, int* out, void* stream) {
  const int grid = (B + lits::kBlock - 1) / lits::kBlock;
  cnode_probe_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      hashes, qhash, cnt, frm, B, K, out);
  return static_cast<int>(cudaGetLastError());
}
