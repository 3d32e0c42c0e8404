// K3: compact-leaf h-pointer probe (paper Sec. 3.3, Alg. 2 l.21-27).
//
// Replaces repro/kernels/cnode_probe.py::_probe_kernel, which compared a
// (block, K) tile of 16-bit hash codes in vector lanes.  For each row b of
// a (B, K) int32 tile, the first slot j with max(frm, 0) <= j < min(cnt, K)
// and hashes[b, j] == qhash[b], else -1.  K4 resolves its compact nodes with
// the one-thread form of the same probe, lits::probe_first.
//
// Bound: bytes (K + 3 int32 in, one out per row, one compare per code).
// One thread a row read its codes one by one, each 4K bytes from its
// neighbours': a warp-wide load touched 32 rows' sectors where a coalesced
// one needs 4, sixteen of them back to back.  Here a group of G lanes takes
// a row:
//   * in a pass, each lane makes one 16-byte load of 4 codes, so with
//     K = 16 a warp reads 8 whole rows, 512 contiguous bytes, in one
//     instruction; the first pass's load does not wait for the row's cnt
//     and frm, so the row costs one round trip;
//   * each lane compares its 4 codes, the group's lanes meet in one
//     __ballot_sync over the group, and the lowest lane with a match
//     writes its lowest matching slot (__ffs), else the group's first
//     lane writes -1;
//   * a row of more than 4G codes takes passes of 4G slots and stops at the
//     first pass with a match;
//   * codes that are not 16-byte aligned (K not a multiple of 4, or a tile
//     that does not start on a 16-byte boundary) take four scalar loads a
//     lane, all issued before the compares.
// Rows past B are whole groups (a block holds whole groups) and return
// before any ballot.
//
// G = 4 and one row a group were the fastest on an H100 at a (65,536, 16)
// tile: G = 1, 2 and 8 were slower, and so were 2, 4 and 8 rows a group
// with their loads in flight together (PERF.md).
#include <cstdint>

#include "lits_walk.cuh"

namespace {

constexpr int G = 4;                    // lanes per row
constexpr int kLaneCodes = 4;           // codes a lane compares in a pass: one 16-byte load
constexpr int kPass = G * kLaneCodes;   // slots a group compares in a pass

__global__ void __launch_bounds__(lits::kBlock)
cnode_probe_kernel(const int* __restrict__ hashes, const int* __restrict__ qhash,
                   const int* __restrict__ cnt, const int* __restrict__ frm, int B, int K,
                   bool aligned, int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long b = t / G;
  if (b >= B) return;
  const int lane = static_cast<int>(t % G);
  const int wl = static_cast<int>(threadIdx.x % 32);
  const unsigned group = ((1u << G) - 1u) << (wl - lane);
  const int* row = hashes + b * K;
  const int qh = __ldg(qhash + b);
  const int lo = max(__ldg(frm + b), 0);
  const int end = min(__ldg(cnt + b), K);
  int slot = -1;
  bool writer = lane == 0;
  for (int p0 = 0; p0 < K; p0 += kPass) {
    const int s0 = p0 + lane * kLaneCodes;
    int h[kLaneCodes] = {0, 0, 0, 0};
    if (aligned) {  // K % 4 == 0: s0 < K leaves the whole load inside the row
      if (s0 < K) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(row + s0));
        h[0] = v.x;
        h[1] = v.y;
        h[2] = v.z;
        h[3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kLaneCodes; ++i) {
        if (s0 + i < K) h[i] = __ldg(row + s0 + i);
      }
    }
    if (p0 >= end) break;  // uniform in the group
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < kLaneCodes; ++i) {
      if (s0 + i >= lo && s0 + i < end && h[i] == qh) m |= 1u << i;
    }
    const unsigned hit = __ballot_sync(group, m != 0) & group;
    if (hit) {
      writer = wl == __ffs(static_cast<int>(hit)) - 1;
      slot = s0 + __ffs(static_cast<int>(m)) - 1;
      break;
    }
  }
  if (writer) out[b] = slot;
}

}  // namespace

extern "C" int lits_cnode_probe(const int* hashes, const int* qhash, const int* cnt,
                                const int* frm, int B, int K, int* out, void* stream) {
  const long long threads = static_cast<long long>(B) * G;
  const int grid = static_cast<int>((threads + lits::kBlock - 1) / lits::kBlock);
  const bool aligned = K % kLaneCodes == 0 && reinterpret_cast<uintptr_t>(hashes) % 16 == 0;
  cnode_probe_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      hashes, qhash, cnt, frm, B, K, aligned, out);
  return static_cast<int>(cudaGetLastError());
}
