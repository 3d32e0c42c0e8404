// K5: ordered rank, the first rank r with key(ent_sorted[r]) >= query.
//
// Replaces repro/kernels/rank.py::_rank_kernel, which pinned the sorted
// order, the entry tables and the key pool whole in VMEM and ran
// core.walk.rank_sorted (a halving search of rank_iters steps, each a full
// strcmp) over a block of queries in vector lanes.  On Hopper the key pool
// of a real index is tens of MB, so the tables stay in device memory.
//
// Bound: bytes, and in practice the latency and the L1/L2 traffic of
// dependent reads: a search step reads a pivot's order entry, its key's
// (off, len) and then the key up to the byte that decides the compare.
// This is the rank half of K6 (scan.cu), on lits_words.cuh:
//   * the block's query rows are staged once in shared memory with
//     coalesced 16-byte loads;
//   * each rank of ent_sorted is one 16-byte record (entry id, key offset,
//     key length, 0), made once per order by the wrapper and shared with
//     K6 (kernels/rank.py, order_records);
//   * compares read keys as 16-byte chunks and compare four bytes at a
//     time;
//   * a group of G lanes searches each query, G pivots a step, one per
//     lane, and a ballot narrows [lo, hi) to one of G + 1 parts:
//     ceil(log_(G+1) n) dependent steps instead of rank_iters halvings.
//     The search runs over all n_sorted ranks, as the reference's
//     rank_batch does; it returns the lower bound, as a halving search of
//     at least ceil(log2(n + 1)) steps does, and the wrapper refuses fewer.
// G = 4: a pure rank has no merge to pay for, but G = 8 was still slower
// on an H100 at 65,536 queries of the 1M-key url index (PERF.md).  One lane
// of a group writes the rank.  Every lane takes part in its group's
// shuffles and ballots, so rows past B search an empty order and write
// nothing.  A block holds kBlock / G rows, fewer for rows so wide that the
// stage would pass 48 KB (widths past 764 bytes).
#include "lits_words.cuh"

namespace {

constexpr int G = 4;   // lanes per query
constexpr int kC = 1;  // 16-byte chunks a compare reads per round trip, as K6
constexpr unsigned kGroupBits = (1u << G) - 1u;

__global__ void __launch_bounds__(lits::kBlock)
rank_kernel(const int4* __restrict__ rec, long long n_rec, const uint8_t* __restrict__ pool,
            long long npool, const uint8_t* __restrict__ q, const int* __restrict__ qlens,
            int B, int W, int S, int* __restrict__ out) {
  const int rows = blockDim.x / G;  // queries per block
  extern __shared__ uint32_t stage[];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  lits::stage_rows(q, B, W, r0, rows, stage, S);
  const int g = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const int gshift = (threadIdx.x % 32) / G * G;
  const unsigned gmask = kGroupBits << gshift;
  const long long b = r0 + g;
  const bool row_ok = b < B;
  const uint32_t* row = stage + g * S;
  const int qlen = row_ok ? __ldg(qlens + b) : 0;
  const int qext = lits::row_extent(row, S);
  const int r = lits::group_rank<G, kC>(row, W, qlen, qext, rec, n_rec, pool, npool,
                                        row_ok ? static_cast<int>(n_rec) : 0, lane, gmask,
                                        gshift);
  if (row_ok && lane == 0) out[b] = r;
}

}  // namespace

extern "C" int lits_rank(const int4* rec, long long n_rec, const uint8_t* pool, long long npool,
                         const uint8_t* q, const int* qlens, int B, int W, int* out,
                         void* stream) {
  const int S = lits::stage_stride(W);
  const int rows = lits::stage_rows_per_block(W, G);
  const size_t bytes = static_cast<size_t>(rows) * S * 4;
  const cudaError_t e = lits::allow_stage(rank_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (B + rows - 1) / rows;
  rank_kernel<<<grid, rows * G, bytes, static_cast<cudaStream_t>(stream)>>>(
      rec, n_rec, pool, npool, q, qlens, B, W, S, out);
  return static_cast<int>(cudaGetLastError());
}
