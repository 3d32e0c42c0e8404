// K6: the delta-aware range scan (rank + two-way merge).
//
// Replaces repro/kernels/scan.py::_scan_kernel, which pinned the frozen
// order, the delta pools and both key pools whole in VMEM and ran
// core.walk.scan_merged (one batch-wide while_loop) over a block of
// queries.  That loop gates every lane on its own `active`, so a query's
// window does not depend on the others; here a group of G lanes runs one
// query's scan to its own end:
//   * rank into ent_sorted over all its rows, as the reference does,
//     whatever n_base is;
//   * no delta entries (n_delta == 0): the window is the contiguous slice
//     ent_sorted[bi : bi + window] cut at n_base;
//   * otherwise rank into ds_order[:n_delta] and merge, step for step as
//     scan_merged:
//       take_delta = d_ok && (!b_ok || cmp <= 0), cmp = strcmp(delta, base);
//       shadows    = take_delta && b_ok && cmp == 0;
//       emit         take_delta ? !tomb : b_ok;
//       advance bi on !take_delta || shadows, di on take_delta;
//     the loop stops when k == window or both streams are used up, so a
//     run of tombstones can stretch a window past `window` steps.
// n_base (0 for an EMPTY root) and n_delta are read from device scalars,
// so a launch needs no host sync.
//
// Bound: bytes, and in practice the latency and the L1/L2 traffic of
// dependent reads: a search step reads an order word, an (off, len) record
// and then the key up to the byte that decides its compare.  What the
// design does about it (lits_words.cuh):
//   * the block's query rows are staged once in shared memory with
//     coalesced 16-byte loads;
//   * each rank of a sorted order reads one 16-byte record (entry id, key
//     offset, key length, tombstone flag) made once per order by the
//     wrapper, instead of an order word and then two table entries;
//   * compares read keys as 16-byte chunks, one per round trip, and
//     compare four bytes at a time;
//   * each rank step compares G pivots at once, one per lane, and a ballot
//     narrows [lo, hi) to one of G + 1 parts: ceil(log_(G+1) n) dependent
//     steps, 9 over 1M entries at G = 4, instead of 20 halvings;
//   * a merge step compares the delta head with the next G base heads at
//     once, one per lane: the base heads it precedes are emitted together,
//     by their lanes, so a window of base keys costs window / G steps;
//     the heads' records are held in the lanes and passed on by shuffles as
//     the streams advance;
//   * the lanes write a window's slots side by side.
// G = 4 was faster than G = 8 on an H100 at 65,536 queries: the eight
// compares of a G = 8 step cost more L1/L2 traffic than its two fewer
// steps save.  Measured with chip_smoke.py (H100 80GB HBM3, 700 W; 65,536
// queries of the 1M-key url index, PERF.md): 0.1982 ms (empty delta) and
// 0.4567 ms (live delta) before this design, 0.0905 and 0.1719 ms with it.
// Every lane of a group takes part in its shuffles and ballots, so rows
// past B take part with empty streams and write nothing.
#include "lits_words.cuh"

// The two sorted orders, each with one int4 record per rank (entry id,
// key offset, key length, tombstone flag), made by the wrapper from the
// order and its entry tables (kernels/rank.py, order_records).
struct ScanPools {
  const int* ent_sorted;
  long long n_sorted;
  const int4* base_rec;  // n_sorted records of ent_sorted (flag 0)
  const uint8_t* key_bytes;
  long long n_key;
  const int* n_base;
  const int4* delta_rec;  // n_ds records of ds_order
  long long n_ds;
  const uint8_t* db_bytes;
  long long n_db;
  const int* n_delta;
};

namespace {

constexpr int G = 4;    // lanes per query
constexpr int kC = 1;   // 16-byte chunks a compare reads per round trip
constexpr unsigned kGroupBits = (1u << G) - 1u;

__global__ void __launch_bounds__(lits::kBlock)
scan_kernel(const ScanPools p, const uint8_t* __restrict__ q, const int* __restrict__ qlens,
            int B, int W, int S, int window, int* __restrict__ eids, bool* __restrict__ valid,
            bool* __restrict__ is_delta) {
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
  const int nd_all = __ldg(p.n_delta);
  const int n_base = row_ok ? __ldg(p.n_base) : 0;
  const int n_delta = row_ok ? nd_all : 0;
  int* oe = eids + (row_ok ? b : 0) * window;
  bool* ov = valid + (row_ok ? b : 0) * window;
  bool* od = is_delta + (row_ok ? b : 0) * window;
  int bi = lits::group_rank<G, kC>(row, W, qlen, qext, p.base_rec, p.n_sorted, p.key_bytes,
                                   p.n_key, row_ok ? static_cast<int>(p.n_sorted) : 0, lane,
                                   gmask, gshift);
  if (nd_all <= 0) {
    if (row_ok) {
      for (int c = lane; c < window; c += G) {
        const int idx = bi + c;
        const bool ok = idx < n_base;
        oe[c] = ok ? __ldg(p.ent_sorted + min(static_cast<long long>(idx), p.n_sorted - 1)) : -1;
        ov[c] = ok;
        od[c] = false;
      }
    }
    return;
  }
  int di = lits::group_rank<G, kC>(row, W, qlen, qext, p.delta_rec, p.n_ds, p.db_bytes, p.n_db,
                                   n_delta, lane, gmask, gshift);
  // lane j holds the base head bfirst + j and the delta head dfirst + j
  int bfirst = -1, dfirst = -1;
  int be = 0, boff = 0, blen = 0;
  int de = 0, doff = 0, dlen = 0, dtomb = 0;
  int k = 0;
  while (k < window && (bi < n_base || di < n_delta)) {  // the same in every lane of the group
    if (di >= n_delta) {  // only base entries left: a contiguous run
      const int cnt = min(window - k, n_base - bi);
      if (row_ok) {
        for (int c = lane; c < cnt; c += G) {
          oe[k + c] = __ldg(p.ent_sorted + min(static_cast<long long>(bi + c), p.n_sorted - 1));
          ov[k + c] = true;
          od[k + c] = false;
        }
      }
      k += cnt;
      break;
    }
    if (dfirst < 0 || di - dfirst >= G) {
      dfirst = di;
      if (di + lane < n_delta) {
        const int4 r = __ldg(p.delta_rec + min(static_cast<long long>(di + lane), p.n_ds - 1));
        de = r.x;
        doff = r.y;
        dlen = r.z;
        dtomb = r.w;
      }
    }
    const int src = di - dfirst;
    const int d_e = __shfl_sync(gmask, de, src, G);
    const int d_off = __shfl_sync(gmask, doff, src, G);
    const int d_len = __shfl_sync(gmask, dlen, src, G);
    const int d_tomb = __shfl_sync(gmask, dtomb, src, G);
    bool b_ok = bi < n_base;
    int cmp_at_stop = -1;
    if (b_ok) {
      if (bfirst != bi) {  // move the base heads up: shuffle those still ahead, load the rest
        const int from = lane + (bi - bfirst);
        const bool keep = bfirst >= 0 && from < G;
        const int src_lane = keep ? from : lane;
        const int e2 = __shfl_sync(gmask, be, src_lane, G);
        const int o2 = __shfl_sync(gmask, boff, src_lane, G);
        const int l2 = __shfl_sync(gmask, blen, src_lane, G);
        be = e2;
        boff = o2;
        blen = l2;
        if (!keep && bi + lane < n_base) {
          const int4 r = __ldg(p.base_rec + min(static_cast<long long>(bi + lane), p.n_sorted - 1));
          be = r.x;
          boff = r.y;
          blen = r.z;
        }
        bfirst = bi;
      }
      // cmp(delta head, base head bi + lane); a base stream used up stops the run
      int c = -1;
      if (bi + lane < n_base) {
        c = lits::cmp_pool_keys<kC>(p.db_bytes, p.n_db, d_off, d_len, p.key_bytes, p.n_key, boff,
                                    blen, W);
      }
      const unsigned stop = __ballot_sync(gmask, c <= 0) >> gshift & kGroupBits;
      const int m = stop ? __ffs(stop) - 1 : G;  // base heads that precede the delta head
      const int cnt = min(m, window - k);
      if (row_ok && lane < cnt) {
        oe[k + lane] = be;
        ov[k + lane] = true;
        od[k + lane] = false;
      }
      k += cnt;
      bi += cnt;
      if (m == G || k >= window) continue;
      cmp_at_stop = __shfl_sync(gmask, c, m, G);
      b_ok = bi < n_base;
    }
    // the delta head goes next: emitted if live, and an equal key shadows the base head
    if (!d_tomb) {
      if (row_ok && lane == 0) {
        oe[k] = d_e;
        ov[k] = true;
        od[k] = true;
      }
      ++k;
    }
    if (b_ok && cmp_at_stop == 0) ++bi;
    ++di;
  }
  if (row_ok) {
    for (int c = k + lane; c < window; c += G) {
      oe[c] = -1;
      ov[c] = false;
      od[c] = false;
    }
  }
}

}  // namespace

// A block holds kBlock / G rows, fewer for rows so wide that the stage
// would pass 48 KB (widths past 764 bytes).
extern "C" int lits_scan(const ScanPools* pools, const uint8_t* q, const int* qlens, int B,
                         int W, int window, int* eids, bool* valid, bool* is_delta,
                         void* stream) {
  const int S = lits::stage_stride(W);
  const int rows = lits::stage_rows_per_block(W, G);
  const size_t bytes = static_cast<size_t>(rows) * S * 4;
  const cudaError_t e = lits::allow_stage(scan_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (B + rows - 1) / rows;
  scan_kernel<<<grid, rows * G, bytes, static_cast<cudaStream_t>(stream)>>>(
      *pools, q, qlens, B, W, S, window, eids, valid, is_delta);
  return static_cast<int>(cudaGetLastError());
}
