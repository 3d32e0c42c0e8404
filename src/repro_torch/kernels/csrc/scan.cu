// K6: the delta-aware range scan (rank + two-way merge).
//
// Replaces repro/kernels/scan.py::_scan_kernel, which pinned the frozen
// order, the delta pools and both key pools whole in VMEM and ran
// core.walk.scan_merged (one batch-wide while_loop) over a block of
// queries.  That loop gates every lane on its own `active`, so a lane's
// window does not depend on the other lanes; here one thread runs one
// query's merge to its own end:
//   * rank into ent_sorted over all its rows (lits::rank_sorted, K5's
//     search), as the reference does, whatever n_base is;
//   * no delta entries (n_delta == 0): the window is the contiguous slice
//     ent_sorted[bi : bi + window] cut at n_base;
//   * otherwise rank into ds_order[:n_delta] and merge:
//       take_delta = d_ok && (!b_ok || cmp <= 0), cmp = strcmp(delta, base);
//       shadows    = take_delta && b_ok && cmp == 0;
//       emit         take_delta ? !tomb : b_ok;
//       advance bi on !take_delta || shadows, di on take_delta.
// n_base (0 for an EMPTY root) and n_delta are read from device scalars,
// so a launch needs no host sync.
//
// Bound: bytes.  Each query does two binary searches and up to window (+
// skipped tombstones) merge steps, each a chain of dependent reads of a few
// bytes with a W-byte compare; the pools stay in device memory behind
// __ldg and L2, and many 256-thread blocks keep those chains in flight.
#include "lits_rank.cuh"

struct ScanPools {
  const int* ent_sorted;
  long long n_sorted;
  const int* ent_off;
  const int* ent_len;
  long long n_ent;
  const uint8_t* key_bytes;
  long long n_key;
  const int* n_base;
  const int* ds_order;
  long long n_ds;
  const int* de_off;
  const int* de_len;
  const bool* de_tomb;
  long long n_de;
  const uint8_t* db_bytes;
  long long n_db;
  const int* n_delta;
};

namespace {

__global__ void __launch_bounds__(lits::kBlock)
scan_kernel(const ScanPools p, const uint8_t* __restrict__ q, const int* __restrict__ qlens,
            int B, int W, int window, int rank_iters, int delta_iters,
            int* __restrict__ eids, bool* __restrict__ valid, bool* __restrict__ is_delta) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* qr = q + static_cast<long long>(b) * W;
  const int qlen = qlens[b];
  const int n_base = __ldg(p.n_base);
  const int n_delta = __ldg(p.n_delta);
  int* oe = eids + static_cast<long long>(b) * window;
  bool* ov = valid + static_cast<long long>(b) * window;
  bool* od = is_delta + static_cast<long long>(b) * window;
  int bi = lits::rank_sorted(qr, W, qlen, p.ent_sorted, p.n_sorted, p.ent_off, p.ent_len,
                             p.n_ent, p.key_bytes, p.n_key, static_cast<int>(p.n_sorted),
                             rank_iters);
  if (n_delta <= 0) {
    for (int c = 0; c < window; ++c) {
      const int idx = bi + c;
      const bool ok = idx < n_base;
      oe[c] = ok ? __ldg(p.ent_sorted + min(static_cast<long long>(idx), p.n_sorted - 1)) : -1;
      ov[c] = ok;
      od[c] = false;
    }
    return;
  }
  int di = lits::rank_sorted(qr, W, qlen, p.ds_order, p.n_ds, p.de_off, p.de_len, p.n_de,
                             p.db_bytes, p.n_db, n_delta, delta_iters);
  int k = 0;
  while (k < window && (bi < n_base || di < n_delta)) {
    const bool b_ok = bi < n_base;
    const bool d_ok = di < n_delta;
    const int be = __ldg(p.ent_sorted + min(static_cast<long long>(bi), p.n_sorted - 1));
    const int de = __ldg(p.ds_order + min(static_cast<long long>(di), p.n_ds - 1));
    const long long bei = lits::clamp_index(be, p.n_ent);
    const long long dei = lits::clamp_index(de, p.n_de);
    int cmp = 0;
    if (b_ok && d_ok) {
      cmp = lits::str_cmp_pools(p.db_bytes, p.n_db, __ldg(p.de_off + dei), __ldg(p.de_len + dei),
                                p.key_bytes, p.n_key, __ldg(p.ent_off + bei),
                                __ldg(p.ent_len + bei), W);
    }
    const bool take_delta = d_ok && (!b_ok || cmp <= 0);
    const bool shadows = take_delta && b_ok && cmp == 0;
    const bool emit = take_delta ? !p.de_tomb[dei] : b_ok;
    if (emit) {
      oe[k] = take_delta ? de : be;
      ov[k] = true;
      od[k] = take_delta;
      ++k;
    }
    if (!take_delta || shadows) ++bi;
    if (take_delta) ++di;
  }
  for (; k < window; ++k) {
    oe[k] = -1;
    ov[k] = false;
    od[k] = false;
  }
}

}  // namespace

extern "C" int lits_scan(const ScanPools* pools, const uint8_t* q, const int* qlens, int B,
                         int W, int window, int rank_iters, int delta_iters, int* eids,
                         bool* valid, bool* is_delta, void* stream) {
  const int grid = (B + lits::kBlock - 1) / lits::kBlock;
  scan_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *pools, q, qlens, B, W, window, rank_iters, delta_iters, eids, valid, is_delta);
  return static_cast<int>(cudaGetLastError());
}
