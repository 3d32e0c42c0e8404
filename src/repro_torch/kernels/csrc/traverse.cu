// K4: the fused LITS point lookup (paper Alg. 2, whole walk).
//
// Replaces repro/kernels/traverse.py::_fused_kernel.  One thread walks one
// query from the root item to a terminal item and resolves it:
//   * model node: compare the node prefix, then lits::hpt_cdf + lits::locate
//     (K1's arithmetic) from the end of the prefix, then read the slot item;
//   * critbit node: test one bit of one query byte;
//   * the walk stops at the first terminal item or after max_iters steps,
//     which gives the same item and level count as the reference's
//     batch-wide loop;
//   * ENTRY: exact string equality; CNODE: lits::probe (K3's probe) over the
//     node's h-pointers, str_eq on a hash match, probing again from idx + 1
//     after a false 16-bit match.
//
// The TPU kernel pinned every pool whole in VMEM through (1, N) blocks.  The
// pools of a real index are tens of MB and the HPT pair alone is 1 MB, more
// than a block's 227 KB of shared memory, so on Hopper the pools stay in
// device memory and are read through __ldg; the upper levels and the hot
// HPT rows stay in the 50 MB L2.
//
// Bound: bytes.  A lookup is a chain of dependent reads (item -> node ->
// slot -> ...), each of a few bytes, with little arithmetic between them;
// the design hides their latency with many threads in flight (256-thread
// blocks, one query each) rather than with wide loads.
#include "lits_walk.cuh"

struct LitsPools {
  const int* root_item;
  const int* items;
  long long n_items;
  const int* mn_slot_base;
  const int* mn_slot_cnt;
  const int* mn_prefix_off;
  const int* mn_prefix_len;
  const float* mn_alpha;
  const float* mn_beta;
  long long n_mn;
  const int* tr_byte;
  const int* tr_mask;
  const int* tr_left;
  const int* tr_right;
  long long n_tr;
  const int* cn_base;
  const int* cn_cnt;
  long long n_cn;
  const int* ch_hash;
  const int* ch_ent;
  long long n_ch;
  const uint8_t* key_bytes;
  long long n_key;
  const int* ent_off;
  const int* ent_len;
  long long n_ent;
  const float* cdf_tab;
  const float* prob_tab;
  long long R;
  long long C;
};

namespace {

__global__ void __launch_bounds__(lits::kBlock)
fused_search_kernel(const LitsPools p, const uint8_t* __restrict__ q,
                    const int* __restrict__ qlens, int B, int W, int max_iters,
                    int cnode_cap, int cdf_steps, int* __restrict__ found,
                    int* __restrict__ eid, int* __restrict__ levels) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* qr = q + static_cast<long long>(b) * W;
  const int qlen = qlens[b];
  const int steps = min(cdf_steps, W);
  const int R = static_cast<int>(p.R);
  const int C = static_cast<int>(p.C);
  int item = __ldg(p.root_item);
  int lv = 0;
  for (int it = 0; it < max_iters; ++it) {
    const int tag = lits::item_tag(item);
    const int pay = item & lits::kPayloadMask;
    if (tag == lits::kTagMnode) {
      const long long nid = min(static_cast<long long>(pay), p.n_mn - 1);
      const int pl = __ldg(p.mn_prefix_len + nid);
      const int m = __ldg(p.mn_slot_cnt + nid);
      const int cmp = lits::str_cmp_prefix(qr, W, p.key_bytes, p.n_key,
                                           __ldg(p.mn_prefix_off + nid), pl);
      int pos;
      if (cmp < 0) {
        pos = 0;
      } else if (cmp > 0) {
        pos = m - 1;
      } else {
        const float cdf = lits::hpt_cdf(qr, W, qlen, pl, p.cdf_tab, p.prob_tab, R, C, steps);
        pos = lits::locate(cdf, __ldg(p.mn_alpha + nid), __ldg(p.mn_beta + nid), m);
      }
      item = __ldg(p.items + lits::clamp_index(
                                 static_cast<long long>(__ldg(p.mn_slot_base + nid)) + pos,
                                 p.n_items));
    } else if (tag == lits::kTagTrie) {
      const long long tid = min(static_cast<long long>(pay), p.n_tr - 1);
      const int cb = __ldg(p.tr_byte + tid);
      const int qc = cb < min(qlen, W) ? __ldg(qr + min(max(cb, 0), W - 1)) : 0;
      item = (qc & __ldg(p.tr_mask + tid)) ? __ldg(p.tr_right + tid) : __ldg(p.tr_left + tid);
    } else {
      break;
    }
    ++lv;
  }
  const int tag = lits::item_tag(item);
  const int pay = item & lits::kPayloadMask;
  int f = 0;
  int e = -1;
  if (tag == lits::kTagEntry) {
    const long long id = min(static_cast<long long>(pay), p.n_ent - 1);
    if (lits::str_eq(qr, W, qlen, p.key_bytes, p.n_key, __ldg(p.ent_off + id),
                     __ldg(p.ent_len + id))) {
      f = 1;
      e = static_cast<int>(id);
    }
  } else if (tag == lits::kTagCnode) {
    const long long cid = min(static_cast<long long>(pay), p.n_cn - 1);
    const long long base = __ldg(p.cn_base + cid);
    const int cnt = __ldg(p.cn_cnt + cid);
    const int qh = lits::hash16(qr, W, qlen);
    for (int j = lits::probe(p.ch_hash, base, p.n_ch, qh, cnt, 0, cnode_cap); j >= 0;
         j = lits::probe(p.ch_hash, base, p.n_ch, qh, cnt, j + 1, cnode_cap)) {
      const int cand = __ldg(p.ch_ent + lits::clamp_index(base + j, p.n_ch));
      const long long ce = lits::clamp_index(cand, p.n_ent);
      if (lits::str_eq(qr, W, qlen, p.key_bytes, p.n_key, __ldg(p.ent_off + ce),
                       __ldg(p.ent_len + ce))) {
        f = 1;
        e = cand;
        break;
      }
    }
  }
  found[b] = f;
  eid[b] = e;
  levels[b] = lv;
}

}  // namespace

extern "C" int lits_fused_search(const LitsPools* pools, const uint8_t* q, const int* qlens,
                                 int B, int W, int max_iters, int cnode_cap, int cdf_steps,
                                 int* found, int* eid, int* levels, void* stream) {
  const int grid = (B + lits::kBlock - 1) / lits::kBlock;
  fused_search_kernel<<<grid, lits::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *pools, q, qlens, B, W, max_iters, cnode_cap, cdf_steps, found, eid, levels);
  return static_cast<int>(cudaGetLastError());
}
