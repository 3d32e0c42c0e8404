// K4: the fused LITS point lookup (paper Alg. 2, whole walk).
//
// Replaces repro/kernels/traverse.py::_fused_kernel.  One thread walks one
// query from the root item to a terminal item and resolves it:
//   * model node: compare the node prefix, then GetCDF + lits::locate (K1's
//     arithmetic) from the end of the prefix, then read the slot item;
//   * critbit node: test one bit of one query byte;
//   * the walk stops at the first terminal item or after max_iters steps,
//     which gives the same item and level count as the reference's
//     batch-wide loop;
//   * ENTRY: exact string equality; CNODE: lits::probe (K3's probe) over the
//     node's h-pointers, string equality on a hash match, probing again from
//     idx + 1 after a false 16-bit match.
//
// The TPU kernel pinned every pool whole in VMEM.  The pools of a real index
// are tens of MB, more than a block's 227 KB of shared memory, so on Hopper
// they stay in device memory behind __ldg and the 50 MB L2.
//
// Bound: bytes, and in practice the latency of dependent reads: item ->
// node -> prefix and HPT steps -> slot item -> ..., a few bytes each.  What
// the design does about it (lits_words.cuh):
//   * the block's query rows are staged once in shared memory with
//     coalesced 16-byte loads; every query byte (prefix compare, GetCDF,
//     critbit byte, hash, equality) comes from there, never from a strided
//     global row;
//   * the prefix compare and the ENTRY/CNODE equality read the key as
//     16-byte chunks, all of a 96-byte key in one round trip for equality,
//     and compare four bytes at a time; equality stops at the key's length;
//   * GetCDF reads the (cdf, prob) pair of a step as one float2 of the
//     interleaved table, and since a step's table index depends only on
//     the query's bytes, the reads of 8 steps are in flight together before
//     the sum runs over them in step order.
// Measured with chip_smoke.py (H100 80GB HBM3, 700 W; 65,536 queries of
// the 1M-key url index, PERF.md): 0.1414 ms before this design, 0.0665 ms
// with it, most of the gain from the interleaved table.
#include "lits_words.cuh"

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
  const float2* cp_tab;  // (R, C) pairs (cdf_tab, prob_tab), interleaved
  long long R;
  long long C;
};

namespace {

constexpr int kPrefixChunks = 2;  // 32 key bytes per round trip: most prefixes differ early
constexpr int kEqChunks = 6;      // 96 key bytes per round trip: an equality reads the whole key

template <bool kWide>
__global__ void __launch_bounds__(lits::kBlock)
fused_search_kernel(const LitsPools p, const uint8_t* __restrict__ q,
                    const int* __restrict__ qlens, int B, int W, int S, int max_iters,
                    int cnode_cap, int cdf_steps, int* __restrict__ found,
                    int* __restrict__ eid, int* __restrict__ levels,
                    const uint32_t* padded) {
  const long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const uint32_t* stage = lits::block_stage<kWide>(q, padded, B, W, r0, blockDim.x, S);
  const long long b = r0 + threadIdx.x;
  if (b >= B) return;  // no barrier follows
  const uint32_t* row = stage + threadIdx.x * S;
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(row);
  const int qlen = __ldg(qlens + b);
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
      const int cmp = lits::cmp_row_prefix<kPrefixChunks>(row, W, p.key_bytes, p.n_key,
                                                          __ldg(p.mn_prefix_off + nid), pl);
      int pos;
      if (cmp < 0) {
        pos = 0;
      } else if (cmp > 0) {
        pos = m - 1;
      } else {
        const float cdf = lits::cdf_row(qb, W, qlen, pl, p.cp_tab, R, C, steps);
        pos = lits::locate(cdf, __ldg(p.mn_alpha + nid), __ldg(p.mn_beta + nid), m);
      }
      item = __ldg(p.items + lits::clamp_index(
                                 static_cast<long long>(__ldg(p.mn_slot_base + nid)) + pos,
                                 p.n_items));
    } else if (tag == lits::kTagTrie) {
      const long long tid = min(static_cast<long long>(pay), p.n_tr - 1);
      const int cb = __ldg(p.tr_byte + tid);
      const int qc = cb < min(qlen, W) ? qb[min(max(cb, 0), W - 1)] : 0;
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
    if (lits::eq_row_key<kEqChunks>(row, W, qlen, lits::row_extent(row, S), p.key_bytes,
                                    p.n_key, __ldg(p.ent_off + id), __ldg(p.ent_len + id))) {
      f = 1;
      e = static_cast<int>(id);
    }
  } else if (tag == lits::kTagCnode) {
    const long long cid = min(static_cast<long long>(pay), p.n_cn - 1);
    const long long base = __ldg(p.cn_base + cid);
    const int cnt = __ldg(p.cn_cnt + cid);
    const int qh = lits::hash16_row(row, W, qlen);
    const int qext = lits::row_extent(row, S);
    for (int j = lits::probe(p.ch_hash, base, p.n_ch, qh, cnt, 0, cnode_cap); j >= 0;
         j = lits::probe(p.ch_hash, base, p.n_ch, qh, cnt, j + 1, cnode_cap)) {
      const int cand = __ldg(p.ch_ent + lits::clamp_index(base + j, p.n_ch));
      const long long ce = lits::clamp_index(cand, p.n_ent);
      if (lits::eq_row_key<kEqChunks>(row, W, qlen, qext, p.key_bytes, p.n_key,
                                      __ldg(p.ent_off + ce), __ldg(p.ent_len + ce))) {
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

// Rows per block: kBlock, fewer for rows so wide that the stage would pass
// 48 KB (widths past 188 bytes).  A non-zero `wide_rows` reads that many
// rows per block in place from `padded` instead (rows too wide for shared
// memory; lits::block_stage).
extern "C" int lits_fused_search(const LitsPools* pools, const uint8_t* q, const int* qlens,
                                 int B, int W, int max_iters, int cnode_cap, int cdf_steps,
                                 int* found, int* eid, int* levels, const uint32_t* padded,
                                 int wide_rows, void* stream) {
  const lits::StageLaunch l = lits::stage_launch(fused_search_kernel<false>, B, W, 1, wide_rows);
  if (l.err != cudaSuccess) return static_cast<int>(l.err);
  auto* kernel = wide_rows > 0 ? fused_search_kernel<true> : fused_search_kernel<false>;
  kernel<<<l.grid, l.rows, l.bytes, static_cast<cudaStream_t>(stream)>>>(
      *pools, q, qlens, B, W, lits::stage_stride(W), max_iters, cnode_cap, cdf_steps, found,
      eid, levels, padded);
  return static_cast<int>(cudaGetLastError());
}
