// Staged query rows and word-wide string compares, for the fused lookup
// (K4, traverse.cu), the rank (K5, rank.cu) and the range scan (K6,
// scan.cu).  Every function gives the result of the reference's byte loop
// (repro/kernels/strops.py, repro/core/walk.py) bit for bit.
//
// Staged rows.  A block's query rows are contiguous in the (B, W) matrix.
// The block copies them once into shared memory with coalesced 16-byte
// loads, one row to stage_stride(W) 32-bit words: an odd count, so that the
// lanes of a warp reading word j of 32 different rows hit 32 different
// banks.  Bytes past W, and rows past B, are zero.  No query byte is read
// from device memory after that.  The copy goes through registers, not
// cp.async or TMA: those move aligned 4-, 8- or 16-byte units, and a row of
// W = 94 bytes lands on a 100-byte stride, so its bytes shift against every
// alignment.  A stage of 256 rows of W = 94 is 25,600 bytes, so eight
// blocks fit in an SM's shared memory; registers allow four.  A row too
// wide for a block's shared memory (W past 232,000 bytes on an H100) is not
// copied by the kernel: the wrapper lays all rows out at once in device
// memory with the same stride and zero padding (kernels/_build.py,
// wide_rows), and the kernel reads its rows there in place (block_stage).
//
// Word compares.  A key's bytes [off, off + n) are read as the aligned
// 16-byte chunks of its pool that cover them, funnel-shifted into words
// that start at the key's first byte, and masked to 0 past n.  The order of
// two little-endian words is the unsigned order of their byte-swapped
// values: that is the order of their first differing bytes, taken as
// unsigned, so bytes >= 0x80 and zero bytes order as in the byte loop.
// Equal windows resolve on the sign of the length difference.
//
// The reference clips every pool index.  The word path reads only where no
// byte index would have been clipped: a key whose covering chunks leave the
// pool (its end near the pool's end, a pool whose start is not 16-byte
// aligned) is compared byte by byte with clamped indices instead.
#pragma once

#include "lits_rank.cuh"

namespace lits {

// 32-bit words per staged row: the least odd count that holds W bytes.
__host__ __device__ constexpr int stage_stride(int W) { return ((W + 3) / 4) | 1; }

// Shared memory a launch gets without opting in to more.
constexpr size_t kStageDefault = 48 * 1024;

// Query rows per block of a kernel that stages its rows with `lanes` threads
// per row: kBlock / lanes, halved while the stage would pass kStageDefault,
// down to one row (so a block holds whole groups of lanes).
__host__ inline int stage_rows_per_block(int W, int lanes) {
  const size_t row = static_cast<size_t>(stage_stride(W)) * 4;
  int rows = kBlock / lanes;
  while (rows > 1 && rows * row > kStageDefault) rows /= 2;
  return rows;
}

#ifdef __CUDACC__
// Let `kernel` take a stage of `bytes`: one row wider than kStageDefault (W
// past 49,000 bytes) opts in to more, up to the device's limit (227 KB on
// an H100).
template <class Kernel>
cudaError_t allow_stage(Kernel* kernel, size_t bytes) {
  if (bytes <= kStageDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The launch of a kernel with `lanes` threads per query row: its blocks,
// rows per block and dynamic shared memory.  A non-zero `wide_rows` (rows
// too wide to stage, read in place from the wrapper's padded matrix) takes
// that many rows a block and no shared memory; otherwise a block stages
// stage_rows_per_block rows, and `narrow`, the kernel that stages them,
// opts in to a stage past kStageDefault.
struct StageLaunch {
  int grid, rows;
  size_t bytes;
  cudaError_t err;
};

template <class Kernel>
StageLaunch stage_launch(Kernel* narrow, int B, int W, int lanes, int wide_rows) {
  if (wide_rows > 0) return {(B + wide_rows - 1) / wide_rows, wide_rows, 0, cudaSuccess};
  const int rows = stage_rows_per_block(W, lanes);
  const size_t bytes = static_cast<size_t>(rows) * stage_stride(W) * 4;
  return {(B + rows - 1) / rows, rows, bytes, allow_stage(narrow, bytes)};
}
#endif

// Copy rows [r0, r0 + rows) of the (B, W) byte matrix q into `stage`
// (rows * S words), zero past W and past row B.  Every thread of the block
// calls it; it ends with a barrier.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ q, long long B, int W,
                                           long long r0, int rows, uint32_t* stage, int S) {
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x) stage[i] = 0u;
  __syncthreads();
  const long long r1 = min(r0 + rows, B);
  if (r1 > r0) {
    const long long total = (r1 - r0) * W;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(q) + static_cast<uintptr_t>(r0 * W);
    const uintptr_t a1 = a0 + static_cast<uintptr_t>(total);
    const uintptr_t c0 = a0 & ~static_cast<uintptr_t>(15);
    const long long nchunks = static_cast<long long>((a1 - c0 + 15) >> 4);
    uint8_t* sb = reinterpret_cast<uint8_t*>(stage);
    for (long long i = threadIdx.x; i < nchunks; i += blockDim.x) {
      const uintptr_t c = c0 + 16 * static_cast<uintptr_t>(i);
      uint32_t w[4];
      if (c >= a0 && c + 16 <= a1) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(c));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {  // the ragged head or tail: only the bytes inside [a0, a1)
#pragma unroll
        for (int t = 0; t < 4; ++t) w[t] = 0u;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (c + k >= a0 && c + k < a1) {
            w[k >> 2] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const uint8_t*>(c + k)))
                         << (8 * (k & 3));
          }
        }
      }
      const long long rel0 = static_cast<long long>(c - c0) - static_cast<long long>(a0 - c0);
      const long long first = rel0 < 0 ? 0 : rel0;
      int row = static_cast<int>(first / W);
      int col = static_cast<int>(first - static_cast<long long>(row) * W);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long long rel = rel0 + k;
        if (rel >= 0 && rel < total) {
          sb[4 * row * S + col] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
          if (++col == W) {
            col = 0;
            ++row;
          }
        }
      }
    }
  }
  __syncthreads();
}

#ifdef __CUDACC__
// The staged rows [r0, r0 + rows) of a block: copied into shared memory by
// stage_rows, or, for rows too wide for it, the block's part of the
// wrapper's (blocks * rows, S) matrix `padded`, which holds them in the
// staged layout already (kernels/_build.py, wide_rows) and is read in
// place.  The word functions read a row through a generic pointer, so the
// rest of a kernel does not change.
template <bool kWide>
__device__ __forceinline__ const uint32_t* block_stage(const uint8_t* __restrict__ q,
                                                       const uint32_t* padded, long long B,
                                                       int W, long long r0, int rows, int S) {
  if constexpr (kWide) {
    return padded + r0 * S;
  } else {
    extern __shared__ uint32_t lits_stage[];
    stage_rows(q, B, W, r0, rows, lits_stage, S);
    return lits_stage;
  }
}
#endif

// 1 + the index of the last nonzero byte of a staged row (0 if none).
__device__ __forceinline__ int row_extent(const uint32_t* row, int S) {
  for (int w = S - 1; w >= 0; --w) {
    const uint32_t x = row[w];
    if (x) return 4 * w + (31 - __clz(x)) / 8 + 1;
  }
  return 0;
}

// The low `nbytes` bytes of a word (nbytes clamped to [0, 4]).
__device__ __forceinline__ uint32_t low_bytes(uint32_t x, int nbytes) {
  return nbytes >= 4 ? x : (nbytes <= 0 ? 0u : x & ((1u << (8 * nbytes)) - 1u));
}

// sign of the byte order of two little-endian words.
__device__ __forceinline__ int word_order(uint32_t a, uint32_t b) {
  const uint32_t x = __byte_perm(a, 0, 0x0123);
  const uint32_t y = __byte_perm(b, 0, 0x0123);
  return (x > y) - (x < y);
}

// A key's bytes [off, off + n) of a pool, as the aligned 16-byte chunks
// that cover them.
struct KeySpan {
  const uint4* base;  // the chunk that holds the key's first byte
  int r;              // the key's first byte within that chunk
  int n;              // bytes the compare reads
};

// Fill `s` and return true when every chunk covering pool[off, off + n)
// lies inside the pool; false sends the compare to the byte path.
__device__ __forceinline__ bool key_span(const uint8_t* pool, long long npool, long long off,
                                         int n, KeySpan& s) {
  if (n <= 0) {
    s.base = nullptr;
    s.r = 0;
    s.n = 0;
    return true;
  }
  if (off < 0 || off + n > npool) return false;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(pool);
  const uintptr_t a = lo + static_cast<uintptr_t>(off);
  const uintptr_t c0 = a & ~static_cast<uintptr_t>(15);
  const uintptr_t c1 = (a + static_cast<uintptr_t>(n) + 15) & ~static_cast<uintptr_t>(15);
  if (c0 < lo || c1 > lo + static_cast<uintptr_t>(npool)) return false;
  s.base = reinterpret_cast<const uint4*>(c0);
  s.r = static_cast<int>(a - c0);
  s.n = n;
  return true;
}

// Reads a KeySpan kC chunks (4 * kC words) at a time: each call issues its
// chunk loads together, one round trip.
template <int kC>
struct KeyReader {
  KeySpan s;
  uint4 carry;  // the first chunk of the next call's words
  int next_chunk;
  int next_word;

  __device__ __forceinline__ explicit KeyReader(const KeySpan& span)
      : s(span), next_chunk(1), next_word(0) {
    carry = s.r + s.n > 0 ? __ldg(s.base) : make_uint4(0u, 0u, 0u, 0u);
  }

  // Key words [next_word, next_word + 4 kC), masked past n.
  __device__ __forceinline__ void next(uint32_t (&kw)[4 * kC]) {
    uint32_t a[4 * (kC + 1)];
    a[0] = carry.x; a[1] = carry.y; a[2] = carry.z; a[3] = carry.w;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int ci = next_chunk + i;
      const uint4 v = 16 * ci < s.r + s.n ? __ldg(s.base + ci) : make_uint4(0u, 0u, 0u, 0u);
      a[4 * i + 4] = v.x; a[4 * i + 5] = v.y; a[4 * i + 6] = v.z; a[4 * i + 7] = v.w;
    }
    carry = make_uint4(a[4 * kC], a[4 * kC + 1], a[4 * kC + 2], a[4 * kC + 3]);
    // word t of the key is aligned word t + r / 4, shifted by r % 4 bytes
    const bool s8 = s.r & 8, s4 = s.r & 4;
    const int sh = 8 * (s.r & 3);
    uint32_t b[4 * kC + 1];
#pragma unroll
    for (int t = 0; t <= 4 * kC; ++t) {
      const uint32_t x = s8 ? a[t + 2] : a[t];
      const uint32_t y = s8 ? a[t + 3] : a[t + 1];
      b[t] = s4 ? y : x;
    }
#pragma unroll
    for (int t = 0; t < 4 * kC; ++t) {
      kw[t] = low_bytes(__funnelshift_r(b[t], b[t + 1], sh), s.n - 4 * (next_word + t));
    }
    next_chunk += kC;
    next_word += 4 * kC;
  }
};

// ---------------------------------------------------------------------------
// query row (staged) against a pool key
// ---------------------------------------------------------------------------

// sign(strcmp) of a staged row (W bytes, length qlen, extent qext) against
// pool[off : off + klen], both as zero-padded W-byte windows, the key masked
// past klen (strops.str_cmp_full).
template <int kC>
__device__ __forceinline__ int cmp_row_key(const uint32_t* row, int W, int qlen, int qext,
                                           const uint8_t* __restrict__ pool, long long npool,
                                           long long off, int klen) {
  const int n = min(max(klen, 0), W);
  KeySpan s;
  if (!key_span(pool, npool, off, n, s)) {
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(row);
    for (int j = 0; j < W; ++j) {
      const int kv = j < klen ? __ldg(pool + clamp_index(off + j, npool)) : 0;
      const int qv = qb[j];
      if (qv != kv) return qv < kv ? -1 : 1;
    }
    return sign(qlen - klen);
  }
  KeyReader<kC> kr(s);
  for (int w0 = 0; 4 * w0 < n; w0 += 4 * kC) {
    uint32_t kw[4 * kC];
    kr.next(kw);
#pragma unroll
    for (int t = 0; t < 4 * kC; ++t) {
      if (4 * (w0 + t) >= n) break;
      const uint32_t qw = row[w0 + t];
      if (qw != kw[t]) return word_order(qw, kw[t]);
    }
  }
  // the key's window is zero from n on: a nonzero query byte there decides
  return qext > n ? 1 : sign(qlen - klen);
}

// Exact equality of a staged row with pool[off : off + klen]
// (strops.str_eq): lengths equal, the row zero from klen on, the bytes
// before it equal.  Reads the key only up to klen.
template <int kC>
__device__ __forceinline__ bool eq_row_key(const uint32_t* row, int W, int qlen, int qext,
                                           const uint8_t* __restrict__ pool, long long npool,
                                           long long off, int klen) {
  if (qlen != klen) return false;
  const int n = min(max(klen, 0), W);
  if (qext > n) return false;
  KeySpan s;
  if (!key_span(pool, npool, off, n, s)) {
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(row);
    for (int j = 0; j < n; ++j) {
      if (__ldg(pool + clamp_index(off + j, npool)) != qb[j]) return false;
    }
    return true;
  }
  KeyReader<kC> kr(s);
  for (int w0 = 0; 4 * w0 < n; w0 += 4 * kC) {
    uint32_t kw[4 * kC];
    kr.next(kw);
    bool same = true;
#pragma unroll
    for (int t = 0; t < 4 * kC; ++t) {
      if (4 * (w0 + t) < n) same &= row[w0 + t] == kw[t];
    }
    if (!same) return false;
  }
  return true;
}

// sign(strncmp(row, pool[off:], pl)) over the first min(pl, W) bytes
// (strops.str_cmp_prefix).
template <int kC>
__device__ __forceinline__ int cmp_row_prefix(const uint32_t* row, int W,
                                              const uint8_t* __restrict__ pool, long long npool,
                                              long long off, int pl) {
  const int n = min(pl, W);
  if (n <= 0) return 0;
  KeySpan s;
  if (!key_span(pool, npool, off, n, s)) {
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(row);
    for (int j = 0; j < n; ++j) {
      const int kv = __ldg(pool + clamp_index(off + j, npool));
      const int qv = qb[j];
      if (kv != qv) return qv < kv ? -1 : 1;
    }
    return 0;
  }
  KeyReader<kC> kr(s);
  for (int w0 = 0; 4 * w0 < n; w0 += 4 * kC) {
    uint32_t kw[4 * kC];
    kr.next(kw);
#pragma unroll
    for (int t = 0; t < 4 * kC; ++t) {
      if (4 * (w0 + t) >= n) break;
      const uint32_t qw = low_bytes(row[w0 + t], n - 4 * (w0 + t));
      if (qw != kw[t]) return word_order(qw, kw[t]);
    }
  }
  return 0;
}

// sign(strcmp(a, b)) of two pool keys, each a W-byte window masked past its
// length (strops.str_cmp_pools).
template <int kC>
__device__ __forceinline__ int cmp_pool_keys(const uint8_t* __restrict__ pa, long long na,
                                             long long off_a, int len_a,
                                             const uint8_t* __restrict__ pb, long long nb,
                                             long long off_b, int len_b, int W) {
  const int ma = min(max(len_a, 0), W);
  const int mb = min(max(len_b, 0), W);
  KeySpan sa, sb;
  if (!key_span(pa, na, off_a, ma, sa) || !key_span(pb, nb, off_b, mb, sb)) {
    return str_cmp_pools(pa, na, off_a, len_a, pb, nb, off_b, len_b, W);
  }
  const int n = max(ma, mb);
  KeyReader<kC> ra(sa), rb(sb);
  for (int w0 = 0; 4 * w0 < n; w0 += 4 * kC) {
    uint32_t ka[4 * kC], kb[4 * kC];
    ra.next(ka);
    rb.next(kb);
#pragma unroll
    for (int t = 0; t < 4 * kC; ++t) {
      if (4 * (w0 + t) >= n) break;
      if (ka[t] != kb[t]) return word_order(ka[t], kb[t]);
    }
  }
  return sign(len_a - len_b);
}

// 16-bit h-pointer hash of a staged row over min(qlen, W) bytes.
__device__ __forceinline__ int hash16_row(const uint32_t* row, int W, int qlen) {
  uint32_t h = kFnvOffset;
  const int n = min(qlen, W);
  for (int w = 0; 4 * w < n; ++w) {
    const uint32_t x = row[w];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (4 * w + t < n) h = (h ^ ((x >> (8 * t)) & 0xFFu)) * kFnvPrime;
    }
  }
  return static_cast<int>((h ^ (h >> 16)) & 0xFFFFu);
}

// Paper Alg. 1 over a staged row (W bytes) from character `start`, for at
// most `steps` steps, with the (cdf, prob) table interleaved as float2.  The
// hash, hence every table index, depends only on the row's bytes, so the
// loads of kCdfBatch steps are issued together before the sum runs over
// them in step order, each op rounded on its own as in the reference.
constexpr int kCdfBatch = 8;

__device__ __forceinline__ float cdf_row(const uint8_t* qb, int W, int qlen, int start,
                                         const float2* __restrict__ cp, int R, int C,
                                         int steps) {
  const int n_act = min(max(qlen - start, 0), steps);  // step k is active while start + k < qlen
  const uint32_t row_mask = static_cast<uint32_t>(R - 1);
  float cdf = 0.0f;
  float prob = 1.0f;
  uint32_t h = 0u;
  for (int base = 0; base < n_act; base += kCdfBatch) {
    float2 v[kCdfBatch];
#pragma unroll
    for (int r = 0; r < kCdfBatch; ++r) {
      v[r] = make_float2(0.0f, 1.0f);
      if (base + r < n_act) {
        const int pos = min(max(start + base + r, 0), W - 1);
        const int c = min(static_cast<int>(qb[pos]), C - 1);
        v[r] = __ldg(cp + static_cast<int>(h & row_mask) * C + c);
        h = (h ^ static_cast<uint32_t>(c)) * kFnvPrime;
      }
    }
#pragma unroll
    for (int r = 0; r < kCdfBatch; ++r) {
      if (base + r < n_act) {
        cdf = add_ftz(cdf, mul_ftz(prob, v[r].x));
        prob = mul_ftz(prob, v[r].y);
      }
    }
  }
  return cdf;
}

// ---------------------------------------------------------------------------
// the multi-way rank search of a group of G lanes
// ---------------------------------------------------------------------------

// Lower bound of a staged row in a sorted order's first hi ranks: the first
// rank r with key(r) >= row.  `rec` holds one int4 record per rank,
// (entry id, key offset, key length, flag), so a step reads a pivot's key
// with one 16-byte load before the key itself.  Each step, lane j of the
// group compares the key at pivot lo + (j + 1) (hi - lo) / (G + 1); the
// count c of pivots below the row narrows [lo, hi) to (pivot c - 1,
// pivot c].  Every lane of the group calls it with the same row and hi and
// gets the same rank.  `gmask` names the group's lanes in the warp, the
// first of them at bit `gshift`.
//
// This equals core.walk.rank_sorted, a halving search of rank_iters >=
// ceil(log2(n + 1)) steps, because that search returns the lower bound of a
// sequence whose compare with the row is monotone, and so does any exact
// search.  The compare is monotone because every stored key is at most W
// bytes long (the builder's width is the longest key + 8; over-width delta
// keys are rejected), so str_cmp_full is plain lexicographic order, and
// the order is sorted in it: ent_sorted is the builder's key order and
// ds_order[:n_delta] is delta_sort_order's.  Duplicates keep the lower
// bound unique.
template <int G, int kC>
__device__ __forceinline__ int group_rank(const uint32_t* row, int W, int qlen, int qext,
                                          const int4* __restrict__ rec, long long n_rec,
                                          const uint8_t* __restrict__ pool, long long npool,
                                          int hi, int lane, unsigned gmask, int gshift) {
  int lo = 0;
  while (lo < hi) {  // lo and hi are the same in every lane of the group
    const long long len = hi - lo;
    const int piv = lo + static_cast<int>((static_cast<long long>(lane + 1) * len) / (G + 1));
    const int4 r = __ldg(rec + min(static_cast<long long>(piv), n_rec - 1));
    const bool below = cmp_row_key<kC>(row, W, qlen, qext, pool, npool, r.y, r.z) > 0;
    const int c = __popc(__ballot_sync(gmask, below) >> gshift & ((1u << G) - 1u));
    const int p_lo = __shfl_sync(gmask, piv, max(c - 1, 0), G);
    const int p_hi = __shfl_sync(gmask, piv, min(c, G - 1), G);
    if (c > 0) lo = p_lo + 1;
    if (c < G) hi = p_hi;
  }
  return lo;
}

}  // namespace lits
