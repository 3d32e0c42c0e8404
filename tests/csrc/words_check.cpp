// The single-thread functions of src/repro_torch/kernels/csrc/lits_words.cuh
// (row staging, word-wide compares, hash, GetCDF) against byte loops written
// from the reference's semantics (repro/kernels/strops.py), on random pools
// at every alignment, keys that run many bytes deep into the query, lengths
// past the width, pools whose ends cut the keys' chunks, and rows with
// bytes past their length.  Built with a host C++ compiler and the
// stand-ins of host/cuda_runtime.h:
//
//   g++ -std=c++17 -O1 -I tests/csrc/host -I src/repro_torch/kernels/csrc
//       tests/csrc/words_check.cpp -o words_check
//   ./words_check [trials]
//
// Prints the number of compares checked, how many took the word path and
// how many disagreed; exits non-zero on any disagreement.
#include <cstdio>
#include <random>
#include <vector>

#include "cuda_runtime.h"

uintptr_t g_lo = 0, g_hi = 0;
dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};

#include "lits_words.cuh"

using namespace lits;

namespace {

long long clampi(long long i, long long n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }
int sgn(int d) { return (d > 0) - (d < 0); }

int ref_full(const uint8_t* q, int W, int qlen, const uint8_t* pool, long long np, long long off,
             int klen) {
  for (int j = 0; j < W; ++j) {
    const int kv = j < klen ? pool[clampi(off + j, np)] : 0;
    if (q[j] != kv) return q[j] < kv ? -1 : 1;
  }
  return sgn(qlen - klen);
}

bool ref_eq(const uint8_t* q, int W, int qlen, const uint8_t* pool, long long np, long long off,
            int klen) {
  if (qlen != klen) return false;
  for (int j = 0; j < W; ++j) {
    if ((j < klen ? pool[clampi(off + j, np)] : 0) != q[j]) return false;
  }
  return true;
}

int ref_prefix(const uint8_t* q, int W, const uint8_t* pool, long long np, long long off, int pl) {
  for (int j = 0; j < std::min(pl, W); ++j) {
    const int kv = pool[clampi(off + j, np)];
    if (kv != q[j]) return q[j] < kv ? -1 : 1;
  }
  return 0;
}

int ref_pools(const uint8_t* pa, long long na, long long oa, int la, const uint8_t* pb,
              long long nb, long long ob, int lb, int W) {
  for (int j = 0; j < W; ++j) {
    const int va = j < la ? pa[clampi(oa + j, na)] : 0;
    const int vb = j < lb ? pb[clampi(ob + j, nb)] : 0;
    if (va != vb) return va < vb ? -1 : 1;
  }
  return sgn(la - lb);
}

int ref_hash16(const uint8_t* q, int W, int qlen) {
  uint32_t h = kFnvOffset;
  for (int k = 0; k < std::min(qlen, W); ++k) h = (h ^ q[k]) * kFnvPrime;
  return static_cast<int>((h ^ (h >> 16)) & 0xFFFF);
}

float ref_cdf(const uint8_t* q, int L, int qlen, int start, const float* ct, const float* pt,
              int R, int C, int steps) {
  float cdf = 0, prob = 1;
  uint32_t h = 0;
  for (int k = 0; k < steps && start + k < qlen; ++k) {
    const int c = std::min(static_cast<int>(q[std::min(std::max(start + k, 0), L - 1)]), C - 1);
    const int idx = static_cast<int>(h & static_cast<uint32_t>(R - 1)) * C + c;
    cdf = lits::add_ftz(cdf, lits::mul_ftz(prob, ct[idx]));
    prob = lits::mul_ftz(prob, pt[idx]);
    h = (h ^ static_cast<uint32_t>(c)) * kFnvPrime;
  }
  return cdf;
}

// `n` bytes at a random offset 0..15 from a 16-byte boundary of `buf`.
uint8_t* misaligned(std::vector<uint8_t>& buf, size_t n, int shift) {
  buf.assign(n + 64, 0);
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(buf.data()) + 15) &
                                    ~static_cast<uintptr_t>(15)) + shift;
}

}  // namespace

int main(int argc, char** argv) {
  const int trials = argc > 1 ? std::atoi(argv[1]) : 3000;
  std::mt19937_64 rng(7);
  auto U = [&](long long a, long long b) {
    return a + static_cast<long long>(rng() % static_cast<unsigned long long>(b - a + 1));
  };
  long bad = 0, cases = 0, word_path = 0;
  auto fail = [&](const char* what, int W, long long off, int len, int got, int want) {
    if (++bad <= 20) std::printf("%s: W=%d off=%lld len=%d got %d want %d\n", what, W, off, len, got, want);
  };
  for (int trial = 0; trial < trials; ++trial) {
    const int W = static_cast<int>(U(1, 100));
    const int S = stage_stride(W);
    const long long np = U(1, 300), npb = U(1, 300);
    std::vector<uint8_t> bufa, bufb, bufq;
    uint8_t* pa = misaligned(bufa, np, static_cast<int>(U(0, 15)));
    uint8_t* pb = misaligned(bufb, npb, static_cast<int>(U(0, 15)));
    const int alphabet = static_cast<int>(U(0, 3));  // tiny, with zeros, around 0x80, any
    auto rb = [&]() -> uint8_t {
      switch (alphabet) {
        case 0: return static_cast<uint8_t>(U(0, 2));
        case 1: return static_cast<uint8_t>(U(0, 1) ? 0 : U(1, 255));
        case 2: return static_cast<uint8_t>(U(0x7e, 0x81));
        default: return static_cast<uint8_t>(U(0, 255));
      }
    };
    for (long long i = 0; i < np; ++i) pa[i] = rb();
    for (long long i = 0; i < npb; ++i) pb[i] = rb();
    // a (B, W) query matrix at a random misalignment, rows copied from pool
    // keys and then mutated; a block of `rows` rows from r0 is staged
    const int B = static_cast<int>(U(1, 40)), rows = static_cast<int>(U(1, 16));
    const long long r0 = U(0, B - 1);
    uint8_t* qm = misaligned(bufq, static_cast<size_t>(B) * W, static_cast<int>(U(0, 15)));
    std::vector<int> qlens(B);
    for (int r = 0; r < B; ++r) {
      const long long off = U(-2, np + 2);
      const int kl = static_cast<int>(U(0, W + 1));
      uint8_t* q = qm + static_cast<size_t>(r) * W;
      for (int j = 0; j < W; ++j) q[j] = j < kl ? pa[clampi(off + j, np)] : 0;
      const int mut = static_cast<int>(U(0, 5));
      if (mut == 1 && kl > 0) q[kl - 1] ^= static_cast<uint8_t>(U(1, 255));
      if (mut == 2) q[U(0, W - 1)] = rb();  // possibly past the row's length
      qlens[r] = U(0, 2) ? kl : static_cast<int>(U(-1, W + 1));
    }
    std::vector<uint32_t> stage(static_cast<size_t>(rows) * S, 0xDEADBEEFu);
    g_lo = reinterpret_cast<uintptr_t>(qm);
    g_hi = reinterpret_cast<uintptr_t>(qm + static_cast<size_t>(B) * W);
    stage_rows(qm, B, W, r0, rows, stage.data(), S);
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(stage.data());
    for (int r = 0; r < rows; ++r) {
      for (int j = 0; j < 4 * S; ++j) {
        const uint8_t want = (r0 + r < B && j < W) ? qm[(r0 + r) * W + j] : 0;
        if (sb[static_cast<size_t>(r) * 4 * S + j] != want) fail("stage", W, r, j, sb[r * 4 * S + j], want);
      }
    }
    for (int r = 0; r < rows && r0 + r < B; ++r) {
      const uint32_t* row = stage.data() + static_cast<size_t>(r) * S;
      const uint8_t* q = qm + (r0 + r) * W;
      const int qlen = qlens[r0 + r];
      int ext = 0;
      for (int j = 0; j < W; ++j) ext = q[j] ? j + 1 : ext;
      if (row_extent(row, S) != ext) fail("extent", W, 0, qlen, row_extent(row, S), ext);
      if (hash16_row(row, W, qlen) != ref_hash16(q, W, qlen)) fail("hash16", W, 0, qlen, 0, 1);
      for (int c = 0; c < 20; ++c) {
        long long off = U(-3, np + 3);
        int kl = static_cast<int>(U(-2, W + 2));
        if (c < 5) {  // the row's own bytes as a pool key: compares run deep
          const long long o = U(0, np - 1);
          const int l = static_cast<int>(std::min<long long>(np - o, U(0, W)));
          for (int j = 0; j < l; ++j) pa[o + j] = q[j];
          off = o;
          kl = U(0, 1) ? l : static_cast<int>(U(0, W + 1));
        }
        g_lo = reinterpret_cast<uintptr_t>(pa);
        g_hi = reinterpret_cast<uintptr_t>(pa + np);
        KeySpan s;
        if (key_span(pa, np, off, std::min(std::max(kl, 0), W), s) && kl > 0) ++word_path;
        const int want = ref_full(q, W, qlen, pa, np, off, kl);
        int got = cmp_row_key<1>(row, W, qlen, ext, pa, np, off, kl);
        if (got != want) fail("cmp_row_key<1>", W, off, kl, got, want);
        got = cmp_row_key<2>(row, W, qlen, ext, pa, np, off, kl);
        if (got != want) fail("cmp_row_key<2>", W, off, kl, got, want);
        const bool eq = eq_row_key<6>(row, W, qlen, ext, pa, np, off, kl);
        if (eq != ref_eq(q, W, qlen, pa, np, off, kl)) fail("eq_row_key", W, off, kl, eq, !eq);
        const int pl = static_cast<int>(U(-1, W + 3));
        got = cmp_row_prefix<2>(row, W, pa, np, off, pl);
        if (got != ref_prefix(q, W, pa, np, off, pl)) fail("cmp_row_prefix", W, off, pl, got, -got);
        long long ob = U(-3, npb + 3);
        int lb = static_cast<int>(U(-2, W + 2));
        if (c % 2) {  // a copy of the first key in the second pool
          const long long o = U(0, npb - 1);
          const int l = static_cast<int>(std::min<long long>(npb - o, std::max(kl, 0)));
          for (int j = 0; j < l; ++j) pb[o + j] = pa[clampi(off + j, np)];
          ob = o;
          lb = U(0, 1) ? kl : l;
        }
        g_hi = 0;  // two pools: unchecked
        got = cmp_pool_keys<1>(pa, np, off, kl, pb, npb, ob, lb, W);
        const int wp = ref_pools(pa, np, off, kl, pb, npb, ob, lb, W);
        if (got != wp) fail("cmp_pool_keys", W, off, kl, got, wp);
        ++cases;
      }
      const int R = 1 << static_cast<int>(U(0, 4)), C = static_cast<int>(U(1, 256));
      std::vector<float> ct(R * C), pt(R * C);
      std::vector<float2> cp(R * C);
      for (int i = 0; i < R * C; ++i) {
        ct[i] = static_cast<float>(U(0, 1 << 20)) / (1 << 20);
        pt[i] = static_cast<float>(U(1, 1 << 20)) / (1 << 20);
        cp[i] = {ct[i], pt[i]};
      }
      const int start = static_cast<int>(U(-2, W + 2)), steps = std::min(static_cast<int>(U(0, 70)), W);
      const float gc = cdf_row(reinterpret_cast<const uint8_t*>(row), W, qlen, start, cp.data(), R, C, steps);
      const float wc = ref_cdf(q, W, qlen, start, ct.data(), pt.data(), R, C, steps);
      if (std::memcmp(&gc, &wc, 4)) fail("cdf_row", W, start, qlen, 0, 1);
    }
  }
  std::printf("cases %ld word_path %ld bad %ld\n", cases, word_path, bad);
  return bad != 0;
}
