// The one-thread h-pointer probe of src/repro_torch/kernels/csrc/lits_walk.cuh
// (probe_mask and the bit walk of probe_first, which K4's compact-node
// resolve runs) against loops written from the reference's semantics:
// repro/kernels/cnode_probe.py (the first slot j with frm <= j < cnt,
// j < cap, whose hash matches) and the CNODE loop of
// repro/core/walk.py::resolve_terminal (the lowest such j whose key also
// matches, every index clipped to the pool's last element).  Random pools
// of a few hash values, so that false 16-bit matches are common; caps 1 to
// 70, across the 32-slot chunks; cnt <= 0 and cnt > cap; frm < 0 and
// frm >= the end; every base alignment, and bases near the pool's end,
// where the clip decides.  Built with a host C++ compiler and the
// stand-ins of host/cuda_runtime.h:
//
//   g++ -std=c++17 -O1 -I tests/csrc/host -I src/repro_torch/kernels/csrc
//       tests/csrc/probe_check.cpp -o probe_check
//   ./probe_check [trials]
//
// Prints the number of probes checked, how many spanned more than one
// chunk and how many disagreed; exits non-zero on any disagreement.
#include <cstdio>
#include <random>
#include <vector>

#include "cuda_runtime.h"

uintptr_t g_lo = 0, g_hi = 0;
dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};

#include "lits_walk.cuh"

namespace {

long long clampi(long long i, long long n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// cnode_probe.py: match = (hashes == qh) & (j < cnt) & (j >= frm) over j < cap.
int ref_first_hash(const std::vector<int>& h, long long base, int qh, int cnt, int frm,
                   int cap) {
  const long long n = static_cast<long long>(h.size());
  for (int j = 0; j < cap; ++j) {
    if (j < cnt && j >= frm && h[clampi(base + j, n)] == qh) return j;
  }
  return -1;
}

// walk.py: for j < cap, hmatch = (j < cnt) & (h[min(base + j, n - 1)] == qh),
// eq = hmatch & key matches; the first eq wins.  Returns the slot and the
// slots whose key is compared (the hash matches up to the first equal key).
int ref_resolve(const std::vector<int>& h, const std::vector<int>& ent,
                const std::vector<char>& key_eq, long long base, int qh, int cnt, int cap,
                std::vector<int>& compared) {
  const long long n = static_cast<long long>(h.size());
  compared.clear();
  for (int j = 0; j < cap; ++j) {
    if (j < cnt && h[clampi(base + j, n)] == qh) {
      compared.push_back(j);
      if (key_eq[ent[clampi(base + j, n)]]) return j;
    }
  }
  return -1;
}

}  // namespace

int main(int argc, char** argv) {
  const int trials = argc > 1 ? std::atoi(argv[1]) : 100;
  std::mt19937_64 rng(7);
  auto uni = [&](long long lo, long long hi) {  // inclusive
    return std::uniform_int_distribution<long long>(lo, hi)(rng);
  };
  long long cases = 0, multi = 0, bad = 0;
  std::vector<int> compared, got_compared;
  for (int t = 0; t < trials; ++t) {
    const long long n = uni(1, 160);
    const int values = static_cast<int>(uni(1, 5));
    std::vector<int> h(n), ent(n);
    for (long long i = 0; i < n; ++i) {
      h[i] = static_cast<int>(uni(0, values - 1));
      ent[i] = static_cast<int>(uni(0, 63));
    }
    std::vector<char> key_eq(64);
    for (auto& k : key_eq) k = uni(0, 3) == 0;
    g_lo = reinterpret_cast<uintptr_t>(h.data());
    g_hi = g_lo + sizeof(int) * n;
    for (int cap = 1; cap <= 70; ++cap) {
      for (int align = 0; align < 4; ++align) {
        for (int near_end = 0; near_end < 2; ++near_end) {
          long long base = near_end ? uni(std::max<long long>(0, n - cap - 3), n + 2)
                                    : uni(0, n + 2);
          base += (align - base % 4 + 4) % 4;
          const int qh = static_cast<int>(uni(0, values));
          const int cnts[] = {-2, 0, 1, static_cast<int>(uni(1, cap)), cap, cap + 3};
          for (int cnt : cnts) {
            const int end = std::min(cnt, cap);
            const int frms[] = {-2, 0, static_cast<int>(uni(0, std::max(end, 1))), end,
                                end + 1};
            for (int frm : frms) {
              ++cases;
              multi += end - std::max(frm, 0) > lits::kProbeChunk;
              bool ok = true;
              // the mask of every chunk, bit by bit
              for (int c0 = 0; c0 < cap + lits::kProbeChunk; c0 += lits::kProbeChunk) {
                const uint32_t m = lits::probe_mask(h.data(), base, n, qh, cnt, frm, cap, c0);
                for (int j = 0; j < lits::kProbeChunk; ++j) {
                  const int s = c0 + j;
                  const bool want = s >= std::max(frm, 0) && s < end &&
                                    h[clampi(base + s, n)] == qh;
                  ok &= static_cast<bool>((m >> j) & 1u) == want;
                }
              }
              // K3's function: the first hash match
              ok &= lits::probe_first(h.data(), base, n, qh, cnt, frm, cap,
                                      [](int) { return true; }) ==
                    ref_first_hash(h, base, qh, cnt, frm, cap);
              // K4's resolve (frm = 0): the first key match, keys compared in order
              const int want = ref_resolve(h, ent, key_eq, base, qh, cnt, cap, compared);
              got_compared.clear();
              const int got = lits::probe_first(
                  h.data(), base, n, qh, cnt, 0, cap, [&](int j) {
                    got_compared.push_back(j);
                    return static_cast<bool>(key_eq[ent[clampi(base + j, n)]]);
                  });
              ok &= got == want && got_compared == compared;
              if (!ok && ++bad <= 5) {
                std::printf("mismatch: n %lld base %lld cap %d cnt %d frm %d qh %d\n", n,
                            base, cap, cnt, frm, qh);
              }
            }
          }
        }
      }
    }
  }
  std::printf("probes %lld multi-chunk %lld bad %lld\n", cases, multi, bad);
  return bad ? 1 : 0;
}
