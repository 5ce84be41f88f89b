// Native graph preprocessing: counting-sort CSR/CSC construction + R-MAT.
//
// Host runtime component replacing the reference's host scipy path
// (train_gatconv.py:78-94) and device cuSPARSE conversions
// (src/convert/convert_kernel.cu): graph preprocessing is one-time host
// work, so the right tool is an O(E) counting sort in C++, not a GPU kernel.
// numpy's lexsort is comparison-based and ~20x slower on large edge lists.
//
// Exposed via ctypes (see native/__init__.py). All functions are
// single-threaded C++17; indices are int64 on input (global ids can exceed
// int32 at papers100M scale), int32 on per-shard outputs.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sort edges by (dst, src) into CSR over destination rows.
//   row_ptr: out [n+1] int64
//   col_ind: out [e] int32 (source node of CSR edge)
// Two stable counting passes (LSD radix over src then dst).
void dgnn_coo_to_csr(int64_t n, int64_t e, const int64_t* src,
                     const int64_t* dst, int64_t* row_ptr, int32_t* col_ind) {
  // pass 1: stable counting sort of edge ids by src
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[src[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::vector<int64_t> by_src(e);
  {
    std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < e; ++i) by_src[pos[src[i]]++] = i;
  }
  // pass 2: stable counting sort of by_src by dst
  std::memset(cnt.data(), 0, sizeof(int64_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) cnt[dst[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::memcpy(row_ptr, cnt.data(), sizeof(int64_t) * (n + 1));
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t k = 0; k < e; ++k) {
    int64_t eid = by_src[k];
    col_ind[pos[dst[eid]]++] = static_cast<int32_t>(src[eid]);
  }
}

// Transpose CSR -> CSC, emitting the CSR edge id stored at each CSC slot
// (the reference's `permute` contract, train_gatconv.py:92-94).  One
// counting pass; stability over CSR order gives within-column row sorting.
void dgnn_csr_to_csc_permute(int64_t n, int64_t e, const int64_t* row_ptr,
                             const int32_t* col_ind, int64_t* col_ptr,
                             int32_t* row_ind, int32_t* permute) {
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[col_ind[i] + 1]++;
  for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
  std::memcpy(col_ptr, cnt.data(), sizeof(int64_t) * (n + 1));
  std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
  for (int64_t r = 0; r < n; ++r) {
    for (int64_t j = row_ptr[r]; j < row_ptr[r + 1]; ++j) {
      int64_t p = pos[col_ind[j]]++;
      row_ind[p] = static_cast<int32_t>(r);
      permute[p] = static_cast<int32_t>(j);
    }
  }
}

// Fill dense padded slot tables for degree binning (graph/binning.py):
// segment s covers CSR slots [starts[s], starts[s]+counts[s]).
void dgnn_bin_fill(int64_t num_seg, int64_t width, const int64_t* starts,
                   const int64_t* counts, const int32_t* col_ind,
                   const int64_t* edge_ids, int32_t* nbr, int32_t* edge) {
  for (int64_t s = 0; s < num_seg; ++s) {
    int64_t base = s * width;
    int64_t st = starts[s];
    int64_t c = counts[s];
    for (int64_t j = 0; j < c; ++j) {
      nbr[base + j] = col_ind[st + j];
      edge[base + j] = static_cast<int32_t>(edge_ids[st + j]);
    }
    for (int64_t j = c; j < width; ++j) {
      nbr[base + j] = 0;
      edge[base + j] = 0;
    }
  }
}

// R-MAT (recursive matrix) power-law edge generator, xoshiro256** PRNG.
// Generates e/2+1 directed edges then symmetrizes into (src, dst) of
// length e (matching data/synthetic.rmat_edges semantics).
static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

void dgnn_rmat(int64_t n, int64_t e, uint64_t seed, double a, double b,
               double c, int64_t* src, int64_t* dst) {
  uint64_t s[4];
  // splitmix64 seeding
  uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
  for (int i = 0; i < 4; ++i) {
    z += 0x9E3779B97F4A7C15ULL;
    uint64_t t = z;
    t = (t ^ (t >> 30)) * 0xBF58476D1CE4E5B9ULL;
    t = (t ^ (t >> 27)) * 0x94D049BB133111EBULL;
    s[i] = t ^ (t >> 31);
  }
  auto next = [&]() -> uint64_t {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  };
  int scale = 1;
  while ((1LL << scale) < n) ++scale;
  const int64_t half = e / 2 + 1;
  const double inv = 1.0 / 18446744073709551616.0;  // 2^-64
  // node-id scramble: fixed odd multiplier hash (keeps hubs spread out)
  auto scramble = [&](int64_t v) -> int64_t {
    uint64_t x = static_cast<uint64_t>(v) * 0x9E3779B97F4A7C15ULL;
    x ^= x >> 29;
    return static_cast<int64_t>(x % static_cast<uint64_t>(n));
  };
  for (int64_t i = 0; i < half; ++i) {
    int64_t u = 0, v = 0;
    for (int lev = 0; lev < scale; ++lev) {
      double r = static_cast<double>(next()) * inv;
      int down = (r >= a && r < a + b) || (r >= a + b + c);
      int right = r >= a + b;
      u = (u << 1) | down;
      v = (v << 1) | right;
    }
    u = scramble(u % n);
    v = scramble(v % n);
    if (i < e) { src[i] = u; dst[i] = v; }
    int64_t j = half + i;
    if (j < e) { src[j] = v; dst[j] = u; }
  }
}

}  // extern "C"
