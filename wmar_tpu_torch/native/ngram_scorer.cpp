// Host-side watermark detection: ngram extraction, dedup and greenlist
// scoring over packed-bit tables or hash thresholds.
//
// The port's own copy of the JAX package's scorer (the reference's CPU
// detection loop, wmar/watermarking/gentime_watermark.py:278-318: a Python
// Counter and dict lookups per image). It serves host-side bulk re-scoring
// (the analyzer over saved .npy code files) and the torch-compat
// greenlists, whose rows are built on the host.
//
// Plain C ABI for ctypes: no Python headers needed.

#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

// 64-bit mix for ngram dedup keys (splitmix64 finalizer).
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline uint64_t ngram_key(const int32_t* toks, int n) {
  uint64_t h = 0x243f6a8885a308d3ULL;
  for (int i = 0; i < n; ++i) h = mix64(h ^ (uint64_t)(uint32_t)toks[i]);
  return h;
}

// murmur3-style 32-bit finalizer, mirroring core/hashing.py:fmix32.
inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

inline uint32_t hash_key_token(uint32_t key, uint32_t token, uint32_t salt) {
  uint32_t k = fmix32(key * 0x9e3779b9u + salt);
  uint32_t t = token * 0x85ebca6bu;
  return fmix32(k ^ t ^ (t >> 15));
}

struct Green {
  // mode 0: packed table [n_keys x words]; mode 1: hash thresholds [vocab];
  // mode 2: key-mapped packed table — row r covers context key key_ids[r]
  // (sorted ascending). Mode 2 serves lazily-built greenlists (torch-compat
  // at 65k vocab) where only the keys present in the batch have rows.
  int mode;
  const uint32_t* table;
  int64_t n_keys;
  int64_t words;
  const uint32_t* thresholds;
  uint32_t salt;
  int fixed_key;
  const int64_t* key_ids;

  bool is_green(int64_t key, int32_t token) const {
    if (fixed_key) key = 0;
    if (mode == 0) {
      if (key < 0) key = 0;
      if (key >= n_keys) key = n_keys - 1;
      uint32_t word = table[key * words + token / 32];
      return (word >> (token % 32)) & 1u;
    }
    if (mode == 2) {
      int64_t lo = 0, hi = n_keys;
      while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (key_ids[mid] < key) lo = mid + 1; else hi = mid;
      }
      if (lo >= n_keys || key_ids[lo] != key) return false;
      uint32_t word = table[lo * words + token / 32];
      return (word >> (token % 32)) & 1u;
    }
    return hash_key_token((uint32_t)key, (uint32_t)token, salt) < thresholds[token];
  }
};

void score_one(const int32_t* codes, int64_t t, int h, int spatial, int dim,
               const Green& g, int64_t* n_green, int64_t* n_scored) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(2 * (size_t)t);
  int64_t green = 0, scored = 0;
  auto visit = [&](const int32_t* ctx, int n_ctx, int32_t target) {
    std::vector<int32_t> row(ctx, ctx + n_ctx);
    row.push_back(target);
    uint64_t key = ngram_key(row.data(), n_ctx + 1);
    if (!seen.insert(key).second) return;
    int64_t sum = 0;
    for (int i = 0; i < n_ctx; ++i) sum += ctx[i];
    scored += 1;
    green += g.is_green(sum, target) ? 1 : 0;
  };

  if (!spatial) {
    for (int64_t i = 0; i + h < t; ++i) visit(codes + i, h, codes[i + h]);
  } else if (h == 1) {
    for (int i = 0; i < dim; ++i)
      for (int j = 0; j < dim; ++j) {
        if (i == 0 && j == 0) continue;
        int32_t ctx = (j == 0) ? codes[(i - 1) * dim] : codes[i * dim + j - 1];
        visit(&ctx, 1, codes[i * dim + j]);
      }
  } else {  // h == 3: 2x2 blocks
    for (int i = 0; i + 1 < dim; ++i)
      for (int j = 0; j + 1 < dim; ++j) {
        int32_t ctx[3] = {codes[i * dim + j], codes[i * dim + j + 1],
                          codes[(i + 1) * dim + j]};
        visit(ctx, 3, codes[(i + 1) * dim + j + 1]);
      }
  }
  *n_green = green;
  *n_scored = scored;
}

}  // namespace

extern "C" {

// Batched scoring with a packed-bit greenlist table.
// codes: [batch, t] int32; out: [batch, 2] int64 (n_green, n_scored).
void score_codes_table(const int32_t* codes, int64_t batch, int64_t t, int h,
                       int spatial, int dim, const uint32_t* table,
                       int64_t n_keys, int64_t words, int fixed_key,
                       int64_t* out) {
  Green g{0, table, n_keys, words, nullptr, 0, fixed_key, nullptr};
  for (int64_t b = 0; b < batch; ++b)
    score_one(codes + b * t, t, h, spatial, dim, g, &out[b * 2], &out[b * 2 + 1]);
}

// Batched scoring with hash thresholds (native greenlist mode).
void score_codes_hash(const int32_t* codes, int64_t batch, int64_t t, int h,
                      int spatial, int dim, const uint32_t* thresholds,
                      uint32_t salt, int fixed_key, int64_t* out) {
  Green g{1, nullptr, 0, 0, thresholds, salt, fixed_key, nullptr};
  for (int64_t b = 0; b < batch; ++b)
    score_one(codes + b * t, t, h, spatial, dim, g, &out[b * 2], &out[b * 2 + 1]);
}

// Batched scoring with a key-mapped packed table: key_ids [n_keys] sorted
// ascending, table [n_keys x words]. Context keys absent from key_ids score
// as not-green (callers pass every key present in the batch).
void score_codes_keymap(const int32_t* codes, int64_t batch, int64_t t, int h,
                        int spatial, int dim, const int64_t* key_ids,
                        int64_t n_keys, const uint32_t* table, int64_t words,
                        int64_t* out) {
  Green g{2, table, n_keys, words, nullptr, 0, 0, key_ids};
  for (int64_t b = 0; b < batch; ++b)
    score_one(codes + b * t, t, h, spatial, dim, g, &out[b * 2], &out[b * 2 + 1]);
}

}  // extern "C"
