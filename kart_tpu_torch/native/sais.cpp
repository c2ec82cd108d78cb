// Suffix-array construction for the kart-tpu offline genome indexer.
//
// Clean-room implementation of the SA-IS induced-sorting algorithm
// (Nong, Zhang & Chan, "Two Efficient Algorithms for Linear Time Suffix
// Array Construction", 2009).  The reference aligner builds its BWT with an
// incremental BWT-SW construction (reference: src/BWT_Index/bwt_gen.c); we
// instead compute the full suffix array directly and derive the BWT from it,
// which produces byte-identical .bwt/.sa artifacts far more simply and
// ~10x faster.
//
// Convention: the caller passes a text s[0..n-1] whose last element s[n-1]
// is a unique smallest sentinel (value 0); all other values are >= 1 and
// < K.  The output sa[0..n-1] is the suffix array (sa[0] == n-1).
//
// Exposed C ABI (loaded via ctypes from kart_tpu_torch/native/__init__.py):
//   int kart_sais_u8 (const uint8_t*  s, int64_t n, int64_t K, int64_t* sa);
//   int kart_sais_i64(const int64_t*  s, int64_t n, int64_t K, int64_t* sa);

#include <cstdint>
#include <vector>

namespace {

constexpr int64_t EMPTY = -1;

template <typename T>
inline bool is_lms(const std::vector<bool>& t, int64_t i) {
  return i > 0 && t[i] && !t[i - 1];
}

template <typename T>
void get_buckets(const T* s, int64_t n, int64_t K, std::vector<int64_t>& bkt,
                 bool ends) {
  bkt.assign(K, 0);
  for (int64_t i = 0; i < n; ++i) ++bkt[s[i]];
  int64_t sum = 0;
  for (int64_t c = 0; c < K; ++c) {
    sum += bkt[c];
    bkt[c] = ends ? sum : sum - bkt[c];
  }
}

// Induce L-type then S-type suffixes from the currently placed LMS entries.
template <typename T>
void induce(const T* s, int64_t* sa, int64_t n, int64_t K,
            const std::vector<bool>& t, std::vector<int64_t>& bkt) {
  // L-type: scan left to right, bucket heads.
  get_buckets(s, n, K, bkt, /*ends=*/false);
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = sa[i] - 1;
    if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
  }
  // S-type: scan right to left, bucket ends.
  get_buckets(s, n, K, bkt, /*ends=*/true);
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t j = sa[i] - 1;
    if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
  }
}

template <typename T>
void sais(const T* s, int64_t* sa, int64_t n, int64_t K) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> t(n, false);
  t[n - 1] = true;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);

  std::vector<int64_t> bkt;

  // Stage 1: sort LMS substrings by one round of induced sorting.
  for (int64_t i = 0; i < n; ++i) sa[i] = EMPTY;
  get_buckets(s, n, K, bkt, /*ends=*/true);
  for (int64_t i = n - 1; i >= 1; --i)
    if (t[i] && !t[i - 1]) sa[--bkt[s[i]]] = i;
  induce(s, sa, n, K, t, bkt);

  // Compact the sorted LMS suffixes into the front of sa.
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i)
    if (is_lms<T>(t, sa[i])) sa[n1++] = sa[i];

  // Name LMS substrings; store names at sa[n1 + pos/2].
  for (int64_t i = n1; i < n; ++i) sa[i] = EMPTY;
  int64_t name = 0, prev = EMPTY;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = sa[i];
    bool differ = (prev == EMPTY);
    if (!differ) {
      // Compare LMS substrings starting at prev and pos (inclusive of the
      // terminating LMS character).
      for (int64_t d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
          differ = true;
          break;
        }
        if (d > 0 && (is_lms<T>(t, pos + d) || is_lms<T>(t, prev + d))) {
          differ = !(is_lms<T>(t, pos + d) && is_lms<T>(t, prev + d));
          break;
        }
      }
    }
    if (differ) {
      ++name;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  // Compact names into s1 = sa[n - n1 .. n).
  for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
    if (sa[i] != EMPTY) sa[j--] = sa[i];

  int64_t* sa1 = sa;
  int64_t* s1 = sa + n - n1;
  if (name < n1) {
    sais<int64_t>(s1, sa1, n1, name);
  } else {
    for (int64_t i = 0; i < n1; ++i) sa1[s1[i]] = i;
  }

  // Map sorted LMS indices back to text positions (reuse s1 as position buf).
  for (int64_t i = 1, j = 0; i < n; ++i)
    if (t[i] && !t[i - 1]) s1[j++] = i;
  for (int64_t i = 0; i < n1; ++i) sa1[i] = s1[sa1[i]];

  // Stage 3: final induced sort from fully sorted LMS suffixes.
  for (int64_t i = n1; i < n; ++i) sa[i] = EMPTY;
  get_buckets(s, n, K, bkt, /*ends=*/true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t j = sa[i];
    sa[i] = EMPTY;
    sa[--bkt[s[j]]] = j;
  }
  induce(s, sa, n, K, t, bkt);
}

}  // namespace

extern "C" {

int kart_sais_u8(const uint8_t* s, int64_t n, int64_t K, int64_t* sa) {
  if (n <= 0 || s[n - 1] != 0) return -1;
  sais<uint8_t>(s, sa, n, K);
  return 0;
}

int kart_sais_i64(const int64_t* s, int64_t n, int64_t K, int64_t* sa) {
  if (n <= 0 || s[n - 1] != 0) return -1;
  sais<int64_t>(s, sa, n, K);
  return 0;
}

}  // extern "C"
