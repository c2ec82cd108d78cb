// The FM index on the card, as the port's kernels read it: a block's
// checkpoint row (load_cp), and the sampled-SA walk of one SA row (bwt_sa,
// reference src/BWT_Index/bwt.c:101-123 and src/bwt_search.cpp:128-138):
// inverse-Psi steps until the row is a multiple of 32, whose text position
// the sampled SA holds, then that position plus the steps taken.
// fm_seed_scan.cu reads the checkpoint rows; sa_walk.cu walks rows.  T is the
// index type: int below 2**31 text bases, long long above; the int instance
// of the walk does no 64-bit arithmetic but pointer offsets.
//
// One step of the walk is one round of independent loads: the row's
// 128-base BWT block (eight words, one 32-byte sector) and its checkpoint
// row of four counts.  The block's word at the row gives the base c =
// bwt_char(row); occ(row, c) is the checkpoint's count of c plus the c's
// among the block's bases up to the row, counted with one popcount a word.
// So a walk of n steps is a chain of n dependent loads, which hit L2 at the
// sizes the port maps.

#pragma once

#include <cstdint>

namespace {

constexpr int kSaIntvLog2 = 5;
constexpr unsigned kM55 = 0x55555555u;

// A block's four checkpoint counts: an int4 (int index), or LL4, loaded as
// two 16-byte halves (long long).
struct alignas(16) LL4 {
  long long x, y, z, w;
};
template <typename T>
struct CpRow;
template <>
struct CpRow<int> {
  using type = int4;
};
template <>
struct CpRow<long long> {
  using type = LL4;
};

template <typename I>
__device__ __forceinline__ int4 load_cp(const int4* __restrict__ cp, I blk) {
  return __ldg(cp + blk);
}

template <typename I>
__device__ __forceinline__ LL4 load_cp(const LL4* __restrict__ cp, I blk) {
  const longlong2* p = reinterpret_cast<const longlong2*>(cp + blk);
  const longlong2 a = __ldg(p), b = __ldg(p + 1);
  return LL4{a.x, a.y, b.x, b.y};
}

template <typename T>
__device__ __forceinline__ T pick4(int i, T a, T b, T c, T d) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// The FM index as the walk reads it, in index type T; l2 holds L2[0..3] of
// the index (a kernel loads them once with load_l2).
template <typename T>
struct FmWalk {
  const typename CpRow<T>::type* occ_cp;  // (n_blocks,) checkpoint rows
  const uint4* bwt4;     // (n_blocks * 2,): a block's eight BWT words
  const T* sa_samples;   // every 32nd row's text position
  T primary;
  T l2[4];
};

template <typename T>
__device__ __forceinline__ void load_l2(FmWalk<T>& fm, const T* __restrict__ L2) {
#pragma unroll
  for (int c = 0; c < 4; ++c) fm.l2[c] = __ldg(L2 + c);
}

// bwt_invPsi(k): the row of the text position before row k's; row `primary`
// maps to row 0.
template <typename T>
__device__ __forceinline__ T inv_psi_row(const FmWalk<T>& fm, T k) {
  // occ4 counts up to kk; bwt_char reads row x = k - (k > primary), which is
  // kk wherever k != primary (and row primary maps to 0 whatever it reads)
  const T kk = k - (k >= fm.primary ? 1 : 0);
  const size_t blk = static_cast<size_t>(kk >> 7);
  const typename CpRow<T>::type cp = load_cp(fm.occ_cp, blk);
  const uint4 a = __ldg(fm.bwt4 + 2 * blk), b = __ldg(fm.bwt4 + 2 * blk + 1);
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int low = static_cast<int>(kk & 0x7F);
  const int jk = low >> 4;
  const int shift = (~low & 0xF) << 1;
  unsigned wk = w[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) wk = j == jk ? w[j] : wk;
  const int c = (wk >> shift) & 3;
  // the block's bases up to kk that are c: one bit a base at the low bit of
  // its pair, the bases past kk masked off
  const unsigned part = ~((1u << shift) - 1u) & kM55;
  int n = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned m = j < jk ? kM55 : j == jk ? part : 0u;
    const unsigned lo = (c & 1) ? w[j] : ~w[j];
    const unsigned hi = (c & 2) ? w[j] >> 1 : ~(w[j] >> 1);
    n += __popc(lo & hi & m);
  }
  const T nk = pick4(c, fm.l2[0], fm.l2[1], fm.l2[2], fm.l2[3]) + pick4(c, cp.x, cp.y, cp.z, cp.w) +
               n;
  return k == fm.primary ? T(0) : nk;
}

// The walk of row k, cut after max_steps steps: steps + sa_samples[k >> 5]
// of the row it stopped at, and `done` whether that row is a sample.
template <typename T>
__device__ __forceinline__ T sa_walk_row(const FmWalk<T>& fm, T k, int max_steps, bool& done) {
  int steps = 0;
  while ((k & 31) != 0 && steps < max_steps) {
    k = inv_psi_row(fm, k);
    ++steps;
  }
  done = (k & 31) == 0;
  return static_cast<T>(steps) + __ldg(fm.sa_samples + static_cast<size_t>(k >> kSaIntvLog2));
}

}  // namespace
