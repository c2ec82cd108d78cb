// The FM index on the card, as the port's kernels read it: a block's
// checkpoint row (load_cp), and the sampled-SA walk of one SA row (bwt_sa,
// reference src/BWT_Index/bwt.c:101-123 and src/bwt_search.cpp:128-138):
// inverse-Psi steps until the row is a multiple of 32, whose text position
// the sampled SA holds, then that position plus the steps taken.
// fm_seed_scan.cu reads the checkpoint rows; sa_walk.cu walks rows;
// sharded_fm.cu takes inverse-Psi steps and occ4 through the shard table.  T
// is the index type: int below 2**31 text bases, long long above; the int
// instance of the walk does no 64-bit arithmetic but pointer offsets.
//
// Where a block lies is an accessor's business (template parameter Ix):
// FlatIndex, the replicated index (one array of checkpoint rows, one of BWT
// words, one of samples), or ShardedIndex, the block-sharded index of
// parallel/sharded_index.py through its shard table (a row a shard: the
// pointers of the shard's slabs, null for a shard on another device).  The
// scan and the walk are one template each over the accessor, so the
// replicated and the sharded index run the same loop.
//
// One step of the walk is one round of independent loads: the row's
// 128-base BWT block (eight words, one 32-byte sector) and its checkpoint
// row of four counts.  The block's word at the row gives the base c =
// bwt_char(row); occ(row, c) is the checkpoint's count of c plus the c's
// among the block's bases up to the row, counted with one popcount a word.
// So a walk of n steps is a chain of n dependent loads, which hit L2 at the
// sizes the port maps.  Through the shard table a step first picks the
// owner (an integer division and a read of the table in shared memory).

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

// Where the block that holds a row lies: its checkpoint row and its eight
// BWT words (two 16-byte halves).
template <typename T>
struct BlockRef {
  const typename CpRow<T>::type* cp;
  const uint4* bwt4;
};

// The replicated index: block b at offset b of each array.
template <typename T>
struct FlatIndex {
  const typename CpRow<T>::type* occ_cp;  // (n_blocks,) checkpoint rows
  const uint4* bwt4;                      // (n_blocks * 2,): a block's eight BWT words
  const T* sa_samples;                    // every 32nd row's text position

  static __host__ __device__ size_t smem_bytes(int) { return 0; }
  __device__ __forceinline__ int* stage(int* smem) { return smem; }
  __device__ __forceinline__ BlockRef<T> block(T kk) const {
    const size_t b = static_cast<size_t>(kk >> 7);
    return {occ_cp + b, bwt4 + 2 * b};
  }
  __device__ __forceinline__ T sample(T k) const {
    return __ldg(sa_samples + static_cast<size_t>(k >> kSaIntvLog2));
  }
};

// A row of the shard table: one shard's slabs on the launching device, or
// null pointers where the shard lies on another device.
template <typename T>
struct ShardSlabs {
  const typename CpRow<T>::type* occ_cp;  // blocks [s * nb_local, (s + 1) * nb_local)
  const uint4* bwt4;
  const T* sa_samples;                    // sampled rows [s * nsamp_local, ...)
};

// The block-sharded index through its shard table: block b lies in shard
// b / nb_local, at b % nb_local of its slab; the sample of row k in shard
// (k >> 5) / nsamp_local.  Block numbers and sample rows are taken as 32-bit
// (the wrappers refuse an index of 2**37 text bases or more).  A kernel
// first copies the table into shared memory (stage, which every thread of
// the block calls before any returns), so the owner's pointers are one
// shared-memory read away.
template <typename T>
struct ShardedIndex {
  const ShardSlabs<T>* table;  // (n_shards,): device memory, then shared memory
  int n_shards;
  unsigned nb_local, nsamp_local;

  static __host__ __device__ size_t smem_bytes(int n) {
    return (sizeof(ShardSlabs<T>) * n + 15) / 16 * 16;
  }
  __device__ __forceinline__ int* stage(int* smem) {
    ShardSlabs<T>* s = reinterpret_cast<ShardSlabs<T>*>(smem);
    for (int i = threadIdx.x; i < n_shards; i += blockDim.x) s[i] = table[i];
    __syncthreads();
    table = s;
    return smem + smem_bytes(n_shards) / sizeof(int);
  }
  __device__ __forceinline__ unsigned owner(T kk) const {
    return static_cast<unsigned>(kk >> 7) / nb_local;
  }
  __device__ __forceinline__ BlockRef<T> block(T kk) const {
    const unsigned b = static_cast<unsigned>(kk >> 7);
    const unsigned s = b / nb_local;
    const size_t local = b - s * nb_local;
    return {table[s].occ_cp + local, table[s].bwt4 + 2 * local};
  }
  // whether the table holds the slab of kk's block (the step kernels, which
  // answer zeros for the rows of another device's shards)
  __device__ __forceinline__ bool holds(T kk) const {
    const unsigned s = owner(kk);
    return s < static_cast<unsigned>(n_shards) && table[s].occ_cp != nullptr;
  }
  __device__ __forceinline__ T sample(T k) const {
    const unsigned r = static_cast<unsigned>(k >> kSaIntvLog2);
    const unsigned s = r / nsamp_local;
    return __ldg(table[s].sa_samples + (r - s * nsamp_local));
  }
};

// The FM index as the walk reads it, in index type T through accessor Ix;
// l2 holds L2[0..3] of the index (a kernel loads them once with load_l2).
template <typename T, typename Ix>
struct FmWalk {
  Ix ix;
  T primary;
  T l2[4];
};

template <typename T, typename Ix>
__device__ __forceinline__ void load_l2(FmWalk<T, Ix>& fm, const T* __restrict__ L2) {
#pragma unroll
  for (int c = 0; c < 4; ++c) fm.l2[c] = __ldg(L2 + c);
}

// bwt_invPsi(k) from the block b that holds kk, k less the primary shift;
// row `primary` maps to row 0.
template <typename T, typename Ix>
__device__ __forceinline__ T inv_psi_at(const FmWalk<T, Ix>& fm, T k, T kk, BlockRef<T> blk) {
  const typename CpRow<T>::type cp = load_cp(blk.cp, 0);
  const uint4 a = __ldg(blk.bwt4), b = __ldg(blk.bwt4 + 1);
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

// bwt_invPsi(k): the row of the text position before row k's; row `primary`
// maps to row 0.
template <typename T, typename Ix>
__device__ __forceinline__ T inv_psi_row(const FmWalk<T, Ix>& fm, T k) {
  // occ4 counts up to kk; bwt_char reads row x = k - (k > primary), which is
  // kk wherever k != primary (and row primary maps to 0 whatever it reads)
  const T kk = k - (k >= fm.primary ? 1 : 0);
  return inv_psi_at(fm, k, kk, fm.ix.block(kk));
}

// occ4(kk) from the block's checkpoint row and its eight BWT words, all in
// this thread (fm_seed_scan.cu's extension, sharded_fm.cu's occ4): the codes
// of the bases up to kk (the bases past it masked off) counted with three
// popcounts a pair of words per code; code 3's count is the rest.
template <typename C, typename T>
__device__ __forceinline__ C occ4_words(C cp, uint4 a, uint4 b, T kk) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int jk = static_cast<int>(kk & 0x7F) >> 4;
  const unsigned part = ~((1u << ((~static_cast<int>(kk) & 0xF) << 1)) - 1u) & kM55;
  int c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const unsigned m0 = j < jk ? kM55 : j == jk ? part : 0u;
    const unsigned m1 = j + 1 < jk ? kM55 : j + 1 == jk ? part : 0u;
    const unsigned lo0 = w[j], hi0 = w[j] >> 1, lo1 = w[j + 1], hi1 = w[j + 1] >> 1;
    // one bit per base, at the low bit of its 2-bit group; the odd word's
    // bits shifted into the high bits
    c0 += __popc((~(lo0 | hi0) & m0) | ((~(lo1 | hi1) & m1) << 1));
    c1 += __popc((lo0 & ~hi0 & m0) | ((lo1 & ~hi1 & m1) << 1));
    c2 += __popc((hi0 & ~lo0 & m0) | ((hi1 & ~lo1 & m1) << 1));
  }
  const int n = static_cast<int>(kk & 0x7F) + 1;  // bases of the block up to kk
  C r;
  r.x = cp.x + c0;
  r.y = cp.y + c1;
  r.z = cp.z + c2;
  r.w = cp.w + (n - c0 - c1 - c2);
  return r;
}

// The walk of row k, cut after max_steps steps: steps + the sample of the
// row it stopped at (sa_samples[k >> 5]), and `done` whether that row is a
// sample.
template <typename T, typename Ix>
__device__ __forceinline__ T sa_walk_row(const FmWalk<T, Ix>& fm, T k, int max_steps, bool& done) {
  int steps = 0;
  while ((k & 31) != 0 && steps < max_steps) {
    k = inv_psi_row(fm, k);
    ++steps;
  }
  done = (k & 31) == 0;
  return static_cast<T>(steps) + fm.ix.sample(k);
}

}  // namespace
