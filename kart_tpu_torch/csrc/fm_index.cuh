// The FM index on the card, as the port's kernels read it: a block's
// checkpoint row (load_cp), and the sampled-SA walk of one SA row (bwt_sa,
// reference src/BWT_Index/bwt.c:101-123 and src/bwt_search.cpp:128-138):
// inverse-Psi steps until the row is a multiple of 32, whose text position
// the sampled SA holds, then that position plus the steps taken.
// fm_seed_scan.cu reads the checkpoint rows; sa_walk.cu walks rows;
// sharded_fm.cu takes inverse-Psi steps and occ4 through the shard table,
// and it and resolve_pack.cu read the split full or sampled SA through it
// (ShardedSa).  T
// is the index type: int below 2**31 text bases, long long above; block
// numbers are 32-bit in both accessors.
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
// row of four counts, then the next row: c = bwt_char(row) from the block's
// word at the row, and occ(row, c), the checkpoint's count of c plus the
// c's among the block's bases up to the row.  A walk of n steps is a chain
// of n such rounds, which hit L2 at the sizes the port maps, and a long
// walk's tail is one thread whose warp issues in order: what a step costs
// beyond its load is the instructions from the loads' first use to the next
// row's address.  clock64 stamps (tools/stamp_walk.py, csrc/stamp_walk.cu)
// set the step's design (inv_psi_at): no branch on the loaded values, since
// the compiler had sunk the checkpoint's load into the branch of k !=
// primary (two round trips a step); c from a tree of three selects; the
// words muxed a pair at a time into their bases' low and high bits beside
// it; c's bases two LOP3s and one popcount a pair.  That took fewer
// instructions after the loads than the first design's chain of seven
// selects and eight popcounts that wait for c, than c first with one
// popcount a pair of words and a mask a word, and than counting all four
// codes beside c (occ4_words' twelve popcounts).  Through the shard table a
// step first picks the owner (a multiply by a reciprocal and a read of the
// table in shared memory).

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

// The replicated index: block b at offset b of each array.  Block numbers
// are 32-bit (kernels.py refuses an index of 2**39 text rows or more).
template <typename T>
struct FlatIndex {
  const typename CpRow<T>::type* occ_cp;  // (n_blocks,) checkpoint rows
  const uint4* bwt4;                      // (n_blocks * 2,): a block's eight BWT words
  const T* sa_samples;                    // every 32nd row's text position

  static __host__ __device__ size_t smem_bytes(int) { return 0; }
  __device__ __forceinline__ int* stage(int* smem) { return smem; }
  __device__ __forceinline__ BlockRef<T> block(T kk) const {
    const unsigned b = static_cast<unsigned>(kk >> 7);
    return {occ_cp + b, bwt4 + 2 * static_cast<size_t>(b)};
  }
  __device__ __forceinline__ T sample(T k) const {
    return __ldg(sa_samples + static_cast<size_t>(k >> kSaIntvLog2));
  }
};

// A row of the shard table: one shard's slabs on the launching device, or
// null pointers where the shard lies on another device (sa_full also in the
// sampled SA mode, where no shard holds the full SA).
template <typename T>
struct ShardSlabs {
  const typename CpRow<T>::type* occ_cp;  // blocks [s * nb_local, (s + 1) * nb_local)
  const uint4* bwt4;
  const T* sa_samples;                    // sampled rows [s * nsamp_local, ...)
  const T* sa_full;                       // full-SA rows [s * ns_local, ...)
};

// A kernel's copy of the shard table in shared memory: every thread of the
// block calls this before any returns.  Returns the copy.
template <typename T>
__device__ __forceinline__ const ShardSlabs<T>* stage_table(const ShardSlabs<T>* table, int n,
                                                            int* smem) {
  ShardSlabs<T>* s = reinterpret_cast<ShardSlabs<T>*>(smem);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = table[i];
  __syncthreads();
  return s;
}

template <typename T>
__host__ __device__ inline size_t table_smem_bytes(int n) {
  return (sizeof(ShardSlabs<T>) * n + 15) / 16 * 16;
}

// ceil(2**64 / d), or 0 where d is 1: q * recip >> 64 is q / d exactly for
// q and d below 2**32 (the error term q * (recip * d - 2**64) stays below
// 2**64), and q / d or one more for any q below 2**64.
__host__ __device__ inline unsigned long long reciprocal(unsigned long long d) {
  return d > 1 ? ~0ull / d + 1 : 0;
}

// The block-sharded index through its shard table: block b lies in shard
// b / nb_local, at b % nb_local of its slab; the sample of row k in shard
// (k >> 5) / nsamp_local.  Block numbers and sample rows are taken as 32-bit
// (the wrappers refuse an index of 2**37 text bases or more).  The block's
// owner, on every step's dependent path, is a multiply by a reciprocal
// (set_blocks) rather than a division: for a 32-bit b and d >= 2, b * ceil(
// 2**64 / d) >> 64 is b / d exactly (the error term b * (ceil(2**64 / d) *
// d - 2**64) stays below 2**64).  A kernel first copies the table into
// shared memory (stage, which every thread of the block calls before any
// returns), so the owner's pointers are one shared-memory read away.
template <typename T>
struct ShardedIndex {
  const ShardSlabs<T>* table;  // (n_shards,): device memory, then shared memory
  int n_shards;
  unsigned nb_local, nsamp_local;
  unsigned long long nb_recip;  // ceil(2**64 / nb_local), 0 where nb_local is 1

  __host__ void set_blocks(unsigned nb) {
    nb_local = nb;
    nb_recip = reciprocal(nb);
  }

  static __host__ __device__ size_t smem_bytes(int n) { return table_smem_bytes<T>(n); }
  __device__ __forceinline__ int* stage(int* smem) {
    table = stage_table(table, n_shards, smem);
    return smem + smem_bytes(n_shards) / sizeof(int);
  }
  __device__ __forceinline__ unsigned shard_of(unsigned b) const {
    return nb_recip ? static_cast<unsigned>(__umul64hi(b, nb_recip)) : b;
  }
  __device__ __forceinline__ unsigned owner(T kk) const {
    return shard_of(static_cast<unsigned>(kk >> 7));
  }
  __device__ __forceinline__ BlockRef<T> block(T kk) const {
    const unsigned b = static_cast<unsigned>(kk >> 7);
    const unsigned s = shard_of(b);
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

// One column of the shard table as a split array: the full SA (ns_local
// rows a slab) or the sampled SA (nsamp_local).  Row q lies in shard q /
// n_local, at q % n_local of its slab.  The owner is a multiply by the
// reciprocal, exact for 32-bit rows (T int); an int64 index's rows reach
// 2**37, where the product is q / n_local or one more and a multiply and a
// compare take the one back (two steps; a 64-bit division is a long
// software sequence on this card).  Like ShardedIndex it stages the table in
// shared memory.
template <typename T>
struct ShardedSa {
  const ShardSlabs<T>* table;  // device memory, then shared memory
  int n_shards;
  bool samples;                // the sa_samples column, else sa_full
  unsigned long long n_local, recip;

  __host__ void set_rows(unsigned long long n) {
    n_local = n;
    recip = reciprocal(n);
  }
  static __host__ __device__ size_t smem_bytes(int n) { return table_smem_bytes<T>(n); }
  __device__ __forceinline__ void stage(int* smem) { table = stage_table(table, n_shards, smem); }
  __device__ __forceinline__ unsigned long long owner(unsigned long long q) const {
    if (!recip) return q;
    unsigned long long s = __umul64hi(q, recip);
    if (sizeof(T) > 4 && s * n_local > q) --s;
    return s;
  }
  // the slab of shard s, null where the table does not hold it
  __device__ __forceinline__ const T* slab(unsigned long long s) const {
    return s < static_cast<unsigned long long>(n_shards)
               ? (samples ? table[s].sa_samples : table[s].sa_full)
               : nullptr;
  }
  // row q of the array where the table holds its owner, else 0
  __device__ __forceinline__ T at(T q) const {
    const unsigned long long r = static_cast<unsigned long long>(q), s = owner(r);
    const T* p = slab(s);
    return p ? __ldg(p + (r - s * n_local)) : T(0);
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

// A block as one step reads it: its checkpoint row and its eight BWT words.
template <typename T>
struct Block {
  typename CpRow<T>::type cp;
  uint4 a, b;
};

template <typename T>
__device__ __forceinline__ Block<T> load_block(BlockRef<T> r) {
  return {load_cp(r.cp, 0), __ldg(r.bwt4), __ldg(r.bwt4 + 1)};
}

// The word that holds bases jk * 16.. of a block's eight: a tree of selects.
__device__ __forceinline__ unsigned word_at(const unsigned (&w)[8], int jk) {
  const unsigned u01 = (jk & 1) ? w[1] : w[0], u23 = (jk & 1) ? w[3] : w[2];
  const unsigned u45 = (jk & 1) ? w[5] : w[4], u67 = (jk & 1) ? w[7] : w[6];
  const unsigned u03 = (jk & 2) ? u23 : u01, u47 = (jk & 2) ? u67 : u45;
  return (jk & 4) ? u47 : u03;
}

// The masks of a block's bases up to the one at `low` (0..127), a pair of
// words a mask: word 2p's bases at the even bits, word 2p+1's at the odd.
__device__ __forceinline__ void pair_masks(int low, unsigned (&mp)[4]) {
  const int jk = low >> 4, jp = jk >> 1;
  const unsigned part = ~((1u << ((~low & 0xF) << 1)) - 1u) & kM55;
  const unsigned pm = (jk & 1) ? (kM55 | (part << 1)) : part;
#pragma unroll
  for (int p = 0; p < 4; ++p) mp[p] = p < jp ? ~0u : p == jp ? pm : 0u;
}

// bwt_invPsi(k) from the loaded block d that holds kk, k less the primary
// shift; row `primary` maps to row 0.  Each pair of words is muxed into
// its bases' low bits and high bits (independent of c, so beside c's
// select); then c's bases of a pair are two LOP3s and a popcount under the
// pair's mask.  Row `primary` is cleared by an AND, not a branch, so every
// load of the step is needed on every path.
template <typename T, typename Ix>
__device__ __forceinline__ T inv_psi_at(const FmWalk<T, Ix>& fm, T k, T kk, const Block<T>& d) {
  const unsigned w[8] = {d.a.x, d.a.y, d.a.z, d.a.w, d.b.x, d.b.y, d.b.z, d.b.w};
  const int low = static_cast<int>(kk & 0x7F);
  const int jk = low >> 4;
  unsigned mp[4];
  pair_masks(low, mp);
  const T b0 = fm.l2[0] + d.cp.x, b1 = fm.l2[1] + d.cp.y, b2 = fm.l2[2] + d.cp.z,
          b3 = fm.l2[3] + d.cp.w;
  unsigned lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] = (w[2 * q] & kM55) | ((w[2 * q + 1] << 1) & ~kM55);
    hi[q] = ((w[2 * q] >> 1) & kM55) | (w[2 * q + 1] & ~kM55);
  }
  const int c = (word_at(w, jk) >> ((~low & 0xF) << 1)) & 3;
  // all ones where c's low (high) bit is 0: the bases whose bit differs
  const unsigned x0 = (c & 1) - 1u, x1 = ((c >> 1) & 1) - 1u;
  int n = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) n += __popc((lo[q] ^ x0) & (hi[q] ^ x1) & mp[q]);
  return (pick4(c, b0, b1, b2, b3) + n) & -static_cast<T>(k != fm.primary);
}

// bwt_invPsi(k): the row of the text position before row k's; row `primary`
// maps to row 0.
template <typename T, typename Ix>
__device__ __forceinline__ T inv_psi_row(const FmWalk<T, Ix>& fm, T k) {
  // occ4 counts up to kk; bwt_char reads row x = k - (k > primary), which is
  // kk wherever k != primary (and row primary maps to 0 whatever it reads)
  const T kk = k - (k >= fm.primary ? 1 : 0);
  return inv_psi_at(fm, k, kk, load_block(fm.ix.block(kk)));
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
