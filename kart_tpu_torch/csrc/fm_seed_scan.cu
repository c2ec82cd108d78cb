// FM-index seeding scans for Hopper (sm_90a): FastMode (seed_scan_kernel, a
// group of lanes per read) and SensitiveMode (fm_extend_kernel and
// fm_chase_kernel, at the end of this file: every start of a read extended in
// parallel, then one thread a read chains the extensions).
//
// Replaces kart_tpu/ops/fm_search.py::seed_scan_impl together with occ4,
// occ4_from, _count4_word and _occ4_pair_replicated: the jnp FM stepper that
// XLA ran as l_max+1 uniform batched steps.  The plain PyTorch version is
// kart_tpu_torch/ops/fm_search.py::seed_scan_plain; the output is the same
// packed (B, 1 + 4*max_seeds) row per read in the index type:
//   [n_seeds | rpos[max_seeds] | slen[max_seeds] | k0[max_seeds] | freq[max_seeds]]
//
// The FastMode kernel is also a template on the index accessor
// (fm_index.cuh): FlatIndex for the replicated index, and ShardedIndex for
// the block-sharded one where one device holds every shard
// (kart_sharded_seed_scan), which replaces kart_tpu/parallel/
// sharded_index.py::sharded_seed_scan with its sharded_occ4_pair lookups: the
// same loop, each step's blocks resolved through the shard table, so the
// whole scan is one launch where the host stepped it (l_max + 1 steps of a
// lookup a shard, a sum and a step).  Its plain version is
// parallel/sharded_index.py::resident_seed_scan_plain.
//
// Every kernel here is a template on the index type T: int below 2**31 text
// bases, long long above (human scale), where the checkpoint counts, the
// interval bounds and the packed rows are 64-bit and the BWT words stay
// 32-bit.
//
// What bounds it on this card: a chain, not bytes.  Every base of a read is
// one backward step whose two occ4 lookups (both ends of the SA interval)
// depend on the step before, so a read costs about l_max dependent index
// accesses whatever the batch; the reads, the seed rows and the index rows
// touched are a few MB.  The design therefore makes a step short and runs
// many reads at once:
//   - a group of 16 lanes owns a read and shares the eight words of a
//     128-base BWT block: lanes 0-7 take the interval's lower end and lanes
//     8-15 its upper end, lane j loading word j of its end's block, so the
//     eight lanes of an end ask for one 32-byte sector together (both ends
//     for the same one once the interval is narrower than a block).  Each
//     lane masks and counts its word into four byte-wide counts of one
//     register, three shuffles add the eight words, a fourth swaps the two
//     ends.  The two checkpoint rows are one 16-byte broadcast load each,
//     started beside the word loads, so a step waits for one load;
//   - 2,048 lanes are 1,024 warps, eight an SM, so one read's chain
//     overlaps the others'.  A step costs a warp some 200 operations, which
//     bounds a batch of many thousand real reads (fewer lanes a read would
//     serve that one better; the mapper hands over no such batch);
//   - the read's codes are loaded once, coalesced, into shared memory as
//     bytes; the seed row is built in shared memory and written once,
//     coalesced and zero-filled; L2[] is read once into registers;
//   - a group leaves the loop when its read can start no further seed, so
//     pad lanes (rlen 0) only write their zero row.
// Every lane of a group carries the same search state, so no lane has to be
// told the outcome of a step, and every shuffle is executed by all 32 lanes
// of the warp whatever their groups are doing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"
#include "window.cuh"

namespace {

constexpr int kOccThr = 50;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;
constexpr int kGroup = 16;                     // lanes a read
constexpr int kPerBlock = kThreads / kGroup;   // reads a block
constexpr size_t kMaxSmem = 232448;            // a block's shared memory on sm_90

// A SensitiveMode outcome (length | min(x2, 63) << 5, x0), or (-run, 0) for
// a run of ambiguous bases: int2, or longlong2 where x0 is 64-bit.
template <typename T>
struct ExtOf;
template <>
struct ExtOf<int> {
  using type = int2;
};
template <>
struct ExtOf<long long> {
  using type = longlong2;
};

// Per-code counts of one 32-bit BWT word (16 bases of 2 bits), one byte each:
// code c in bits 8c..8c+7.
__device__ __forceinline__ unsigned count4_packed(unsigned w) {
  const unsigned nw = ~w;
  return __popc((nw >> 1) & nw & kM55) | (__popc((nw >> 1) & w & kM55) << 8) |
         (__popc((w >> 1) & nw & kM55) << 16) | (__popc((w >> 1) & w & kM55) << 24);
}

// One lane's share of occ4(k) (kk is k less the primary shift): the counts of
// word wj of k's block (its eight words at `words`), bases past k masked out
// (they read as code 0 and are taken off again), nothing for the words past
// k.
template <typename T>
__device__ __forceinline__ unsigned word_counts(const unsigned* __restrict__ words, T kk, int wj) {
  const int jk = static_cast<int>(kk & 0x7F) >> 4;
  if (wj > jk) return 0;
  unsigned w = __ldg(words + wj);
  if (wj == jk) w &= ~((1u << ((~static_cast<int>(kk) & 0xF) << 1)) - 1u);
  unsigned cnt = count4_packed(w);
  if (wj == jk) cnt -= ~static_cast<int>(kk) & 0xF;
  return cnt;
}

// occ4(k) less its checkpoint row, the four counts one byte each, summed over
// the eight lanes that share the block's words; a block holds 128 bases, so
// the byte-wide sums cannot carry.  Every lane of the warp calls this; `on`
// says whether the lane's read takes a step.
template <typename T>
__device__ __forceinline__ unsigned block_counts(const unsigned* __restrict__ words, bool on, T kk,
                                                 int wj) {
  unsigned v = on ? word_counts(words, kk, wj) : 0;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// Shared memory of a block: what the accessor stages (the shard table of a
// sharded index, nothing for the replicated one), then per read the seed row
// (row_len T) and the read's codes as bytes (code_words ints, even for a
// long long row).
template <typename T, typename Ix>
__global__ void __launch_bounds__(kThreads)
seed_scan_kernel(Ix ix, const T* __restrict__ L2, T primary,
                 const int* __restrict__ reads, const int* __restrict__ rlens,
                 int B, int l_max, int min_seed_len, int max_seeds, int code_words,
                 T* __restrict__ out) {
  extern __shared__ int smem[];
  int* const reads_smem = ix.stage(smem);
  constexpr int kWords = sizeof(T) / sizeof(int);  // ints a row entry
  const int row_len = 1 + 4 * max_seeds;
  const int g = threadIdx.x / kGroup;  // the read of this block
  const int j = threadIdx.x % kGroup;  // the lane of its group
  const int end = j / 8;               // 0 the lower interval end, 1 the upper
  const int wj = j % 8;                // the lane's word of a BWT block
  const int b = blockIdx.x * kPerBlock + g;
  const bool valid = b < B;
  T* row = reinterpret_cast<T*>(reads_smem + g * (row_len * kWords + code_words));
  unsigned char* codes = reinterpret_cast<unsigned char*>(row + row_len);

  const T l2_0 = __ldg(L2), l2_1 = __ldg(L2 + 1), l2_2 = __ldg(L2 + 2), l2_3 = __ldg(L2 + 3),
          l2_4 = __ldg(L2 + 4);
  // a seed can start at p only while p < last_start
  const int last_start = valid ? __ldg(rlens + b) - min_seed_len : 0;
  for (int k = j; k < row_len; k += kGroup) row[k] = 0;
  if (last_start > 0) {
    const int* read = reads + static_cast<size_t>(b) * l_max;
    for (int k = j; k < l_max; k += kGroup) {
      const int c = __ldg(read + k);
      codes[k] = static_cast<unsigned char>(c > 3 ? 4 : c);
    }
  }
  __syncwarp();

  bool active = false;
  int start = 0, n_seeds = 0;
  T x0 = 0, x1 = 0, x2 = 0;
  // p == l_max reads an extra ambiguous column, so the last extension of
  // every read ends, and emits, inside the loop
  for (int p = 0;; ++p) {
    const bool live = p <= l_max && (active || p < last_start);
    if (!__any_sync(kFull, live)) break;
    const int c = (live && p < l_max) ? codes[p] : 4;
    const bool amb = c > 3;
    const int cs = amb ? 3 : c;
    const bool extend = live && active && !amb;

    // occ4 at both ends of the interval: the checkpoint rows, and the eight
    // words' counts, which a lane sums at its end before the ends swap
    T kka = 0, kkb = 0;
    typename CpRow<T>::type cpk{}, cpl{};
    const unsigned* words = nullptr;  // the eight words of this lane's end's block
    if (extend) {
      const T ka = x1 - 1, kb = ka + x2;
      kka = ka - (ka >= primary);
      kkb = kb - (kb >= primary);
      const BlockRef<T> bk = ix.block(kka), bl = ix.block(kkb);
      cpk = load_cp(bk.cp, 0);
      cpl = load_cp(bl.cp, 0);
      words = reinterpret_cast<const unsigned*>(end ? bl.bwt4 : bk.bwt4);
    }
    const unsigned mine = block_counts(words, extend, end ? kkb : kka, wj);
    const unsigned other = __shfl_xor_sync(kFull, mine, 8);
    const unsigned ck = end ? other : mine, cl = end ? mine : other;

    bool ext_fail = true;
    T nx0 = 0, nx1 = 0, nx2 = 0;
    if (extend) {
      const T tk0 = cpk.x + (ck & 0xFF), tk1 = cpk.y + ((ck >> 8) & 0xFF),
              tk2 = cpk.z + ((ck >> 16) & 0xFF), tk3 = cpk.w + (ck >> 24);
      const T tl0 = cpl.x + (cl & 0xFF), tl1 = cpl.y + ((cl >> 8) & 0xFF),
              tl2 = cpl.z + ((cl >> 16) & 0xFF), tl3 = cpl.w + (cl >> 24);
      const int i = 3 - cs;  // complement base
      const T s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary));
      const T s2 = s3 + (tl3 - tk3);
      const T s1 = s2 + (tl2 - tk2);
      const T s0 = s1 + (tl1 - tk1);
      const T tki = pick4(i, tk0, tk1, tk2, tk3);
      const T tli = pick4(i, tl0, tl1, tl2, tl3);
      nx0 = pick4(i, s0, s1, s2, s3);
      nx1 = pick4(i, l2_0, l2_1, l2_2, l2_3) + 1 + tki;
      nx2 = tli - tki;
      ext_fail = nx2 == 0;
    }

    if (live && active && ext_fail) {
      const int length = p - start;
      if (length >= min_seed_len && x2 <= kOccThr) {
        // past max_seeds the record is dropped, and counted
        if (n_seeds < max_seeds && j < 4)
          row[1 + j * max_seeds + n_seeds] = pick4<T>(j, start, length, x0, x2);
        ++n_seeds;
      }
    }

    const bool cont = extend && !ext_fail;
    const bool can_start = live && !active && !amb && p < last_start;
    if (cont) {
      x0 = nx0;
      x1 = nx1;
      x2 = nx2;
    } else if (can_start) {
      start = p;
      x0 = pick4(cs, l2_0, l2_1, l2_2, l2_3) + 1;
      x1 = pick4(3 - cs, l2_0, l2_1, l2_2, l2_3) + 1;
      x2 = pick4(cs, l2_1, l2_2, l2_3, l2_4) - pick4(cs, l2_0, l2_1, l2_2, l2_3);
    }
    active = cont || can_start;
  }

  if (j == 0) row[0] = n_seeds;
  __syncwarp();
  if (valid) {
    T* dst = out + static_cast<size_t>(b) * row_len;
    for (int k = j; k < row_len; k += kGroup) dst[k] = row[k];
  }
}

// SensitiveMode (PacBio) scan: replaces kart_tpu/ops/fm_search.py::
// sensitive_scan_impl, a while-loop with a position per lane.  The plain
// PyTorch version is ops/fm_search.py::sensitive_scan_plain; the output has
// seed_scan's layout.  A trip extends a read's interval by the base at p, or
// ends the extension: on an ambiguous base, at stop = min(start + 30, rlen),
// or on an empty interval.  A seed of MinSeed bases and at most 50
// occurrences is recorded, and the next extension starts at p in the same
// trip; a failed one sends p back to start + MinSeed.  Seeds past max_seeds
// are dropped without being counted, and the loop stops after max_trips
// trips whatever is left, as the JAX loop does.
//
// An extension that starts at s is a function of s alone (the read's bases
// s .. min(s + 30, rlen) and the index): only the choice of the next start is
// serial.  So the scan runs in two parts:
//   fm_extend_kernel  one thread per (read, start s < rlen - MinSeed): the
//             windowed extension from s, at most 29 dependent occ4 pairs,
//             each thread counting the eight words of a BWT block itself (two
//             16-byte loads a block, the block loaded once when both ends of
//             the interval lie in it).  It stores (length, min(x2, 63), x0),
//             8 bytes, or for an ambiguous base the run of ambiguous bases
//             from s (at most 31), which the chase steps over at once.  The
//             many starts of a read are in flight together across the card;
//   fm_chase_kernel   a warp per read replays the loop's rules over the
//             stored extensions: trips counted (an extension from s costs
//             length trips before its end's trip), records, rewinds to
//             s + MinSeed, the seed cap and the trip limit.  It reads them in
//             windows of 64 (two coalesced loads), which serve some four
//             extensions each, so its chain is about rlen / 50 dependent
//             loads rather than one an extension.
// The extensions of a batch are evaluated in tiles of whole reads that fit
// the caller's scratch.
// What bounds them on this card: not bytes (the index stays in L2, and a
// read's outcomes are 8 bytes a base) but dependent loads.  The extension
// pass is a chain of up to 29 occ4 pairs a start; spread over the card,
// thousands of such chains are in flight at once where the serial loop ran
// one a read.  The chase's chain is the window loads of its longest read.
constexpr int kWin = 30;       // an extension's window, bases
constexpr int kAmbRun = 31;    // longest run of ambiguous bases one entry steps over
constexpr int kExtThreads = 128;
constexpr int kChaseThreads = 128;
constexpr int kChaseReads = kChaseThreads / 32;  // a warp a read

template <typename T>
__global__ void __launch_bounds__(kExtThreads)
fm_extend_kernel(const typename CpRow<T>::type* __restrict__ occ_cp,
                 const uint4* __restrict__ bwt4, const T* __restrict__ L2, T primary,
                 const int* __restrict__ reads, const int* __restrict__ rlens, int b0, int nb,
                 int width, int min_seed_len, typename ExtOf<T>::type* __restrict__ ext) {
  using E = typename ExtOf<T>::type;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nb * width) return;
  const int b = b0 + (int)(i / width), s = (int)(i % width);
  const int rlen = __ldg(rlens + b);
  const int end = min(rlen - min_seed_len, width);  // starts lie below it
  if (s >= end) return;
  const int* read = reads + (size_t)b * width;
  const int c = __ldg(read + s);
  if (c > 3) {
    int k = 1;
    while (k < kAmbRun && s + k < end && __ldg(read + s + k) > 3) ++k;
    ext[i] = E{-k, 0};
    return;
  }
  const T l2_0 = __ldg(L2), l2_1 = __ldg(L2 + 1), l2_2 = __ldg(L2 + 2), l2_3 = __ldg(L2 + 3),
          l2_4 = __ldg(L2 + 4);
  T x0 = pick4(c, l2_0, l2_1, l2_2, l2_3) + 1;
  T x1 = pick4(3 - c, l2_0, l2_1, l2_2, l2_3) + 1;
  T x2 = pick4(c, l2_1, l2_2, l2_3, l2_4) - pick4(c, l2_0, l2_1, l2_2, l2_3);
  const int stop = min(s + kWin, rlen);
  int p = s + 1;
  for (; p < stop; ++p) {
    const int cp = p < width ? __ldg(read + p) : 4;
    if (cp > 3) break;
    const T ka = x1 - 1, kb = ka + x2;
    const T kka = ka - (ka >= primary), kkb = kb - (kb >= primary);
    const T blka = kka >> 7, blkb = kkb >> 7;
    const typename CpRow<T>::type cpa = load_cp(occ_cp, blka);
    const uint4 wa0 = __ldg(bwt4 + 2 * blka), wa1 = __ldg(bwt4 + 2 * blka + 1);
    typename CpRow<T>::type cpb = cpa;
    uint4 wb0 = wa0, wb1 = wa1;
    if (blkb != blka) {
      cpb = load_cp(occ_cp, blkb);
      wb0 = __ldg(bwt4 + 2 * blkb);
      wb1 = __ldg(bwt4 + 2 * blkb + 1);
    }
    const auto tk = occ4_words(cpa, wa0, wa1, kka), tl = occ4_words(cpb, wb0, wb1, kkb);
    const int ci = 3 - cp;  // complement base
    const T s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary));
    const T s2 = s3 + (tl.w - tk.w);
    const T s1 = s2 + (tl.z - tk.z);
    const T s0 = s1 + (tl.y - tk.y);
    const T tki = pick4(ci, tk.x, tk.y, tk.z, tk.w);
    const T nx2 = pick4(ci, tl.x, tl.y, tl.z, tl.w) - tki;
    if (nx2 == 0) break;
    x0 = pick4(ci, s0, s1, s2, s3);
    x1 = pick4(ci, l2_0, l2_1, l2_2, l2_3) + 1 + tki;
    x2 = nx2;
  }
  ext[i] = E{(p - s) | (static_cast<int>(min(x2, T(63))) << 5), x0};
}

// A warp per read: every lane carries the same state, lanes 0-3 store a
// seed's four fields.
template <typename T>
__global__ void __launch_bounds__(kChaseThreads)
fm_chase_kernel(const typename ExtOf<T>::type* __restrict__ ext, const int* __restrict__ rlens,
                int b0, int nb, int width, int min_seed_len, int max_seeds, int max_trips,
                T* __restrict__ out) {
  using E = typename ExtOf<T>::type;
  const int bl = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int j = threadIdx.x & 31;
  if (bl >= nb) return;  // the whole warp
  const int b = b0 + bl;
  const int end = min(__ldg(rlens + b) - min_seed_len, width);
  const E* e = ext + (size_t)bl * width;
  T* row = out + (size_t)b * (1 + 4 * max_seeds);
  WindowOf<E> w;
  int n = 0, t = 0, p = 0;  // seeds, trips run, scan position
  while (p < end && t < max_trips) {
    E v = window_at(w, e, end, p);
    if (v.x < 0) {  // ambiguous bases: one idle trip each
      p -= static_cast<int>(v.x);
      t -= static_cast<int>(v.x);
      continue;
    }
    // an extension starts at p in trip t; it ends in trip t + length
    int s = p;
    for (;;) {
      const int len = static_cast<int>(v.x) & 31, x2 = static_cast<int>(v.x) >> 5;
      t += len;
      if (t >= max_trips) break;  // cut before it ends: not recorded
      if (len < min_seed_len || x2 > kOccThr) {  // a failed seed: rewind
        p = s + min_seed_len;
        ++t;
        break;
      }
      if (n < max_seeds) {
        if (j < 4) row[1 + j * max_seeds + n] = pick4<T>(j, s, len, v.y, x2);
        ++n;
      }
      // the next extension starts at the seed's end in the same trip, if it can
      p = s + len;
      if (p < end) {
        v = window_at(w, e, end, p);
        if (v.x >= 0) {
          s = p;
          continue;
        }
      }
      ++p;
      ++t;
      break;
    }
  }
  if (j == 0) row[0] = n;
}

template <typename T, typename Ix>
int launch_seed_scan(const Ix& ix, int n_shards, const void* L2, T primary, const void* reads,
                     const void* rlens, int B, int l_max, int min_seed_len, int max_seeds,
                     void* out, void* stream) {
  if (B <= 0) return 0;
  // a long long row starts on 8 bytes: an even count of code words
  constexpr int kWords = sizeof(T) / sizeof(int);
  const int code_words = (l_max / 4 + kWords) / kWords * kWords;
  const size_t smem = Ix::smem_bytes(n_shards) +
      sizeof(int) * kPerBlock * ((1 + 4 * static_cast<size_t>(max_seeds)) * kWords + code_words);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        seed_scan_kernel<T, Ix>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  seed_scan_kernel<T, Ix><<<(B + kPerBlock - 1) / kPerBlock, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      ix, static_cast<const T*>(L2), primary, static_cast<const int*>(reads),
      static_cast<const int*>(rlens), B, l_max, min_seed_len, max_seeds, code_words,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flat_seed_scan(const void* occ_cp, const void* bwt_words, const void* L2, T primary,
                   const void* reads, const void* rlens, int B, int l_max, int min_seed_len,
                   int max_seeds, void* out, void* stream) {
  FlatIndex<T> ix;
  ix.occ_cp = static_cast<const typename CpRow<T>::type*>(occ_cp);
  ix.bwt4 = static_cast<const uint4*>(bwt_words);
  ix.sa_samples = nullptr;
  return launch_seed_scan<T>(ix, 0, L2, primary, reads, rlens, B, l_max, min_seed_len, max_seeds,
                             out, stream);
}

template <typename T>
int sharded_seed_scan(const void* table, int n_shards, long long nb_local, const void* L2,
                      T primary, const void* reads, const void* rlens, int B, int l_max,
                      int min_seed_len, int max_seeds, void* out, void* stream) {
  ShardedIndex<T> ix;
  ix.table = static_cast<const ShardSlabs<T>*>(table);
  ix.n_shards = n_shards;
  ix.set_blocks(static_cast<unsigned>(nb_local));
  ix.nsamp_local = 1;  // the scan reads no sample
  return launch_seed_scan<T>(ix, n_shards, L2, primary, reads, rlens, B, l_max, min_seed_len,
                             max_seeds, out, stream);
}

template <typename T>
int launch_sensitive_scan(const void* occ_cp, const void* bwt_words, const void* L2, T primary,
                          const void* reads, const void* rlens, int B, int width,
                          int min_seed_len, int max_seeds, int max_trips, void* ext,
                          long long ext_cap, void* out, void* stream) {
  if (B <= 0) return 0;
  if (width <= 0 || ext_cap < width) return static_cast<int>(cudaErrorInvalidValue);
  using E = typename ExtOf<T>::type;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(
      out, 0, sizeof(T) * static_cast<size_t>(B) * (1 + 4 * static_cast<size_t>(max_seeds)), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long fit = ext_cap / width;  // reads a tile
  const int tile = fit < B ? static_cast<int>(fit) : B;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int nb = min(tile, B - b0);
    const long long n = static_cast<long long>(nb) * width;
    fm_extend_kernel<T><<<static_cast<unsigned>((n + kExtThreads - 1) / kExtThreads), kExtThreads,
                          0, st>>>(
        static_cast<const typename CpRow<T>::type*>(occ_cp), static_cast<const uint4*>(bwt_words),
        static_cast<const T*>(L2), primary, static_cast<const int*>(reads),
        static_cast<const int*>(rlens), b0, nb, width, min_seed_len, static_cast<E*>(ext));
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    fm_chase_kernel<T><<<(nb + kChaseReads - 1) / kChaseReads, kChaseThreads, 0, st>>>(
        static_cast<const E*>(ext), static_cast<const int*>(rlens), b0, nb, width, min_seed_len,
        max_seeds, max_trips, static_cast<T*>(out));
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

}  // namespace

// Plain C entries for ctypes, one an index type (the _i64 ones: occ_cp, L2,
// primary and out 64-bit).  Pointers are device pointers; occ_cp and
// bwt_words must be 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue where a block's reads of
// l_max bases and their seed rows exceed its shared memory.
extern "C" int kart_fm_seed_scan(const void* occ_cp, const void* bwt_words,
                                 const void* L2, int primary, const void* reads,
                                 const void* rlens, int B, int l_max,
                                 int min_seed_len, int max_seeds, void* out,
                                 void* stream) {
  return flat_seed_scan<int>(occ_cp, bwt_words, L2, primary, reads, rlens, B, l_max,
                             min_seed_len, max_seeds, out, stream);
}

extern "C" int kart_fm_seed_scan_i64(const void* occ_cp, const void* bwt_words,
                                     const void* L2, long long primary, const void* reads,
                                     const void* rlens, int B, int l_max,
                                     int min_seed_len, int max_seeds, void* out,
                                     void* stream) {
  return flat_seed_scan<long long>(occ_cp, bwt_words, L2, primary, reads, rlens, B, l_max,
                                   min_seed_len, max_seeds, out, stream);
}

// The FastMode scan on the block-sharded index, every shard on this device
// (the resident scan of parallel/sharded_index.py): table (n_shards, 4)
// 64-bit words, shard s's occ_cp, bwt_words, sa_samples and sa_full slab
// pointers (occ_cp and bwt_words 16-byte aligned, none of the first three
// null; the scan reads neither SA), nb_local blocks a slab;
// the rest as kart_fm_seed_scan's.  The table goes into the block's shared
// memory before the reads.
extern "C" int kart_sharded_seed_scan(const void* table, int n_shards, long long nb_local,
                                      const void* L2, int primary, const void* reads,
                                      const void* rlens, int B, int l_max, int min_seed_len,
                                      int max_seeds, void* out, void* stream) {
  return sharded_seed_scan<int>(table, n_shards, nb_local, L2, primary, reads, rlens, B, l_max,
                                min_seed_len, max_seeds, out, stream);
}

extern "C" int kart_sharded_seed_scan_i64(const void* table, int n_shards, long long nb_local,
                                          const void* L2, long long primary, const void* reads,
                                          const void* rlens, int B, int l_max, int min_seed_len,
                                          int max_seeds, void* out, void* stream) {
  return sharded_seed_scan<long long>(table, n_shards, nb_local, L2, primary, reads, rlens, B,
                                      l_max, min_seed_len, max_seeds, out, stream);
}

// SensitiveMode scan.  reads: (B, width) int32 codes; out: (B, 1 +
// 4*max_seeds) of the index type, zeroed here; max_trips: the trip limit of
// the loop; ext: scratch of ext_cap entries (int2, or longlong2 for the _i64
// entry), one a base of every read of a tile.  One memset, then per tile of
// ext_cap / width reads the extension and the chase launches, on one stream.
// Returns the first CUDA error, or cudaErrorInvalidValue where one read's
// width exceeds the scratch.
extern "C" int kart_fm_sensitive_scan(const void* occ_cp, const void* bwt_words,
                                      const void* L2, int primary, const void* reads,
                                      const void* rlens, int B, int width, int min_seed_len,
                                      int max_seeds, int max_trips, void* ext, long long ext_cap,
                                      void* out, void* stream) {
  return launch_sensitive_scan<int>(occ_cp, bwt_words, L2, primary, reads, rlens, B, width,
                                    min_seed_len, max_seeds, max_trips, ext, ext_cap, out, stream);
}

extern "C" int kart_fm_sensitive_scan_i64(const void* occ_cp, const void* bwt_words,
                                          const void* L2, long long primary, const void* reads,
                                          const void* rlens, int B, int width, int min_seed_len,
                                          int max_seeds, int max_trips, void* ext,
                                          long long ext_cap, void* out, void* stream) {
  return launch_sensitive_scan<long long>(occ_cp, bwt_words, L2, primary, reads, rlens, B, width,
                                          min_seed_len, max_seeds, max_trips, ext, ext_cap, out,
                                          stream);
}
