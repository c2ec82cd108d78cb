// The PosDiff sort of the resolved occurrence stream for Hopper (sm_90a).
//
// Replaces kart_tpu/parallel/dp.py::_sorted_occurrences (dp.py:115), the jnp
// kernel of the multi-device front half that scatters the flat resolved
// stream (cnts, meta, gpos) back to (B, s_occ) slots a read and sorts each
// read's slots by (posdiff, rpos): a cumsum, a searchsorted of every stream
// entry, a scatter and two composed stable argsorts.  The plain PyTorch
// version is kart_tpu_torch/parallel/dp.py::sorted_occurrences_plain; the
// outputs are the same six arrays: n_occ (B,) int32, rp, ln (B, S) int32, gp
// (B, S) in gpos's type, pd (B, S) int32 and present (B, S) bytes.
//
// The rules, per read b.  offs[b] is the exclusive prefix sum of max(cnts, 0)
// (a flagged read counts 0, so entries it left in the stream go to the reads
// after it, as in the jnp kernel).  The read takes the stream entries j in
// [offs[b], offs[b] + min(max(cnts[b], 0), S)) with j < H; an entry is valid
// when its slen field (meta >> 16) & 0xFFFF is not 0xFFFF (a slen of 32768
// sets meta's sign bit, so the test is never meta >= 0).  A valid entry has
// rp = meta & 0xFFFF, ln its slen and pd = gpos - rp in gpos's type; every
// other slot holds (pd, rp, ln, gp) = (big, 2**31 - 1, 0, 0), big the largest
// value of gpos's type.  The slots are sorted by (pd, rp, slot), which is
// what the two composed stable argsorts give.  present is pd < big, taken
// before pd is narrowed to int32 (the low 32 bits: an int64 big becomes -1).
// The offsets wrap as int32 does.
//
// One launch.  A block of 256 threads takes a tile of reads (128 where S <=
// 16, else 64), in the order of a ticket it draws (so that the blocks
// before it have started).  Its first warp loads the tile's counts
// (coalesced, a run of reads a lane), scans them with shuffles and finds
// the tile's prefix by a single-pass decoupled look-back, as resolve_pack.cu's
// totals pass: it publishes the tile's sum in a state word (flag << 32 |
// value), reads the words of the 256 tiles before it at once (eight loads a
// lane in flight), sums them back to the nearest inclusive prefix (another
// round only where none is among them), publishes its own, and leaves the
// tile's offsets and counts in shared memory.  Then the whole block sorts
// the tile: a group of G lanes a read (G = 16 where S <= 16, two reads a
// warp, else 32), lane l slot l, the tile's reads in rounds of 256 / G; each
// thread first loads meta and gpos of all its rounds (8 reads' entries in
// flight), so the dependent chain (offset, then the entries) is paid once a
// block, not once a read.  Each slot's (pd, rp) goes to its read's row in
// shared memory; after one __syncwarp (a read's group lies in one warp) a
// valid slot is ranked against the read's entries only (its first min(tot,
// S) slots: two on average on the main path, where 16 compares a slot
// with shuffles took most of a 9 us pass), and an invalid slot, which sorts
// after every valid one, takes its rank from two ballots' popcounts, as
// n_occ does; each lane writes its values at its rank (a read's row is
// written by its group at once).  The state words reset themselves: a block
// adds one to a done count once its look-back has read every word it
// needs, and the block that brings it to the grid's size zeroes the words,
// the ticket and the count, so every call and every replay of a captured
// graph starts from zeros with no memset.  The scratch is the caller's,
// made zero once.
//
// What bounds it on this card: the bytes, cnts and the entries the reads
// take in (about 0.7 MB at B 32,000, H 128,000, int32) and the (B, 16) rows
// out (8.7 MB): some 2.8 us at 3.35 TB/s.  The launch's latency and the
// look-back's round trips (one, or two) come on top.  A design with a
// one-block scan of every count ran it on one SM while the others waited,
// and a second launch waited for it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileReads = 64;  // reads a block at 32 slots a read, twice that at 16
constexpr int kLookWords = 8;   // state words a lane of the look-back reads a round
constexpr int kBig32 = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// State words of the look-back: flag << 32 | value.
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own sum
constexpr unsigned long long kInclusive = 2ull << 32;  // the sum up to and with the tile

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

// The exclusive prefix of tile `tile`, by the first warp: a round reads the
// words of the 32 * kLookWords tiles before `look` (kLookWords loads a lane
// in flight, then each one read again until its flag is set), sums them back
// to the nearest inclusive one and stops there, else goes on to the window
// before (tiles before tile 0 count as an inclusive 0).  Every lane returns
// the prefix.
__device__ __forceinline__ unsigned look_back(const unsigned long long* words, int tile,
                                              int lane) {
  unsigned excl = 0;
  for (int look = tile - 1; look >= 0; look -= 32 * kLookWords) {
    unsigned long long w[kLookWords];
#pragma unroll
    for (int j = 0; j < kLookWords; ++j) {
      const int idx = look - j * 32 - lane;
      w[j] = idx >= 0 ? load_word(words + idx) : kInclusive;
    }
#pragma unroll
    for (int j = 0; j < kLookWords; ++j) {
      const int idx = look - j * 32 - lane;
      while ((w[j] >> 32) == 0) w[j] = load_word(words + idx);
    }
    // the nearest inclusive word, by its distance j * 32 + lane from look
    int near = 32 * kLookWords;
#pragma unroll
    for (int j = kLookWords - 1; j >= 0; --j)
      if ((w[j] >> 32) == 2) near = j * 32 + lane;
    near = __reduce_min_sync(kFull, near);
    unsigned part = 0;
#pragma unroll
    for (int j = 0; j < kLookWords; ++j) part += j * 32 + lane <= near ? (unsigned)w[j] : 0u;
    excl += (unsigned)__reduce_add_sync(kFull, (int)part);
    if (near < 32 * kLookWords) break;
  }
  return excl;
}

// state[0] the ticket, state[1] the done count, state[2 + t] tile t's word:
// all zero at the launch, and again at its end.  kTile reads a block, a
// multiple of 32 (each lane of the first warp scans kTile / 32).
template <typename P, int kG, int kTile>
__global__ void __launch_bounds__(kThreads) sorted_occ_kernel(
    const int* __restrict__ cnts, int B, const int* __restrict__ meta, const P* __restrict__ gpos,
    long long H, int S, P big, unsigned long long* state, int* __restrict__ n_occ,
    int* __restrict__ rp_out, int* __restrict__ ln_out, P* __restrict__ gp_out,
    int* __restrict__ pd_out, unsigned char* __restrict__ present_out) {
  constexpr int kReadsARound = kThreads / kG;
  constexpr int kRounds = kTile / kReadsARound;
  constexpr int kPerLane = kTile / 32;
  __shared__ int s_off[kTile], s_tot[kTile];
  __shared__ int s_tile, s_last;
  __shared__ P s_pd[kTile * kG];  // each slot's (pd, rp), a read's row of kG
  __shared__ int s_rp[kTile * kG];
  const int t = threadIdx.x, lane = t & 31;
  unsigned long long* words = state + 2;
  if (t == 0) s_tile = (int)atomicAdd(state, 1ull);
  __syncthreads();
  const int tile = s_tile;
  const int row0 = tile * kTile;

  if (t < 32) {
    // the tile's counts, kPerLane consecutive reads a lane, and their scan
    unsigned c[kPerLane], sum = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int b = row0 + lane * kPerLane + q;
      c[q] = b < B ? (unsigned)max(__ldg(cnts + b), 0) : 0u;
      sum += c[q];
    }
    unsigned incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = (unsigned)__shfl_up_sync(kFull, (int)incl, off);
      if (lane >= off) incl += u;
    }
    const unsigned aggregate = (unsigned)__shfl_sync(kFull, (int)incl, 31);
    if (lane == 0) atomicExch(words + tile, (tile ? kAggregate : kInclusive) | aggregate);
    const unsigned excl = look_back(words, tile, lane);
    if (lane == 0 && tile) atomicExch(words + tile, kInclusive | (excl + aggregate));
    unsigned run = excl + incl - sum;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      s_off[lane * kPerLane + q] = (int)run;
      s_tot[lane * kPerLane + q] = (int)c[q];
      run += c[q];
    }
    // every word this tile reads has been read: count it done; the last
    // tile to get here resets the state for the next call
    if (lane == 0) {
      __threadfence();
      s_last = atomicAdd(state + 1, 1ull) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (unsigned i = t; i < gridDim.x + 2; i += kThreads) state[i] = 0;
  }

  // the sort: every load of the thread's rounds first; each slot's (pd, rp)
  // into shared memory; then each lane ranks its slot against its read's
  // row there
  const int l = t & (kG - 1);
  int m[kRounds];
  P g[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kReadsARound + t / kG;  // the read's place in the tile
    const long long j = (long long)s_off[i] + l;
    const bool in = row0 + i < B && l < S && l < s_tot[i] && j >= 0 && j < H;
    m[r] = in ? __ldg(meta + j) : -1;
    g[r] = in ? __ldg(gpos + j) : P(0);
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kReadsARound + t / kG;
    const bool valid = ((m[r] >> 16) & 0xFFFF) != 0xFFFF;
    s_rp[i * kG + l] = valid ? m[r] & 0xFFFF : kBig32;
    s_pd[i * kG + l] = valid ? static_cast<P>(static_cast<unsigned long long>(g[r]) -
                                              static_cast<unsigned long long>(m[r] & 0xFFFF))
                             : big;
  }
  __syncwarp();  // a read's row is written and read by its own group
  const int base = lane & ~(kG - 1);  // the group's first lane in the warp
  const unsigned group = kG == 32 ? kFull : ((1u << kG) - 1) << base;
  const unsigned below = (1u << lane) - 1;  // the lanes before this one
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kReadsARound + t / kG;
    const int b = row0 + i;
    const P* row_pd = s_pd + i * kG;
    const int* row_rp = s_rp + i * kG;
    const P pd = row_pd[l];
    const int rp = row_rp[l];
    const int len = (m[r] >> 16) & 0xFFFF;
    const bool valid = len != 0xFFFF, present = pd < big;
    const unsigned vm = __ballot_sync(kFull, l < S && valid) & group;
    const unsigned pm = __ballot_sync(kFull, l < S && present) & group;
    // an invalid slot, (big, 2**31 - 1), sorts after every valid one and
    // after the invalid slots before it; a valid one is ranked against the
    // read's entries (its first min(tot, S) slots), one row read a slot
    int rank = __popc(vm) + l - __popc(vm & below);
    if (valid) {
      rank = 0;
      const int n = min(s_tot[i], S);
      for (int k = 0; k < n; ++k) {
        const P pk = row_pd[k];
        const int rk = row_rp[k];
        rank += (pk < pd) | ((pk == pd) & ((rk < rp) | ((rk == rp) & (k < l))));
      }
    }
    if (b < B && l < S) {
      const size_t at = (size_t)b * S + rank;
      rp_out[at] = rp;
      ln_out[at] = valid ? len : 0;
      gp_out[at] = valid ? g[r] : P(0);
      pd_out[at] = static_cast<int>(static_cast<unsigned>(static_cast<unsigned long long>(pd)));
      present_out[at] = present;
      if (l == 0) n_occ[b] = __popc(pm);
    }
  }
}

template <typename P, int kG, int kTile = kG == 16 ? 2 * kTileReads : kTileReads>
void launch_sort(const void* cnts, int B, const void* meta, const void* gpos, long long H, int S,
                 P big, void* state, void* n_occ, void* rp, void* ln, void* gp, void* pd,
                 void* present, cudaStream_t st) {
  const int grid = (B + kTile - 1) / kTile;
  sorted_occ_kernel<P, kG, kTile><<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(cnts), B, static_cast<const int*>(meta),
      static_cast<const P*>(gpos), H, S, big, static_cast<unsigned long long*>(state),
      static_cast<int*>(n_occ), static_cast<int*>(rp), static_cast<int*>(ln),
      static_cast<P*>(gp), static_cast<int*>(pd), static_cast<unsigned char*>(present));
}

template <typename P>
int sorted_occurrences(const void* cnts, int B, const void* meta, const void* gpos, long long H,
                       int S, P big, void* state, void* n_occ, void* rp, void* ln, void* gp,
                       void* pd, void* present, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 16) {
    launch_sort<P, 16>(cnts, B, meta, gpos, H, S, big, state, n_occ, rp, ln, gp, pd, present, st);
  } else {
    launch_sort<P, 32>(cnts, B, meta, gpos, H, S, big, state, n_occ, rp, ln, gp, pd, present, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 8-byte words of state that kart_sorted_occurrences needs for B reads.
extern "C" int kart_sorted_occ_state_words(int B) { return 2 + (B + kTileReads - 1) / kTileReads; }

// cnts (B,) int32, meta (H,) int32, gpos (H,) int32 (or int64 for _i64) on
// the card; state: kart_sorted_occ_state_words(B) 8-byte words, zero at the
// first call (each call leaves them zero; calls that run at once need their
// own); outputs n_occ (B,) int32, rp, ln, pd (B, S) int32, gp (B, S) of
// gpos's type, present (B, S) bytes; 1 <= S <= 32.
extern "C" int kart_sorted_occurrences(const void* cnts, int B, const void* meta, const void* gpos,
                                       long long H, int S, void* state, void* n_occ, void* rp,
                                       void* ln, void* gp, void* pd, void* present, void* stream) {
  return sorted_occurrences<int>(cnts, B, meta, gpos, H, S, kBig32, state, n_occ, rp, ln, gp, pd,
                                 present, stream);
}

extern "C" int kart_sorted_occurrences_i64(const void* cnts, int B, const void* meta,
                                           const void* gpos, long long H, int S, void* state,
                                           void* n_occ, void* rp, void* ln, void* gp, void* pd,
                                           void* present, void* stream) {
  return sorted_occurrences<long long>(cnts, B, meta, gpos, H, S, 0x7FFFFFFFFFFFFFFFLL, state,
                                       n_occ, rp, ln, gp, pd, present, stream);
}
