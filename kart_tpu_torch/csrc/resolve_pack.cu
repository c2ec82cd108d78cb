// Occurrence expansion, SA resolution and stream packing for Hopper
// (sm_90a): from a packed seed array to the stream the host downloads.
//
// Replaces kart_tpu/ops/resolve.py::expand_resolve with either lookup of
// kart_tpu/ops/pack.py::_resolver (the full-SA gather, or the sampled-SA
// walk fm_search.sa_walk) followed by kart_tpu/ops/pack.py::_pack_stream
// (plain and pack16 layouts, or the (cnts, meta, gpos) arrays of an int64
// index), which XLA ran as cumsums, a repeat, gathers, a while-loop and a
// concatenate.  The plain PyTorch version is kart_tpu_torch/ops/resolve.py::
// resolve_pack_plain (expand_resolve_plain, then pack_stream_plain).  The
// seed array is the funnel's (B, 2 + 4*S) [n_seeds | ok | rpos | slen | k0 |
// freq] or the FM stepper's (B, 1 + 4*S) without the ok column, in the index
// type P (int, or long long for an int64 index).
//
// Through the full SA of an int32 index, a memset and two launches on one
// stream:
//   totals  grid-wide, 256 reads a block.  The block reads its 256 x S tile
//           of freqs with S consecutive threads to a read's row (coalesced
//           within the row, four independent loads a thread in flight) and
//           adds each freq among the read's first n_seeds to the read's
//           occurrence count tot in shared memory; the inclusive
//           prefix sum into read_end is a single-pass chained scan: a block
//           scans its 256 counts with warp shuffles, publishes its aggregate
//           in a state word (flag << 32 | value), looks back over its
//           predecessors' words until it meets an inclusive prefix, and
//           publishes its own.  Blocks take their number from a ticket
//           counter, so a block's predecessors always run before it; the
//           state words are zeroed on the stream before the launch.  cnts =
//           tot if the read is ok and read_end <= H, else -tot-1 (a read
//           fits whole or not at all, so the reads that do not fit are a
//           suffix);
//   emit    one thread per output word: the count words, then the meta
//           words (rpos | slen << 16, or two 16-bit rpos | (slen-1) << 8 in
//           pack16), then gpos.  Stream slot j belongs to the first read
//           whose read_end exceeds j (binary search) and, within it, to the
//           seed whose running freq sum passes j; gpos = sa_full[k0 + off].
//           Slots past the last fitting read hold -1 (pack16 turns a -1 meta
//           into 0xFEFF and wraps counts to 16 bits, as kart_tpu does).
// Through the full SA split over the shards of one device (the resident
// full-SA resolve of parallel/sharded_index.py), the same passes read each
// position from its owner's slab through the shard table (fm_index.cuh's
// ShardedSa: the owner a multiply by a reciprocal, the slab pointer from the
// table staged in shared memory): int32 totals and emit
// (kart_resolve_pack_table), int64 totals, rows and emit
// (kart_resolve_rows_table_i64, kart_resolve_finish_i64).  No gather of the
// split SA is made beside them, no part summed and no position copied.
// Reading the slots back from the prefix sums, rather than scattering each
// read's occurrences, lets a thread own a whole output word, so the pack16
// pairs need no atomics.
//
// Through the sampled SA, or on an int64 index, the positions come from
// passes of their own between totals and emit (kart_resolve_rows, then the
// walk, then kart_resolve_finish; kernels.resolve_pack makes the calls):
//   rows    one thread per stream slot j: its read (or -1 past the last
//           fitting read) and its row k0 + off as above; through an int64
//           full SA it writes gpos[j] = sa_full[row] (or -1) at once;
//   walk    csrc/sa_walk.cu's kernel on the H rows (a slot past the last
//           read walks row 0, a sample, at once), into the positions;
//   flag    one thread per slot: -1 past the last read, and for a slot
//           whose walk max_steps cut, its read's count set to -tot-1 (every
//           such slot of a read writes the same value, so no atomic);
//   emit    the count and meta words only (the positions are in the stream
//           already, int32, or in their own array, int64, with the counts
//           and meta in the 32-bit layout).
// A read's flag is known only once every walk of it has ended, and a pack16
// count word holds two reads, so the flags cannot be written where emit
// writes the count words.  Of the two orders (walk inside emit and flag
// with atomics, then write the counts in a last pass; or walk first, then
// flag, then emit) this takes the second: the walk is the same kernel that
// resolves rows alone, held against its plain version and timed as one;
// no walking thread holds the slot search's registers; and emit reads the
// counts as they finally stand, with no atomics.  It costs three launches
// and 9 to 13 bytes of scratch a slot.  The slot's meta and position stay
// in the stream for a flagged read, as kart_tpu's do.
//
// What bounds it on this card: the emit pass reads about 2H words of
// sa_full at random (H = 96,000 for a 32,000-read group) and writes the
// stream once: about 10 MB in all, so the two launches' latencies and the
// emit pass's dependent chain (binary search, seed walk, sa_full) weigh more
// than the bytes.  Through the sampled SA the walk of the H slots' rows
// bounds the call: its longest walk, some 32 ln H dependent loads that hit
// L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"

namespace {

constexpr int kScanBlock = 256;  // reads (and threads) per block of the totals pass
constexpr int kTileLoads = 4;    // freq loads a thread of the totals pass has in flight

template <typename P>
struct Seeds {
  const P* packed;  // (B, cols)
  int cols;
  int c_rpos;  // first rpos column: 1 (FM stepper) or 2 (funnel)
  int has_ok;
  int S;  // max_seeds
  int B;
};

template <typename P>
__device__ __forceinline__ int n_used(const Seeds<P>& s, int b) {
  return min(max(static_cast<int>(s.packed[(size_t)b * s.cols]), 0), s.S);
}

template <typename P>
__device__ __forceinline__ P seed_field(const Seeds<P>& s, int b, int field, int k) {
  return s.packed[(size_t)b * s.cols + s.c_rpos + field * s.S + k];
}

// The full SA as one array on this device; the other accessor is
// fm_index.cuh's ShardedSa (the full SA through the shard table of every
// shard).  The passes stage an accessor before any thread returns.
template <typename P>
struct FlatSa {
  const P* sa;
  int n_shards = 0;

  static __host__ __device__ size_t smem_bytes(int) { return 0; }
  __device__ __forceinline__ void stage(int*) {}
  __device__ __forceinline__ P at(P row) const { return __ldg(sa + row); }
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// State words of the chained scan: flag << 32 | value.
constexpr unsigned long long kAggregate = 1ull << 32;  // the block's own sum
constexpr unsigned long long kInclusive = 2ull << 32;  // the sum up to and with the block

// state[0] is the ticket counter, state[1 + b] block b's word; all zero at
// the launch.
template <typename P>
__global__ void __launch_bounds__(kScanBlock) totals_kernel(Seeds<P> s, int H,
                                                            unsigned long long* state,
                                                            int* read_end, int* cnts) {
  __shared__ int s_warp[kScanBlock / 32];
  __shared__ int s_bid, s_excl;
  __shared__ int s_n[kScanBlock], s_tot[kScanBlock];  // per read: seeds used, occurrences
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_bid = (int)atomicAdd(state, 1ull);
  __syncthreads();
  const int bid = s_bid;
  unsigned long long* words = state + 1;

  // the block's 256 x S tile of freqs: S consecutive threads to a read's row
  // (coalesced within the row), four independent loads in flight a thread,
  // each added to its read's count in shared memory
  const int c_freq = s.c_rpos + 3 * s.S;
  const int row0 = bid * kScanBlock;
  s_n[t] = row0 + t < s.B ? n_used(s, row0 + t) : 0;
  s_tot[t] = 0;
  __syncthreads();
  const int n_el = kScanBlock * s.S;
  for (int e0 = t; e0 < n_el; e0 += kTileLoads * kScanBlock) {
    int v[kTileLoads], r[kTileLoads];
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) {
      const int e = e0 + j * kScanBlock;
      r[j] = min(e / s.S, kScanBlock - 1);
      const int k = e - r[j] * s.S;
      v[j] = e < n_el && k < s_n[r[j]]
                 ? static_cast<int>(__ldg(s.packed + (size_t)(row0 + r[j]) * s.cols + c_freq + k))
                 : 0;
    }
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j)
      if (v[j]) atomicAdd(s_tot + r[j], v[j]);
  }
  __syncthreads();
  const int tot = s_tot[t];

  // the block's inclusive scan
  int incl = tot;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int aggregate = 0;
  for (int k = 0; k < kScanBlock / 32; ++k) {
    const int v = s_warp[k];
    if (k < warp) incl += v;
    aggregate += v;
  }

  // decoupled look-back by the first warp: lane i reads the word of the
  // block i before the window's nearest; the sum stops at the nearest
  // inclusive prefix (blocks before block 0 count as an inclusive 0)
  if (warp == 0) {
    if (lane == 0) atomicExch(words + bid, (bid ? kAggregate : kInclusive) | (unsigned)aggregate);
    int excl = 0;
    for (int look = bid - 1; look >= 0; look -= 32) {
      const int idx = look - lane;
      unsigned long long w = kInclusive;
      if (idx >= 0) {
        do {
          w = *reinterpret_cast<volatile unsigned long long*>(words + idx);
        } while ((w >> 32) == 0);
      }
      const unsigned full = __ballot_sync(0xFFFFFFFFu, (w >> 32) == 2);
      const int stop = full ? __ffs(full) - 1 : 31;
      excl += warp_sum(lane <= stop ? (int)(unsigned)w : 0);
      if (full) break;
    }
    if (lane == 0) {
      if (bid) atomicExch(words + bid, kInclusive | (unsigned)(excl + aggregate));
      s_excl = excl;
    }
  }
  __syncthreads();

  const int b = bid * kScanBlock + t;
  if (b >= s.B) return;
  const int end = s_excl + incl;
  read_end[b] = end;
  const bool ok = (!s.has_ok || s.packed[(size_t)b * s.cols + 1] != 0) && end <= H;
  cnts[b] = ok ? tot : -tot - 1;
}

// Slot j of the stream: false past the last fitting read; else its read a,
// its seed k and the offset of its row in the seed's SA interval.
template <typename P>
__device__ bool find_slot(const Seeds<P>& s, const int* __restrict__ read_end, int H, int j,
                          int& a, int& k, int& off) {
  if (s.B == 0 || j >= read_end[s.B - 1]) return false;
  int lo = 0, hi = s.B - 1;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (read_end[m] > j) hi = m; else lo = m + 1;
  }
  a = lo;
  if (read_end[a] > H) return false;
  off = j - (a ? read_end[a - 1] : 0);
  const int n = n_used(s, a);
  for (k = 0; k < n; ++k) {
    const int f = static_cast<int>(seed_field(s, a, 3, k));
    if (off < f) return true;
    off -= f;
  }
  return false;  // not reached for non-negative freqs
}

// Slot j of the stream: meta, or gpos through the full SA (an int32
// accessor); -1 for both past the last fitting read.  want_gpos selects
// which one is computed.
template <typename P, typename Sa>
__device__ int slot_value(const Seeds<P>& s, const int* __restrict__ read_end, const Sa& sa,
                          int H, int j, bool want_gpos) {
  int a, k, off;
  if (!find_slot(s, read_end, H, j, a, k, off)) return -1;
  if (!want_gpos)
    return static_cast<int>(seed_field(s, a, 0, k)) | (static_cast<int>(seed_field(s, a, 1, k)) << 16);
  return sa.at(static_cast<int>(seed_field(s, a, 2, k)) + off);
}

__device__ __forceinline__ unsigned meta16(int meta) {
  return (unsigned)((meta & 0xFF) | ((((meta >> 16) & 0xFFFF) - 1) << 8)) & 0xFFFFu;
}

// The read of every slot (-1 past the last fitting read) and its row; with
// `gather` (a full SA, flat or through the shard table) the position itself
// instead of the row.
template <typename P, typename Sa>
__global__ void rows_kernel(Seeds<P> s, const int* __restrict__ read_end, int H, Sa sa,
                            bool gather, P* __restrict__ rows, int* __restrict__ slot_read,
                            P* __restrict__ gpos) {
  extern __shared__ int smem[];
  sa.stage(smem);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= H) return;
  int a, k, off;
  const bool valid = find_slot(s, read_end, H, j, a, k, off);
  slot_read[j] = valid ? a : -1;
  const P row = valid ? seed_field(s, a, 2, k) + off : P(0);
  if (gather)
    gpos[j] = valid ? sa.at(row) : P(-1);
  else
    rows[j] = row;
}

// After the walk: -1 past the last fitting read, and the count of a read
// with a walk that max_steps cut set to -tot-1.
template <typename P>
__global__ void flag_kernel(const int* __restrict__ read_end, const int* __restrict__ slot_read,
                            const unsigned char* __restrict__ done, int H, int* cnts,
                            P* __restrict__ gpos) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= H) return;
  const int a = slot_read[j];
  if (a < 0)
    gpos[j] = -1;
  else if (!done[j])
    cnts[a] = -(read_end[a] - (a ? read_end[a - 1] : 0)) - 1;
}

// The count words, the meta words and, with_gpos (the full SA of an int32
// index, flat or through the shard table), the position words.
template <typename P, typename Sa>
__global__ void emit_kernel(Seeds<P> s, const int* __restrict__ read_end,
                            const int* __restrict__ cnts, Sa sa, int H, int pack16,
                            int with_gpos, int* __restrict__ out) {
  extern __shared__ int smem[];
  sa.stage(smem);
  const int nc = pack16 ? s.B / 2 : s.B;
  const int nm = pack16 ? H / 2 : H;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nc + nm + (with_gpos ? H : 0)) return;
  int v;
  if (w < nc) {
    v = pack16 ? (int)(((unsigned)cnts[2 * w] & 0xFFFFu) | ((unsigned)cnts[2 * w + 1] << 16))
               : cnts[w];
  } else if (w < nc + nm) {
    const int i = w - nc;
    if (pack16) {
      const unsigned m0 = meta16(slot_value(s, read_end, sa, H, 2 * i, false));
      const unsigned m1 = meta16(slot_value(s, read_end, sa, H, 2 * i + 1, false));
      v = (int)(m0 | (m1 << 16));
    } else {
      v = slot_value(s, read_end, sa, H, i, false);
    }
  } else {
    v = slot_value(s, read_end, sa, H, w - nc - nm, true);
  }
  out[w] = v;
}

}  // namespace

// 8-byte words of scan state that kart_resolve_pack needs for B reads.
extern "C" int kart_resolve_scan_words(int B) { return 1 + (B + kScanBlock - 1) / kScanBlock; }

namespace {

constexpr int kThreads = 256;  // of the emit, rows and flag passes

template <typename P>
Seeds<P> seeds_of(const void* packed, int B, int has_ok, int max_seeds) {
  Seeds<P> s;
  s.packed = static_cast<const P*>(packed);
  s.cols = 1 + (has_ok ? 1 : 0) + 4 * max_seeds;
  s.c_rpos = has_ok ? 2 : 1;
  s.has_ok = has_ok;
  s.S = max_seeds;
  s.B = B;
  return s;
}

// The memset and the totals pass.
template <typename P>
cudaError_t totals(const Seeds<P>& s, int H, void* read_end, void* cnts, void* scan_state,
                   cudaStream_t st) {
  if (s.B == 0) return cudaSuccess;
  const int n_blocks = (s.B + kScanBlock - 1) / kScanBlock;
  const cudaError_t err = cudaMemsetAsync(scan_state, 0, (size_t)(1 + n_blocks) * 8, st);
  if (err != cudaSuccess) return err;
  totals_kernel<P><<<n_blocks, kScanBlock, 0, st>>>(
      s, H, static_cast<unsigned long long*>(scan_state), static_cast<int*>(read_end),
      static_cast<int*>(cnts));
  return cudaGetLastError();
}

// The emit pass: the count and meta words and, with_gpos (through an int32
// full SA, sa), the position words.
template <typename P, typename Sa>
cudaError_t emit(const Seeds<P>& s, int H, int pack16, const void* read_end, const void* cnts,
                 const Sa& sa, bool with_gpos, void* out, cudaStream_t st) {
  const long long n_words = (pack16 ? s.B / 2 + H / 2 : s.B + H) + (with_gpos ? (long long)H : 0);
  if (n_words == 0) return cudaSuccess;
  const size_t smem = Sa::smem_bytes(sa.n_shards);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  emit_kernel<P, Sa><<<(unsigned)((n_words + kThreads - 1) / kThreads), kThreads, smem, st>>>(
      s, static_cast<const int*>(read_end), static_cast<const int*>(cnts), sa, H, pack16,
      with_gpos ? 1 : 0, static_cast<int*>(out));
  return cudaGetLastError();
}

// The memset, totals and rows; with `gather` the rows pass writes each
// slot's position through sa, else its row.
template <typename P, typename Sa>
int resolve_rows(const void* packed, int B, int has_ok, int max_seeds, const Sa& sa, bool gather,
                 int H, void* read_end, void* cnts, void* scan_state, void* rows, void* slot_read,
                 void* gpos, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seeds<P> s = seeds_of<P>(packed, B, has_ok, max_seeds);
  cudaError_t err = totals(s, H, read_end, cnts, scan_state, st);
  if (err != cudaSuccess || H == 0) return (int)err;
  const size_t smem = Sa::smem_bytes(sa.n_shards);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  rows_kernel<P, Sa><<<(H + kThreads - 1) / kThreads, kThreads, smem, st>>>(
      s, static_cast<const int*>(read_end), H, sa, gather, static_cast<P*>(rows),
      static_cast<int*>(slot_read), static_cast<P*>(gpos));
  return (int)cudaGetLastError();
}

// The full-SA column of a shard table of every shard, ns_local rows a slab.
template <typename P>
ShardedSa<P> full_sa_table(const void* table, int n_shards, long long ns_local) {
  ShardedSa<P> sa;
  sa.table = static_cast<const ShardSlabs<P>*>(table);
  sa.n_shards = n_shards;
  sa.samples = false;
  sa.set_rows(static_cast<unsigned long long>(ns_local));
  return sa;
}

template <typename P>
int resolve_finish(const void* packed, int B, int has_ok, int max_seeds, int H, int pack16,
                   const void* read_end, void* cnts, const void* slot_read, const void* done,
                   void* gpos, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (done && H > 0) {
    flag_kernel<P><<<(H + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const int*>(read_end), static_cast<const int*>(slot_read),
        static_cast<const unsigned char*>(done), H, static_cast<int*>(cnts),
        static_cast<P*>(gpos));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)emit(seeds_of<P>(packed, B, has_ok, max_seeds), H, pack16, read_end, cnts,
                   FlatSa<int>{nullptr}, false, out, st);
}

}  // namespace

// packed: (B, cols) int32 seeds, cols = 1 + has_ok + 4*max_seeds; sa_full:
// the full SA, int32; read_end, cnts: (B,) int32 scratch; scan_state:
// kart_resolve_scan_words(B) 8-byte words of scratch; out: (B + 2H,) int32,
// or (B/2 + H/2 + H,) with pack16 (B and H even).  Returns the first CUDA
// error, cudaGetLastError() after the launches.
extern "C" int kart_resolve_pack(const void* packed, int B, int has_ok, int max_seeds,
                                 const void* sa_full, int H, int pack16, void* read_end,
                                 void* cnts, void* scan_state, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seeds<int> s = seeds_of<int>(packed, B, has_ok, max_seeds);
  const cudaError_t err = totals(s, H, read_end, cnts, scan_state, st);
  if (err != cudaSuccess) return (int)err;
  return (int)emit(s, H, pack16, read_end, cnts, FlatSa<int>{static_cast<const int*>(sa_full)},
                   true, out, st);
}

// kart_resolve_pack of the FM stepper's seeds (no ok column, the 32-bit
// layout: out (B + 2H,) int32) through the full SA split over the shards of
// this device: table (n_shards, 4) 64-bit words as kart_sharded_occ4's,
// every row's sa_full slab pointer set (int32, ns_local rows a slab).  The
// same memset and two passes, emit reading each position from its owner's
// slab.
extern "C" int kart_resolve_pack_table(const void* packed, int B, int max_seeds,
                                       const void* table, int n_shards, long long ns_local, int H,
                                       void* read_end, void* cnts, void* scan_state, void* out,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seeds<int> s = seeds_of<int>(packed, B, 0, max_seeds);
  const cudaError_t err = totals(s, H, read_end, cnts, scan_state, st);
  if (err != cudaSuccess) return (int)err;
  return (int)emit(s, H, 0, read_end, cnts, full_sa_table<int>(table, n_shards, ns_local), true,
                   out, st);
}

// The passes before the walk (the memset, totals, rows) of a stream that is
// not kart_resolve_pack's: through the sampled SA (sa_full null; rows gets
// each slot's row), or through an int64 full SA (gpos gets each slot's
// position).  packed, read_end, cnts and scan_state as kart_resolve_pack's;
// slot_read: (H,) int32, each slot's read or -1; rows and gpos (H,) of the
// index type (gpos: the stream's last H words for an int32 stream).  The
// _i64 entry takes int64 seeds and positions.
extern "C" int kart_resolve_rows(const void* packed, int B, int has_ok, int max_seeds,
                                 const void* sa_full, int H, void* read_end, void* cnts,
                                 void* scan_state, void* rows, void* slot_read, void* gpos,
                                 void* stream) {
  return resolve_rows<int>(packed, B, has_ok, max_seeds, FlatSa<int>{static_cast<const int*>(sa_full)},
                           sa_full != nullptr, H, read_end, cnts, scan_state, rows, slot_read,
                           gpos, stream);
}

extern "C" int kart_resolve_rows_i64(const void* packed, int B, int has_ok, int max_seeds,
                                     const void* sa_full, int H, void* read_end, void* cnts,
                                     void* scan_state, void* rows, void* slot_read, void* gpos,
                                     void* stream) {
  return resolve_rows<long long>(packed, B, has_ok, max_seeds,
                                 FlatSa<long long>{static_cast<const long long*>(sa_full)},
                                 sa_full != nullptr, H, read_end, cnts, scan_state, rows,
                                 slot_read, gpos, stream);
}

// kart_resolve_rows_i64 of the FM stepper's int64 seeds (no ok column)
// through an int64 full SA split over the shards of this device (table and
// ns_local as kart_resolve_pack_table's): the rows pass writes each slot's
// position from its owner's slab; kart_resolve_finish_i64 without `done`
// then writes the counts and meta words.
extern "C" int kart_resolve_rows_table_i64(const void* packed, int B, int max_seeds,
                                           const void* table, int n_shards, long long ns_local,
                                           int H, void* read_end, void* cnts, void* scan_state,
                                           void* slot_read, void* gpos, void* stream) {
  return resolve_rows<long long>(packed, B, 0, max_seeds,
                                 full_sa_table<long long>(table, n_shards, ns_local), true, H,
                                 read_end, cnts, scan_state, nullptr, slot_read, gpos, stream);
}

// The passes after the walk: with done (the walk's (H,) bytes) the flag
// pass, then emit's count and meta words into out: (B + H,) int32, or (B/2
// + H/2,) with pack16, followed in an int32 stream by the H positions.
extern "C" int kart_resolve_finish(const void* packed, int B, int has_ok, int max_seeds, int H,
                                   int pack16, const void* read_end, void* cnts,
                                   const void* slot_read, const void* done, void* gpos, void* out,
                                   void* stream) {
  return resolve_finish<int>(packed, B, has_ok, max_seeds, H, pack16, read_end, cnts, slot_read,
                             done, gpos, out, stream);
}

extern "C" int kart_resolve_finish_i64(const void* packed, int B, int has_ok, int max_seeds,
                                       int H, const void* read_end, void* cnts,
                                       const void* slot_read, const void* done, void* gpos,
                                       void* out, void* stream) {
  return resolve_finish<long long>(packed, B, has_ok, max_seeds, H, 0, read_end, cnts, slot_read,
                                   done, gpos, out, stream);
}
