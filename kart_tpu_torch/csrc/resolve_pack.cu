// Occurrence expansion, full-SA resolution and stream packing for Hopper
// (sm_90a): from a packed seed array to the one int32 stream the host
// downloads.
//
// Replaces kart_tpu/ops/resolve.py::expand_resolve with the full-SA lookup
// followed by kart_tpu/ops/pack.py::_pack_stream (plain and pack16
// layouts), which XLA ran as cumsums, a repeat, gathers and a concatenate.
// The plain PyTorch version is kart_tpu_torch/ops/resolve.py::
// resolve_pack_plain (expand_resolve_plain, then pack_stream_plain).  The
// seed array is the funnel's (B, 2 + 4*S) [n_seeds | ok | rpos | slen | k0 |
// freq] or the FM stepper's (B, 1 + 4*S) without the ok column.
//
// A memset and two launches on one stream:
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
// Reading the slots back from the prefix sums, rather than scattering each
// read's occurrences, lets a thread own a whole output word, so the pack16
// pairs need no atomics.
//
// What bounds it on this card: the emit pass reads about 2H words of
// sa_full at random (H = 96,000 for a 32,000-read group) and writes the
// stream once: about 10 MB in all, so the two launches' latencies and the
// emit pass's dependent chain (binary search, seed walk, sa_full) weigh more
// than the bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanBlock = 256;  // reads (and threads) per block of the totals pass
constexpr int kTileLoads = 4;    // freq loads a thread of the totals pass has in flight

struct Seeds {
  const int* packed;  // (B, cols)
  int cols;
  int c_rpos;  // first rpos column: 1 (FM stepper) or 2 (funnel)
  int has_ok;
  int S;  // max_seeds
  int B;
};

__device__ __forceinline__ int n_used(const Seeds& s, int b) {
  return min(max(s.packed[(size_t)b * s.cols], 0), s.S);
}

__device__ __forceinline__ int seed_field(const Seeds& s, int b, int field, int k) {
  return s.packed[(size_t)b * s.cols + s.c_rpos + field * s.S + k];
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// State words of the chained scan: flag << 32 | value.
constexpr unsigned long long kAggregate = 1ull << 32;  // the block's own sum
constexpr unsigned long long kInclusive = 2ull << 32;  // the sum up to and with the block

// state[0] is the ticket counter, state[1 + b] block b's word; all zero at
// the launch.
__global__ void __launch_bounds__(kScanBlock) totals_kernel(Seeds s, int H,
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
                 ? __ldg(s.packed + (size_t)(row0 + r[j]) * s.cols + c_freq + k) : 0;
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

// Slot j of the stream: meta and gpos, or -1 for both past the last
// fitting read.  want_gpos selects which one is computed.
__device__ int slot_value(const Seeds& s, const int* __restrict__ read_end,
                          const int* __restrict__ sa_full, int H, int j, bool want_gpos) {
  if (s.B == 0 || j >= read_end[s.B - 1]) return -1;
  int a = 0, b = s.B - 1;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (read_end[m] > j) b = m; else a = m + 1;
  }
  if (read_end[a] > H) return -1;
  int off = j - (a ? read_end[a - 1] : 0);
  const int n = n_used(s, a);
  for (int k = 0; k < n; ++k) {
    const int f = seed_field(s, a, 3, k);
    if (off < f) {
      if (!want_gpos) return seed_field(s, a, 0, k) | (seed_field(s, a, 1, k) << 16);
      return __ldg(sa_full + seed_field(s, a, 2, k) + off);
    }
    off -= f;
  }
  return -1;  // not reached for non-negative freqs
}

__device__ __forceinline__ unsigned meta16(int meta) {
  return (unsigned)((meta & 0xFF) | ((((meta >> 16) & 0xFFFF) - 1) << 8)) & 0xFFFFu;
}

__global__ void emit_kernel(Seeds s, const int* __restrict__ read_end,
                            const int* __restrict__ cnts, const int* __restrict__ sa_full,
                            int H, int pack16, int* __restrict__ out) {
  const int nc = pack16 ? s.B / 2 : s.B;
  const int nm = pack16 ? H / 2 : H;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nc + nm + H) return;
  int v;
  if (w < nc) {
    v = pack16 ? (int)(((unsigned)cnts[2 * w] & 0xFFFFu) | ((unsigned)cnts[2 * w + 1] << 16))
               : cnts[w];
  } else if (w < nc + nm) {
    const int i = w - nc;
    if (pack16) {
      const unsigned m0 = meta16(slot_value(s, read_end, sa_full, H, 2 * i, false));
      const unsigned m1 = meta16(slot_value(s, read_end, sa_full, H, 2 * i + 1, false));
      v = (int)(m0 | (m1 << 16));
    } else {
      v = slot_value(s, read_end, sa_full, H, i, false);
    }
  } else {
    v = slot_value(s, read_end, sa_full, H, w - nc - nm, true);
  }
  out[w] = v;
}

}  // namespace

// 8-byte words of scan state that kart_resolve_pack needs for B reads.
extern "C" int kart_resolve_scan_words(int B) { return 1 + (B + kScanBlock - 1) / kScanBlock; }

// packed: (B, cols) int32 seeds, cols = 1 + has_ok + 4*max_seeds; sa_full:
// the full SA, int32; read_end, cnts: (B,) int32 scratch; scan_state:
// kart_resolve_scan_words(B) 8-byte words of scratch; out: (B + 2H,) int32,
// or (B/2 + H/2 + H,) with pack16 (B and H even).  Returns the first CUDA
// error, cudaGetLastError() after the launches.
extern "C" int kart_resolve_pack(const void* packed, int B, int has_ok, int max_seeds,
                                 const void* sa_full, int H, int pack16, void* read_end,
                                 void* cnts, void* scan_state, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Seeds s;
  s.packed = static_cast<const int*>(packed);
  s.cols = 1 + (has_ok ? 1 : 0) + 4 * max_seeds;
  s.c_rpos = has_ok ? 2 : 1;
  s.has_ok = has_ok;
  s.S = max_seeds;
  s.B = B;
  if (B > 0) {
    const int n_blocks = (B + kScanBlock - 1) / kScanBlock;
    cudaError_t err = cudaMemsetAsync(scan_state, 0, (size_t)(1 + n_blocks) * 8, st);
    if (err != cudaSuccess) return (int)err;
    totals_kernel<<<n_blocks, kScanBlock, 0, st>>>(
        s, H, static_cast<unsigned long long*>(scan_state), static_cast<int*>(read_end),
        static_cast<int*>(cnts));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_words = (pack16 ? B / 2 + H / 2 : B + H) + (long long)H;
  if (n_words == 0) return 0;
  const int threads = 256;
  emit_kernel<<<(unsigned)((n_words + threads - 1) / threads), threads, 0, st>>>(
      s, static_cast<const int*>(read_end), static_cast<const int*>(cnts),
      static_cast<const int*>(sa_full), H, pack16, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
