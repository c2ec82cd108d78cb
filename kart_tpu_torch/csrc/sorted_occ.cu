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
//
// Two launches.  offsets_kernel: one block walks the reads in tiles of
// 8,192 (loaded and stored coalesced through shared memory, a block scan a
// tile; B is a batch of reads, 32,000 at the main path's width, four tiles).  sort_kernel: a group of G lanes a read (G = 16 where S <=
// 16, two reads a warp, else 32), lane l holding slot l in registers; each
// lane counts the slots that sort before its own with G shuffles of (pd, rp)
// and writes its values at that rank, so a read's row is written by its
// group at once, and n_occ is a ballot's popcount.
//
// What bounds it on this card: the bytes, cnts and the stream in (about
// 1.15 MB at B 32,000, H 128,000, int32) and the (B, 16) rows out (8.8 MB);
// the operations are G compares a slot.  A simple kernel that is right: the
// single-block scan runs on one SM while the others wait, which a chained
// scan across blocks (resolve_pack.cu's) would remove.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kPerThread = 8;
constexpr int kTile = kScanThreads * kPerThread;  // reads a tile of the scan: 32 KB of shared memory
constexpr int kSortThreads = 256;
constexpr int kBig32 = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// offs[b] = sum over a < b of max(cnts[a], 0), wrapping as int32 does.  The
// reads go through in tiles of kTile: a coalesced load into shared memory,
// each thread's kPerThread consecutive counts summed, a block scan of the
// threads' sums, the exclusive offsets written back in place and stored
// coalesced; the tile's total carries into the next.
__global__ void __launch_bounds__(kScanThreads) offsets_kernel(const int* __restrict__ cnts, int B,
                                                               int* __restrict__ offs) {
  extern __shared__ unsigned s_tile[];  // kTile
  __shared__ unsigned s_warp[kScanThreads / 32];
  __shared__ unsigned s_carry;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_carry = 0;
  for (int base = 0; base < B; base += kTile) {
    for (int k = 0; k < kPerThread; ++k) {
      const int i = base + k * kScanThreads + t;
      s_tile[k * kScanThreads + t] = i < B ? (unsigned)max(cnts[i], 0) : 0u;
    }
    __syncthreads();
    unsigned v[kPerThread], sum = 0;
    for (int k = 0; k < kPerThread; ++k) {
      v[k] = s_tile[t * kPerThread + k];
      sum += v[k];
    }
    unsigned incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = (unsigned)__shfl_up_sync(kFull, (int)incl, off);
      if (lane >= off) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned run = s_carry + incl - sum;
    for (int w = 0; w < warp; ++w) run += s_warp[w];
    for (int k = 0; k < kPerThread; ++k) {
      s_tile[t * kPerThread + k] = run;
      run += v[k];
    }
    __syncthreads();
    for (int k = 0; k < kPerThread; ++k) {
      const int i = base + k * kScanThreads + t;
      if (i < B) offs[i] = (int)s_tile[k * kScanThreads + t];
    }
    if (t == kScanThreads - 1) s_carry = run;
    __syncthreads();
  }
}

// A group of kG lanes a read, lane l its slot l; every lane of the warp
// reaches every shuffle and the ballot (reads past B included).
template <typename P, int kG>
__global__ void __launch_bounds__(kSortThreads) sort_kernel(
    const int* __restrict__ cnts, const int* __restrict__ offs, int B,
    const int* __restrict__ meta, const P* __restrict__ gpos, long long H, int S, P big,
    int* __restrict__ n_occ, int* __restrict__ rp_out, int* __restrict__ ln_out,
    P* __restrict__ gp_out, int* __restrict__ pd_out, unsigned char* __restrict__ present_out) {
  const long long g = (long long)blockIdx.x * kSortThreads + threadIdx.x;
  const long long b = g / kG;
  const int l = threadIdx.x & (kG - 1);
  const int base = threadIdx.x & 31 & ~(kG - 1);  // the group's first lane in the warp
  P pd = big, gp = 0;
  int rp = kBig32, ln = 0;
  if (b < B && l < S) {
    const int tot = max(cnts[b], 0);
    const long long j = (long long)offs[b] + l;
    if (l < tot && j >= 0 && j < H) {
      const int m = meta[j];
      const int len = (m >> 16) & 0xFFFF;
      if (len != 0xFFFF) {
        rp = m & 0xFFFF;
        ln = len;
        gp = gpos[j];
        pd = static_cast<P>(static_cast<unsigned long long>(gp) - static_cast<unsigned long long>(rp));
      }
    }
  }
  int rank = 0;
  for (int k = 0; k < kG; ++k) {
    const P pk = __shfl_sync(kFull, pd, base + k);
    const int rk = __shfl_sync(kFull, rp, base + k);
    if (k < S && k != l)
      rank += pk < pd || (pk == pd && (rk < rp || (rk == rp && k < l)));
  }
  const bool present = pd < big;
  const unsigned votes = __ballot_sync(kFull, l < S && present);
  if (b >= B || l >= S) return;
  const size_t at = (size_t)b * S + rank;
  rp_out[at] = rp;
  ln_out[at] = ln;
  gp_out[at] = gp;
  pd_out[at] = static_cast<int>(static_cast<unsigned>(static_cast<unsigned long long>(pd)));
  present_out[at] = present;
  if (l == 0) {
    const unsigned group = kG == 32 ? kFull : (((1u << kG) - 1) << base);
    n_occ[b] = __popc(votes & group);
  }
}

template <typename P, int kG>
void launch_sort(const void* cnts, const void* offs, int B, const void* meta, const void* gpos,
                 long long H, int S, P big, void* n_occ, void* rp, void* ln, void* gp, void* pd,
                 void* present, cudaStream_t st) {
  const int grid = (int)(((long long)B * kG + kSortThreads - 1) / kSortThreads);
  sort_kernel<P, kG><<<grid, kSortThreads, 0, st>>>(
      static_cast<const int*>(cnts), static_cast<const int*>(offs), B,
      static_cast<const int*>(meta), static_cast<const P*>(gpos), H, S, big,
      static_cast<int*>(n_occ), static_cast<int*>(rp), static_cast<int*>(ln),
      static_cast<P*>(gp), static_cast<int*>(pd), static_cast<unsigned char*>(present));
}

template <typename P>
int sorted_occurrences(const void* cnts, int B, const void* meta, const void* gpos, long long H,
                       int S, P big, void* offs, void* n_occ, void* rp, void* ln, void* gp,
                       void* pd, void* present, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  offsets_kernel<<<1, kScanThreads, kTile * sizeof(unsigned), st>>>(
      static_cast<const int*>(cnts), B, static_cast<int*>(offs));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S <= 16) {
    launch_sort<P, 16>(cnts, offs, B, meta, gpos, H, S, big, n_occ, rp, ln, gp, pd, present, st);
  } else {
    launch_sort<P, 32>(cnts, offs, B, meta, gpos, H, S, big, n_occ, rp, ln, gp, pd, present, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cnts (B,) int32, meta (H,) int32, gpos (H,) int32 (or int64 for _i64) on
// the card; offs (B,) int32 scratch; outputs n_occ (B,) int32, rp, ln, pd
// (B, S) int32, gp (B, S) of gpos's type, present (B, S) bytes; 1 <= S <= 32.
extern "C" int kart_sorted_occurrences(const void* cnts, int B, const void* meta, const void* gpos,
                                       long long H, int S, void* offs, void* n_occ, void* rp,
                                       void* ln, void* gp, void* pd, void* present, void* stream) {
  return sorted_occurrences<int>(cnts, B, meta, gpos, H, S, kBig32, offs, n_occ, rp, ln, gp, pd,
                                 present, stream);
}

extern "C" int kart_sorted_occurrences_i64(const void* cnts, int B, const void* meta,
                                           const void* gpos, long long H, int S, void* offs,
                                           void* n_occ, void* rp, void* ln, void* gp, void* pd,
                                           void* present, void* stream) {
  return sorted_occurrences<long long>(cnts, B, meta, gpos, H, S, 0x7FFFFFFFFFFFFFFFLL, offs,
                                       n_occ, rp, ln, gp, pd, present, stream);
}
