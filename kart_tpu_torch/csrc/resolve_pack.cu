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
// Two launches on one stream:
//   totals  one block: each read's occurrence count tot (the freqs of its
//           first n_seeds seeds), a block-wide inclusive prefix sum into
//           read_end, and cnts = tot if the read is ok and read_end <= H,
//           else -tot-1 (a read fits whole or not at all, so the reads that
//           do not fit are a suffix);
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
// stream once; the totals pass is one block's serial scan over B reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;

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

__global__ void __launch_bounds__(kScanThreads) totals_kernel(Seeds s, int H, int* read_end,
                                                              int* cnts) {
  __shared__ int part[kScanThreads];
  const int t = threadIdx.x, nt = blockDim.x;
  const int per = (s.B + nt - 1) / nt;
  const int b0 = min(t * per, s.B), b1 = min(b0 + per, s.B);
  int acc = 0;
  for (int b = b0; b < b1; ++b) {
    const int n = n_used(s, b);
    for (int k = 0; k < n; ++k) acc += seed_field(s, b, 3, k);
    read_end[b] = acc;
  }
  part[t] = acc;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  const int base = t ? part[t - 1] : 0;
  int prev = base;
  for (int b = b0; b < b1; ++b) {
    const int end = read_end[b] + base;
    const int tot = end - prev;
    read_end[b] = end;
    const bool ok = (!s.has_ok || s.packed[(size_t)b * s.cols + 1] != 0) && end <= H;
    cnts[b] = ok ? tot : -tot - 1;
    prev = end;
  }
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

// packed: (B, cols) int32 seeds, cols = 1 + has_ok + 4*max_seeds; sa_full:
// the full SA, int32; read_end, cnts: (B,) int32 scratch; out: (B + 2H,) int32,
// or (B/2 + H/2 + H,) with pack16 (B and H even).  Returns
// cudaGetLastError() after the launches.
extern "C" int kart_resolve_pack(const void* packed, int B, int has_ok, int max_seeds,
                                 const void* sa_full, int H, int pack16,
                                 void* read_end, void* cnts, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Seeds s;
  s.packed = static_cast<const int*>(packed);
  s.cols = 1 + (has_ok ? 1 : 0) + 4 * max_seeds;
  s.c_rpos = has_ok ? 2 : 1;
  s.has_ok = has_ok;
  s.S = max_seeds;
  s.B = B;
  if (B > 0) {
    totals_kernel<<<1, kScanThreads, 0, st>>>(s, H, static_cast<int*>(read_end),
                                              static_cast<int*>(cnts));
    cudaError_t err = cudaGetLastError();
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
