// FastMode 13-mer funnel for Hopper (sm_90a): 2-bit read unpack plus the
// round loop of the direct-lookup seeding scan, one thread block per slab.
//
// Replaces kart_tpu/ops/pack.py::unpack_reads_device followed by
// kart_tpu/ops/kmer_seed.py::kmer_seed_scan(sensitive=False), whose slab
// body (_kmer_seed_scan_slab with _distance_tables and round_body) XLA ran
// as some twenty batched gathers, cumsums and segment maxima per round.
// The plain PyTorch version is kart_tpu_torch/ops/kmer_seed.py::
// kmer_seed_scan_plain after ops/pack.py::unpack_reads_plain; the output is
// the same packed (B, 2 + 4*max_seeds) int32 row per read:
//   [n_seeds | ok | rpos[S] | slen[S] | k0[S] | freq[S]]
//
// The result depends on the slab: the lanes of one slab share a per-round
// budget of H = hit_budget * slab hits, handed out in lane order by a
// prefix sum, and a lane whose hits do not all fit is flagged for the exact
// FM re-seed.  So one block owns one slab and runs its whole round loop:
//   prologue  ambiguity bits and the read words (ambiguous bases 0) of the
//             slab's rows into global scratch; output rows zeroed;
//   phase A   per lane: skip ambiguous restarts, 13-mer interval
//             [table_lo[km], table_lo[km+1]), hit_cap overflow;
//   scan      block-wide inclusive prefix sum of the hit counts;
//   phase B   per hit j < min(total, H): its lane by binary search over the
//             prefix sums, its text position from sa_full, the LCP of read
//             and text as XOR + count-trailing-zeros over aligned 2-bit
//             words, and two shared-memory atomicMax per lane that equal
//             the two packed segment maxima of the JAX version (an empty
//             lane keeps INT_MIN, as segment_max gives);
//   phase C   per lane: best length, first SA row and freq of the maximiser
//             block, sub-13 restart length from sub_tbl, seed record, advance.
// A flagged lane keeps running with no hits, as in the JAX version, so its
// later seeds are the same.  The loop ends when no lane of the slab is left
// or after `rounds` rounds.
//
// What bounds it on this card: the dependent chain of rounds within a slab
// (about 10-20 rounds of four phases separated by barriers), and inside a
// round the random reads of table_lo (268 MB, beyond L2), sa_full and the
// text words.  One block per slab gives only ceil(B / slab) blocks (8 for a
// 32,000-read group), far fewer than the 132 SMs; the slab size fixes the
// flags, so more parallelism has to come from inside the slab (a later PR).
//
// unpack_codes_kernel / unpack_amb_kernel: the plain unpack to (B, l_max)
// int32 codes, for the FM stepper's re-seed batches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 13;
constexpr int kOccThr = 50;
constexpr int kIdxBits = 20;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kDambBits = 10;
constexpr int kStartMax = (1 << (29 - kDambBits)) - 1;
constexpr int kOvfBit = 1 << 30;  // overflow flag beside the seed count
constexpr int kMaxThreads = 1024;
constexpr int kLaneArrays = 8;  // shared int arrays of slab length

struct Funnel {
  const int* table_lo;
  const unsigned short* sub_tbl;
  const int* sa_full;
  const unsigned* text_words;
  int seq_len;
  const unsigned* words;  // (B, nwl) 2-bit read words
  const int* amb_r;
  const int* amb_p;
  int n_amb;
  const int* rlens;
  int B;
  int l_max;
  int nwl;  // words per read: ceil(l_max / 16)
  int nab;  // ambiguity words per read: ceil(l_max / 32)
  int msl;
  int max_seeds;
  int hit_cap;
  int rounds;
  int slab;  // rows per slab
  int H;     // hits per slab and round
  unsigned* rw;    // (n_slabs * slab, nwl) scratch
  unsigned* ambm;  // (n_slabs * slab, nab) scratch
  int* out;        // (B, 2 + 4 * max_seeds)
};

__device__ __forceinline__ unsigned read_word(const Funnel& f, int row, int w) {
  return w < f.nwl ? f.rw[(size_t)row * f.nwl + w] : 0u;
}

// In range for l_max <= 512: the text carries 1,024 pad bases past its end.
__device__ __forceinline__ unsigned text_word(const Funnel& f, int w) {
  return __ldg(f.text_words + w);
}

__device__ __forceinline__ bool is_amb(const Funnel& f, int row, int q) {
  return (f.ambm[(size_t)row * f.nab + (q >> 5)] >> (q & 31)) & 1u;
}

// Distance from j (< l_max) to the first position at or after j whose
// ambiguity is `amb`, or l_max if there is none (the JAX distance tables).
__device__ int dist_to(const Funnel& f, int row, int j, bool amb) {
  const unsigned* am = f.ambm + (size_t)row * f.nab;
  for (int wi = j >> 5; wi < f.nab; ++wi) {
    unsigned bits = amb ? am[wi] : ~am[wi];
    if (wi == (j >> 5)) bits &= ~0u << (j & 31);
    const int valid = f.l_max - wi * 32;
    if (valid < 32) bits &= (1u << valid) - 1u;
    if (bits) return wi * 32 + __ffs(bits) - 1 - j;
  }
  return f.l_max;
}

// 13-mer id at j (first base in the high bits; ambiguous and past-the-end
// bases count as 0) and whether its window holds an ambiguous base or runs
// past l_max.
__device__ void kmer_at(const Funnel& f, int row, int j, int& km, bool& amb_win) {
  km = 0;
  amb_win = j + kK > f.l_max;
  for (int i = 0; i < kK; ++i) {
    const int q = j + i;
    int c = 0;
    if (q < f.l_max) {
      c = (read_word(f, row, q >> 4) >> (2 * (q & 15))) & 3;
      amb_win |= is_amb(f, row, q);
    }
    km = (km << 2) | c;
  }
}

// In-place inclusive prefix sum of a[0..n) over the block; part holds one
// partial per thread.  Ends with a barrier.
__device__ void block_inclusive_scan(int* a, int n, int* part) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int per = (n + nt - 1) / nt;
  const int b = min(t * per, n), e = min(b + per, n);
  int s = 0;
  for (int i = b; i < e; ++i) {
    s += a[i];
    a[i] = s;
  }
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  const int base = t ? part[t - 1] : 0;
  for (int i = b; i < e; ++i) a[i] += base;
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads) funnel_kernel(Funnel f) {
  extern __shared__ int smem[];
  __shared__ int part[kMaxThreads];
  const int S = f.slab;
  int* s_p = smem;          // restart position
  int* s_ns = s_p + S;      // seed count | overflow flag
  int* s_cum = s_ns + S;    // hit count, then its inclusive prefix sum
  int* s_lo = s_cum + S;    // SA interval start
  int* s_km = s_lo + S;     // 13-mer id
  int* s_aux = s_km + S;    // amb_off | damb-1 << 16 | valid13 << 26 | active << 27
  int* s_a1 = s_aux + S;    // max of (lcp+1) << 20 | (IDXM - idx)
  int* s_a2 = s_a1 + S;     // max of (lcp+1) << 20 | idx, bogus 1 << 30
  const int t = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * S;
  const int ocols = 2 + 4 * f.max_seeds;
  const int MS = f.max_seeds;

  for (int l = t; l < S; l += nt) {
    const int row = row0 + l;
    s_p[l] = 0;
    s_ns[l] = 0;
    for (int i = 0; i < f.nab; ++i) f.ambm[(size_t)row * f.nab + i] = 0u;
    if (row < f.B)
      for (int c = 0; c < ocols; ++c) f.out[(size_t)row * ocols + c] = 0;
  }
  __syncthreads();
  // the sparse ambiguity list; entries out of range are dropped (pads
  // carry row B)
  for (int i = t; i < f.n_amb; i += nt) {
    const int r = f.amb_r[i], q = f.amb_p[i];
    if (r < row0 || r >= row0 + S || r >= f.B || q < 0 || q >= f.l_max) continue;
    atomicOr(f.ambm + (size_t)r * f.nab + (q >> 5), 1u << (q & 31));
  }
  __syncthreads();
  int more = 0;
  for (int l = t; l < S; l += nt) {
    const int row = row0 + l;
    if (row >= f.B) continue;
    for (int w = 0; w < f.nwl; ++w) {
      unsigned v = f.words[(size_t)row * f.nwl + w];
      for (int b = 0; b < 16; ++b) {
        const int q = 16 * w + b;
        if (q >= f.l_max || is_amb(f, row, q)) v &= ~(3u << (2 * b));
      }
      f.rw[(size_t)row * f.nwl + w] = v;
    }
    more |= 0 < f.rlens[row] - f.msl;
  }
  more = __syncthreads_or(more);

  const int last_valid = f.seq_len - kK;
  const int W = (f.l_max + 15) / 16 + 2;
  for (int round = 0; round < f.rounds && more; ++round) {
    // phase A: restart, 13-mer interval, hit count
    for (int l = t; l < S; l += nt) {
      const int row = row0 + l;
      int p = s_p[l], cnt = 0, lo = 0, km = 0, aux = 0;
      if (row < f.B) {
        const int rlen = f.rlens[row];
        p = min(p + dist_to(f, row, min(p, f.l_max - 1), false), f.l_max);
        const int pidx = min(p, f.l_max - 1);
        const bool active = p < rlen - f.msl;
        bool amb_win;
        kmer_at(f, row, pidx, km, amb_win);
        const int aoff = dist_to(f, row, pidx, true);
        const bool valid13 = active && !amb_win;
        if (valid13) {
          lo = __ldg(f.table_lo + km);
          cnt = __ldg(f.table_lo + km + 1) - lo;
        }
        if (active && cnt > f.hit_cap) {
          s_ns[l] |= kOvfBit;
          cnt = 0;
        }
        const int damb1 = min(max(min(min(aoff, rlen - p), f.l_max) - 1, 0), (1 << kDambBits) - 1);
        aux = aoff | (damb1 << 16) | (int(valid13) << 26) | (int(active) << 27);
      }
      s_p[l] = p;
      s_cum[l] = cnt;
      s_lo[l] = lo;
      s_km[l] = km;
      s_aux[l] = aux;
      s_a1[l] = INT_MIN;
      s_a2[l] = INT_MIN;
    }
    __syncthreads();
    block_inclusive_scan(s_cum, S, part);
    const int n_hit = min(s_cum[S - 1], f.H);

    // phase B: one thread per hit
    for (int j = t; j < n_hit; j += nt) {
      int a = 0, b = S - 1;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (s_cum[m] > j) b = m; else a = m + 1;
      }
      const int l = a;
      if (s_cum[l] > f.H) continue;  // the lane's hits do not all fit
      const int start = l ? s_cum[l - 1] : 0;
      const int hit_idx = j - min(start, kStartMax);
      const int loc = __ldg(f.sa_full + (s_lo[l] - start + j));
      if (loc > last_valid) {  // bogus short-suffix row
        atomicMax(s_a1 + l, -1);
        atomicMax(s_a2 + l, 1 << 30);
        continue;
      }
      const int row = row0 + l;
      const int pidx = min(s_p[l], f.l_max - 1);
      const int damb = ((s_aux[l] >> 16) & ((1 << kDambBits) - 1)) + 1;
      const int ta = loc >> 4, tsh = 2 * (loc & 15);
      const int ra = pidx >> 4, rsh = 2 * (pidx & 15);
      unsigned t0 = text_word(f, ta), r0 = read_word(f, row, ra);
      int lcp = (W - 1) * 16;
      for (int w = 0; w < W - 1; ++w) {
        const unsigned t1 = text_word(f, ta + w + 1), r1 = read_word(f, row, ra + w + 1);
        const unsigned tw = (t0 >> tsh) | (tsh ? t1 << (32 - tsh) : 0u);
        const unsigned rw = (r0 >> rsh) | (rsh ? r1 << (32 - rsh) : 0u);
        const unsigned x = tw ^ rw;
        if (x) {
          lcp = w * 16 + ((__ffs(x) - 1) >> 1);
          break;
        }
        t0 = t1;
        r0 = r1;
      }
      lcp = min(min(lcp, min(damb, f.seq_len - loc)), f.l_max);
      const int idx_c = min(max(hit_idx, 0), kIdxMask);
      const int lc1 = (lcp + 1) << kIdxBits;
      atomicMax(s_a1 + l, lc1 | (kIdxMask - idx_c));
      atomicMax(s_a2 + l, lc1 | idx_c);
    }
    __syncthreads();

    // phase C: per-lane reduction, record, advance
    int go = 0;
    for (int l = t; l < S; l += nt) {
      const int row = row0 + l;
      if (row >= f.B) continue;
      const int rlen = f.rlens[row];
      const int aux = s_aux[l];
      const bool active = (aux >> 27) & 1, valid13 = (aux >> 26) & 1;
      const int aoff = aux & 0xFFFF;
      const int cum = s_cum[l], cnt = cum - (l ? s_cum[l - 1] : 0);
      int ns = s_ns[l];
      if (active && cnt > 0 && cum > f.H) ns |= kOvfBit;
      const int A1 = s_a1[l], A2 = s_a2[l];
      if (A2 >= (1 << 30)) ns |= kOvfBit;
      const int best = max((A1 >> kIdxBits) - 1, -1);
      const int first_off = kIdxMask - (A1 & kIdxMask);
      const int freq = best >= 0 ? (A2 & kIdxMask) - first_off + 1 : 0;
      const bool has13 = valid13 && best >= kK;
      int length = best;
      if (!has13) {
        const int msk = __ldg(f.sub_tbl + s_km[l]);
        const int allow = msk & ((1 << (min(aoff, kK) + 1)) - 1);
        length = allow ? 31 - __clz(allow) : 0;
      }
      const int p = s_p[l];
      if (active && has13 && length >= f.msl && freq <= kOccThr && freq > 0) {
        const int n = ns & ~kOvfBit;
        if (n < MS) {
          int* o = f.out + (size_t)row * ocols + 2 + n;
          o[0] = p;
          o[MS] = length;
          o[2 * MS] = s_lo[l] + first_off;  // freq > 0
          o[3 * MS] = freq;
        }
        ++ns;
      }
      const int np = active ? p + length + 1 : p;
      s_p[l] = np;
      s_ns[l] = ns;
      go |= np < rlen - f.msl;
    }
    more = __syncthreads_or(go);
  }

  // a lane is clean iff it ran to completion without overflow
  for (int l = t; l < S; l += nt) {
    const int row = row0 + l;
    if (row >= f.B) continue;
    const int p = s_p[l];
    const int pf = min(p + dist_to(f, row, min(p, f.l_max - 1), false), f.l_max);
    const bool unfinished = pf < f.rlens[row] - f.msl;
    f.out[(size_t)row * ocols] = s_ns[l] & ~kOvfBit;
    f.out[(size_t)row * ocols + 1] = !((s_ns[l] & kOvfBit) || unfinished);
  }
}

__global__ void unpack_codes_kernel(const unsigned* __restrict__ words, int nwl, int B,
                                    int l_max, int* __restrict__ reads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * l_max) return;
  const int b = (int)(i / l_max), j = (int)(i % l_max);
  reads[i] = (__ldg(words + (size_t)b * nwl + (j >> 4)) >> (2 * (j & 15))) & 3u;
}

__global__ void unpack_amb_kernel(const int* __restrict__ amb_r, const int* __restrict__ amb_p,
                                  int n_amb, int B, int l_max, int* __restrict__ reads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_amb) return;
  const int r = amb_r[i], q = amb_p[i];
  if (r >= 0 && r < B && q >= 0 && q < l_max) reads[(size_t)r * l_max + q] = 4;
}

}  // namespace

// words: (B, ceil(l_max/16)) uint32, l_max <= 512; amb_r/amb_p: (n_amb,)
// int32; rlens: (B,) int32; tables as KmerTablesTensors; rw: (n_slabs*slab, ceil(l_max/16))
// and ambm: (n_slabs*slab, ceil(l_max/32)) uint32 scratch; out: (B, 2 +
// 4*max_seeds) int32.  A batch of at most slab_rows reads is one slab of B
// rows; a larger one is cut into slabs of slab_rows.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue if a slab's
// lane arrays exceed the shared memory of a block).
extern "C" int kart_kmer_funnel(const void* table_lo, const void* sub_tbl, const void* sa_full,
                                const void* text_words, int seq_len,
                                const void* words, const void* amb_r, const void* amb_p,
                                int n_amb, const void* rlens, int B, int l_max,
                                int min_seed_len, int max_seeds, int hit_cap, int rounds,
                                int slab_rows, int hit_budget, void* rw, void* ambm, void* out,
                                void* stream) {
  Funnel f;
  f.table_lo = static_cast<const int*>(table_lo);
  f.sub_tbl = static_cast<const unsigned short*>(sub_tbl);
  f.sa_full = static_cast<const int*>(sa_full);
  f.text_words = static_cast<const unsigned*>(text_words);
  f.seq_len = seq_len;
  f.words = static_cast<const unsigned*>(words);
  f.amb_r = static_cast<const int*>(amb_r);
  f.amb_p = static_cast<const int*>(amb_p);
  f.n_amb = n_amb;
  f.rlens = static_cast<const int*>(rlens);
  f.B = B;
  f.l_max = l_max;
  f.nwl = (l_max + 15) / 16;
  f.nab = (l_max + 31) / 32;
  f.msl = min_seed_len;
  f.max_seeds = max_seeds;
  f.hit_cap = hit_cap;
  f.rounds = rounds;
  f.slab = B <= slab_rows ? B : slab_rows;
  f.H = hit_budget * f.slab;
  f.rw = static_cast<unsigned*>(rw);
  f.ambm = static_cast<unsigned*>(ambm);
  f.out = static_cast<int*>(out);
  const int n_slabs = (B + f.slab - 1) / f.slab;
  const size_t smem = (size_t)kLaneArrays * f.slab * sizeof(int);
  if (smem + kMaxThreads * sizeof(int) > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(funnel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = min(kMaxThreads, (f.slab + 31) / 32 * 32);
  funnel_kernel<<<n_slabs, threads, smem, static_cast<cudaStream_t>(stream)>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// words: (B, ceil(l_max/16)) uint32; amb_r/amb_p: (n_amb,) int32 -> reads
// (B, l_max) int32 codes, ambiguous bases 4.  Two launches on one stream.
extern "C" int kart_unpack_reads(const void* words, const void* amb_r, const void* amb_p,
                                 int n_amb, int B, int l_max, void* reads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * l_max;
  const int threads = 256;
  unpack_codes_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const unsigned*>(words), (l_max + 15) / 16, B, l_max, static_cast<int*>(reads));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_amb == 0) return (int)err;
  unpack_amb_kernel<<<(n_amb + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const int*>(amb_r), static_cast<const int*>(amb_p), n_amb, B, l_max,
      static_cast<int*>(reads));
  return static_cast<int>(cudaGetLastError());
}
