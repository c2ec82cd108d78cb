// FastMode 13-mer funnel for Hopper (sm_90a): 2-bit read unpack plus the
// round loop of the direct-lookup seeding scan, one thread-block cluster per
// slab.
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
// FM re-seed.  The slab cannot shrink, so the parallelism comes from inside
// it: a cluster of kCluster blocks owns one slab, block r the lanes
// [r * LB, (r + 1) * LB) with LB = ceil(slab / kCluster), and the blocks
// meet once a round through distributed shared memory.
//
//   amb_scatter_kernel  grid-wide, one thread per entry of the sparse
//             ambiguity list: atomicOr into a zeroed (B, ceil(l_max/32))
//             bit mask (no order of the list is assumed);
//   funnel_kernel, per block:
//   prologue  its lanes' mask words and read words (ambiguous and
//             past-the-end bases 0) into its own shared memory, where
//             every later phase reads them;
//   phase A   per lane: skip ambiguous restarts (__ffs over the mask
//             words), the 13-mer id from two adjacent read words (funnel
//             shift, 2-bit-group reversal), its interval
//             [table_lo[km], table_lo[km+1]), hit_cap overflow;
//   scan      the slab-wide inclusive prefix sum of the hit counts: warp
//             shuffles and one barrier inside the block, then every block
//             writes its total, and whether one of its lanes was left after
//             the round before, into every peer's shared memory
//             (map_shared_rank), cluster.sync(), and adds the totals of the
//             ranks before it.  If no lane of the slab was left the loop
//             ends here, in every block alike (phase A of such a round
//             changes nothing that shows: no lane is active in it);
//   phase B   per hit j < min(total, H) of the block's own lanes: its lane
//             by binary search over the block's prefix sums, its text
//             position from sa_full, the LCP of read and text as XOR +
//             count-trailing-zeros over aligned 2-bit words (the text words
//             loaded four at a time, so that their misses overlap), and two
//             atomicMax in the block's own shared memory that equal the two
//             packed segment maxima of the JAX version (an empty lane keeps
//             INT_MIN, as segment_max gives);
//   phase C   per lane: best length, first SA row and freq of the maximiser
//             block, sub-13 restart length from sub_tbl, seed record,
//             advance, and the block's "a lane is left" flag for the next
//             round's exchange.
// A flagged lane keeps running with no hits, as in the JAX version, so its
// later seeds are the same.  The loop ends when no lane of the slab is left
// or after `rounds` rounds, decided by the whole cluster: every block runs
// the same number of rounds and reaches every cluster.sync(), blocks whose
// lanes are all past B included.
//
// What bounds it on this card: the dependent chain of rounds within a slab
// (each round: table_lo, then sa_full, then the text words, three dependent
// random loads from tables beyond L2, plus one cluster barrier), not bytes:
// a 32,000-read group moves a few tens of MB.  A cluster of 8 gives 64
// blocks of 512 lanes for such a group where one block per slab gave 8.
//
// unpack_codes_kernel / unpack_amb_kernel: the plain unpack to (B, l_max)
// int32 codes, for the FM stepper's re-seed batches.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Blocks per slab: the portable maximum.  Clusters of 16 (128 blocks of 256
// lanes for a 32,000-read group) measured the same on an NVIDIA H100 80GB
// HBM3 at 700.00 W, and clusters of 4 a fifth slower (PERF.md).
constexpr int kCluster = 8;
constexpr int kK = 13;
constexpr int kOccThr = 50;
constexpr int kIdxBits = 20;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kDambBits = 10;
constexpr int kStartMax = (1 << (29 - kDambBits)) - 1;
constexpr int kOvfBit = 1 << 30;  // overflow flag beside the seed count
constexpr int kMaxThreads = 1024;
constexpr int kLaneArrays = 9;  // shared int arrays of LB lanes
// Text words of a hit that phase B loads at a time (2, 6 and 12 measured the
// same on that card).
constexpr int kTextChunk = 4;
constexpr size_t kMaxSmem = 227 * 1024;

struct Funnel {
  const int* table_lo;
  const unsigned short* sub_tbl;
  const int* sa_full;
  const unsigned* text_words;
  int seq_len;
  const unsigned* words;  // (B, nwl) 2-bit read words
  const unsigned* ambm;   // (B, nab) ambiguity bits
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
  int LB;    // lanes per block: ceil(slab / cluster)
  int LS;    // lane stride of the shared word arrays (odd: LB | 1)
  int* out;  // (B, 2 + 4 * max_seeds)
};

// The shared word arrays are word-major with an odd lane stride: word w of
// lane l at [w * LS + l], so that threads on neighbouring lanes hit
// neighbouring banks.
__device__ __forceinline__ unsigned lane_word(const unsigned* a, int LS, int n, int l, int w) {
  return w < n ? a[w * LS + l] : 0u;
}

// In range for l_max <= 512: the text carries 1,024 pad bases past its end.
__device__ __forceinline__ unsigned text_word(const Funnel& f, int w) {
  return __ldg(f.text_words + w);
}

// Distance from j (< l_max) to the first position at or after j whose
// ambiguity is `amb`, or l_max if there is none (the JAX distance tables).
__device__ int dist_to(const Funnel& f, const unsigned* am, int l, int j, bool amb) {
  for (int wi = j >> 5; wi < f.nab; ++wi) {
    unsigned bits = am[wi * f.LS + l];
    if (!amb) bits = ~bits;
    if (wi == (j >> 5)) bits &= ~0u << (j & 31);
    const int valid = f.l_max - wi * 32;
    if (valid < 32) bits &= (1u << valid) - 1u;
    if (bits) return wi * 32 + __ffs(bits) - 1 - j;
  }
  return f.l_max;
}

// The 16 2-bit groups of x in reverse order.
__device__ __forceinline__ unsigned reverse_pairs(unsigned x) {
  x = __brev(x);
  return ((x & 0xAAAAAAAAu) >> 1) | ((x & 0x55555555u) << 1);
}

// 13-mer id at j (first base in the high bits; ambiguous and past-the-end
// bases are 0 in the read words): the 26 bits at base j of two adjacent
// words, their 2-bit groups reversed.
__device__ __forceinline__ int kmer_at(const Funnel& f, const unsigned* rw, int l, int j) {
  const int w = j >> 4;
  const unsigned lo = lane_word(rw, f.LS, f.nwl, l, w), hi = lane_word(rw, f.LS, f.nwl, l, w + 1);
  const unsigned x = __funnelshift_r(lo, hi, 2 * (j & 15)) & ((1u << (2 * kK)) - 1u);
  return (int)(reverse_pairs(x) >> (32 - 2 * kK));
}

// A 16-bit mask with every bit doubled: bit b -> bits 2b and 2b+1.
__device__ __forceinline__ unsigned double_bits(unsigned x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x | (x << 1);
}

// Two words per block to every block of the cluster: each block writes
// `total` and `left` into slot `rank` of every peer's `tot` and `more`
// through distributed shared memory, then all meet at cluster.sync(), whose
// release/acquire makes the slots readable.  Every thread of every block of
// the cluster must call it.  Callers alternate between two sets of slots: a
// block may run a whole round ahead of a peer that still reads the last
// exchange's.
__device__ __forceinline__ void cluster_share(cg::cluster_group& cluster, int* tot, int* more,
                                              int total, int left) {
  const int C = (int)cluster.num_blocks();
  if ((int)threadIdx.x < C) {
    const int rank = (int)cluster.block_rank();
    cluster.map_shared_rank(tot, threadIdx.x)[rank] = total;
    cluster.map_shared_rank(more, threadIdx.x)[rank] = left;
  }
  cluster.sync();
}

__global__ void amb_scatter_kernel(const int* __restrict__ amb_r, const int* __restrict__ amb_p,
                                   int n_amb, int B, int l_max, int nab, unsigned* ambm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_amb) return;
  const int r = amb_r[i], q = amb_p[i];
  // entries out of range are dropped (pads carry row B)
  if (r < 0 || r >= B || q < 0 || q >= l_max) return;
  atomicOr(ambm + (size_t)r * nab + (q >> 5), 1u << (q & 31));
}

__global__ void __launch_bounds__(kMaxThreads) funnel_kernel(Funnel f) {
  extern __shared__ int smem[];
  __shared__ int s_warp[kMaxThreads / 32];
  // per exchange parity and rank: the block's hit count this round, and
  // whether one of its lanes was left when the round began
  __shared__ int s_tot2[2 * kCluster];
  __shared__ int s_more2[2 * kCluster];
  __shared__ int s_left;  // one of this block's lanes is left
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int LB = f.LB, LS = f.LS;
  int* s_p = smem;          // restart position
  int* s_ns = s_p + LB;     // seed count | overflow flag
  int* s_cum = s_ns + LB;   // hit count, then its inclusive prefix sum in the block
  int* s_lo = s_cum + LB;   // SA interval start
  int* s_km = s_lo + LB;    // 13-mer id
  int* s_aux = s_km + LB;   // amb_off | damb-1 << 16 | valid13 << 26 | active << 27
  int* s_a1 = s_aux + LB;   // max of (lcp+1) << 20 | (IDXM - idx)
  int* s_a2 = s_a1 + LB;    // max of (lcp+1) << 20 | idx, bogus 1 << 30
  int* s_rl = s_a2 + LB;    // read length
  unsigned* s_rw = reinterpret_cast<unsigned*>(s_rl + LB);  // nwl words per lane
  unsigned* s_am = s_rw + (size_t)f.nwl * LS;               // nab mask words per lane
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane0 = rank * LB;  // first slab lane of this block
  const int row0 = (int)(blockIdx.x / C) * f.slab + lane0;
  // lanes this block owns: inside the slab and inside the batch
  const int nl = max(0, min(LB, min(f.slab - lane0, f.B - row0)));
  const int ocols = 2 + 4 * f.max_seeds;
  const int MS = f.max_seeds;

  // no block may write into a peer's shared memory before the peer runs
  cluster.sync();

  for (int i = t; i < nl * f.nab; i += nt)
    s_am[(i % f.nab) * LS + i / f.nab] = f.ambm[(size_t)row0 * f.nab + i];
  __syncthreads();
  for (int i = t; i < nl * f.nwl; i += nt) {
    const int l = i / f.nwl, w = i % f.nwl;
    unsigned v = f.words[(size_t)row0 * f.nwl + i];
    v &= ~double_bits((s_am[(w >> 1) * LS + l] >> (16 * (w & 1))) & 0xFFFFu);
    const int valid = f.l_max - 16 * w;  // > 0
    if (valid < 16) v &= (1u << (2 * valid)) - 1u;
    s_rw[w * LS + l] = v;
  }
  if (t == 0) s_left = 0;
  __syncthreads();
  for (int l = t; l < nl; l += nt) {
    s_p[l] = 0;
    s_ns[l] = 0;
    const int rlen = f.rlens[row0 + l];
    s_rl[l] = rlen;
    if (0 < rlen - f.msl) s_left = 1;
  }

  const int last_valid = f.seq_len - kK;
  const int W = (f.l_max + 15) / 16 + 2;
  const int per = (LB + nt - 1) / nt;  // lanes per thread in the scan
  for (int round = 0; round < f.rounds; ++round) {
    int* s_tot = s_tot2 + (round & 1) * kCluster;
    int* s_more = s_more2 + (round & 1) * kCluster;
    // phase A: restart, 13-mer interval, hit count
    for (int l = t; l < nl; l += nt) {
      const int rlen = s_rl[l];
      int p = s_p[l], cnt = 0, lo = 0;
      p = min(p + dist_to(f, s_am, l, min(p, f.l_max - 1), false), f.l_max);
      const int pidx = min(p, f.l_max - 1);
      const bool active = p < rlen - f.msl;
      const int km = kmer_at(f, s_rw, l, pidx);
      const int aoff = dist_to(f, s_am, l, pidx, true);
      // no ambiguous base in the window, and the window inside l_max
      const bool valid13 = active && aoff >= kK && pidx + kK <= f.l_max;
      if (valid13) {
        lo = __ldg(f.table_lo + km);
        cnt = __ldg(f.table_lo + km + 1) - lo;
      }
      if (active && cnt > f.hit_cap) {
        s_ns[l] |= kOvfBit;
        cnt = 0;
      }
      const int damb1 = min(max(min(min(aoff, rlen - p), f.l_max) - 1, 0), (1 << kDambBits) - 1);
      s_p[l] = p;
      s_cum[l] = cnt;
      s_lo[l] = lo;
      s_km[l] = km;
      s_aux[l] = aoff | (damb1 << 16) | (int(valid13) << 26) | (int(active) << 27);
      s_a1[l] = INT_MIN;
      s_a2[l] = INT_MIN;
    }
    __syncthreads();

    // scan: inside the block, then across the cluster
    {
      const int b = min(t * per, nl), e = min(b + per, nl);
      int s = 0;
      for (int i = b; i < e; ++i) {
        s += s_cum[i];
        s_cum[i] = s;
      }
      int incl = s;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if ((t & 31) >= off) incl += v;
      }
      if ((t & 31) == 31) s_warp[t >> 5] = incl;
      __syncthreads();
      int before = incl - s, block_total = 0;
      for (int k = 0; k < nt / 32; ++k) {
        const int v = s_warp[k];
        if (k < (t >> 5)) before += v;
        block_total += v;
      }
      for (int i = b; i < e; ++i) s_cum[i] += before;
      // s_left is whole: its writers ran before the barrier above
      cluster_share(cluster, s_tot, s_more, block_total, s_left);  // a barrier too
    }
    int base = 0, total = 0, more = 0;  // hits of the ranks before this one, and of the slab
    for (int r = 0; r < C; ++r) {
      const int v = s_tot[r];
      if (r < rank) base += v;
      total += v;
      more |= s_more[r];
    }
    if (!more) break;  // no lane of the slab was left: the same in every block
    if (t == 0) s_left = 0;  // phase C sets it again, after the barrier below
    // the block's share of the slab's hits j < min(total, H)
    const int n_hit = max(0, min(min(total, f.H) - base, s_tot[rank]));

    // phase B: one thread per hit of the block's own lanes
    for (int jj = t; jj < n_hit; jj += nt) {
      int a = 0, b = nl - 1;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (s_cum[m] > jj) b = m; else a = m + 1;
      }
      const int l = a;
      if (s_cum[l] + base > f.H) continue;  // the lane's hits do not all fit
      const int start_b = l ? s_cum[l - 1] : 0;
      const int hit_idx = jj + base - min(start_b + base, kStartMax);
      const int loc = __ldg(f.sa_full + (s_lo[l] + jj - start_b));
      if (loc > last_valid) {  // bogus short-suffix row
        atomicMax(s_a1 + l, -1);
        atomicMax(s_a2 + l, 1 << 30);
        continue;
      }
      const int pidx = min(s_p[l], f.l_max - 1);
      const int damb = ((s_aux[l] >> 16) & ((1 << kDambBits) - 1)) + 1;
      const int ta = loc >> 4, tsh = 2 * (loc & 15);
      const int ra = pidx >> 4, rsh = 2 * (pidx & 15);
      unsigned t0 = text_word(f, ta), r0 = lane_word(s_rw, LS, f.nwl, l, ra);
      int lcp = (W - 1) * 16;
      bool same = true;  // read and text agree so far
      for (int w0 = 0; w0 < W - 1 && same; w0 += kTextChunk) {
        unsigned tw[kTextChunk];  // the chunk's loads are in flight together
#pragma unroll
        for (int k = 0; k < kTextChunk; ++k)
          tw[k] = w0 + k < W - 1 ? text_word(f, ta + w0 + k + 1) : 0u;
#pragma unroll
        for (int k = 0; k < kTextChunk; ++k) {
          const int w = w0 + k;
          if (w >= W - 1 || !same) break;
          const unsigned r1 = lane_word(s_rw, LS, f.nwl, l, ra + w + 1);
          const unsigned x = __funnelshift_r(t0, tw[k], tsh) ^ __funnelshift_r(r0, r1, rsh);
          if (x) {
            lcp = w * 16 + ((__ffs(x) - 1) >> 1);
            same = false;
          }
          t0 = tw[k];
          r0 = r1;
        }
      }
      lcp = min(min(lcp, min(damb, f.seq_len - loc)), f.l_max);
      const int idx_c = min(max(hit_idx, 0), kIdxMask);
      const int lc1 = (lcp + 1) << kIdxBits;
      atomicMax(s_a1 + l, lc1 | (kIdxMask - idx_c));
      atomicMax(s_a2 + l, lc1 | idx_c);
    }
    __syncthreads();

    // phase C: per-lane reduction, record, advance
    for (int l = t; l < nl; l += nt) {
      const int rlen = s_rl[l];
      const int aux = s_aux[l];
      const bool active = (aux >> 27) & 1, valid13 = (aux >> 26) & 1;
      const int aoff = aux & 0xFFFF;
      const int cum_b = s_cum[l], cnt = cum_b - (l ? s_cum[l - 1] : 0);
      int ns = s_ns[l];
      if (active && cnt > 0 && cum_b + base > f.H) ns |= kOvfBit;
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
          int* o = f.out + (size_t)(row0 + l) * ocols + 2 + n;
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
      if (np < rlen - f.msl) s_left = 1;
    }
    // phase C read the neighbour lane's prefix sum, which the next round's
    // phase A overwrites
    __syncthreads();
  }

  // a lane is clean iff it ran to completion without overflow
  for (int l = t; l < nl; l += nt) {
    const int p = s_p[l];
    const int pf = min(p + dist_to(f, s_am, l, min(p, f.l_max - 1), false), f.l_max);
    const bool unfinished = pf < s_rl[l] - f.msl;
    int* o = f.out + (size_t)(row0 + l) * ocols;
    o[0] = s_ns[l] & ~kOvfBit;
    o[1] = !((s_ns[l] & kOvfBit) || unfinished);
  }
  // no block leaves while a peer may still write into its shared memory
  cluster.sync();
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

// Blocks per slab that kart_kmer_funnel launches as one cluster.
extern "C" int kart_kmer_funnel_cluster() { return kCluster; }

// words: (B, ceil(l_max/16)) uint32, l_max <= 512; amb_r/amb_p: (n_amb,)
// int32; rlens: (B,) int32; tables as KmerTablesTensors; ambm: (B,
// ceil(l_max/32)) uint32 scratch; out: (B, 2 + 4*max_seeds) int32.  A batch
// of at most slab_rows reads is one slab of B rows; a larger one is cut into
// slabs of slab_rows.  Two memsets, the ambiguity scatter and the cluster
// kernel on one stream.  Returns the first CUDA error, cudaGetLastError()
// after the launches (cudaErrorInvalidValue if the lanes of one block,
// ceil(slab / cluster), exceed the shared memory of a block).
extern "C" int kart_kmer_funnel(const void* table_lo, const void* sub_tbl, const void* sa_full,
                                const void* text_words, int seq_len,
                                const void* words, const void* amb_r, const void* amb_p,
                                int n_amb, const void* rlens, int B, int l_max,
                                int min_seed_len, int max_seeds, int hit_cap, int rounds,
                                int slab_rows, int hit_budget, void* ambm, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Funnel f;
  f.table_lo = static_cast<const int*>(table_lo);
  f.sub_tbl = static_cast<const unsigned short*>(sub_tbl);
  f.sa_full = static_cast<const int*>(sa_full);
  f.text_words = static_cast<const unsigned*>(text_words);
  f.seq_len = seq_len;
  f.words = static_cast<const unsigned*>(words);
  f.ambm = static_cast<const unsigned*>(ambm);
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
  f.LB = (f.slab + kCluster - 1) / kCluster;
  f.LS = f.LB | 1;
  f.out = static_cast<int*>(out);
  const int n_slabs = (B + f.slab - 1) / f.slab;
  const size_t smem = ((size_t)kLaneArrays * f.LB + (size_t)(f.nwl + f.nab) * f.LS) * sizeof(int);
  if (smem + 4096 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(ambm, 0, (size_t)B * f.nab * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(out, 0, (size_t)B * (2 + 4 * max_seeds) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_amb > 0) {
    amb_scatter_kernel<<<(n_amb + 255) / 256, 256, 0, st>>>(
        static_cast<const int*>(amb_r), static_cast<const int*>(amb_p), n_amb, B, l_max, f.nab,
        static_cast<unsigned*>(ambm));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(funnel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_slabs * kCluster));  // a multiple of the cluster size
  // one thread a lane
  cfg.blockDim = dim3((unsigned)min(kMaxThreads, (f.LB + 31) / 32 * 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, funnel_kernel, f);
  if (err != cudaSuccess) return (int)err;
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
