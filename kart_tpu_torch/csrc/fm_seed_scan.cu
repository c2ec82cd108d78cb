// FastMode FM-index seeding scan for Hopper (sm_90a), one thread per read.
//
// Replaces kart_tpu/ops/fm_search.py::seed_scan_impl together with occ4,
// occ4_from, _count4_word and _occ4_pair_replicated: the jnp FM stepper that
// XLA ran as l_max+1 uniform batched steps.  The plain PyTorch version is
// kart_tpu_torch/ops/fm_search.py::seed_scan_plain; the output is the same
// packed (B, 1 + 4*max_seeds) int32 row per read:
//   [n_seeds | rpos[max_seeds] | slen[max_seeds] | k0[max_seeds] | freq[max_seeds]]
//
// What bounds it on this card: each step of an active lane makes two occ4
// lookups that depend on the previous step, and each lookup is a random
// 16-byte checkpoint read plus a 32-byte BWT block read.  At E. coli scale
// the whole index (tens of MB) sits in the 50 MB L2, so a step costs about
// two dependent L2 round trips.  The design keeps the lane state in
// registers, skips the lookups of idle and ambiguous lanes (the JAX version
// computes them for every lane and masks), and reads each block with two
// 16-byte vector loads.  One thread per read keeps the loop free of any
// cross-lane synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOccThr = 50;
constexpr unsigned kM55 = 0x55555555u;

// Adds the per-code counts of one 32-bit BWT word (16 bases of 2 bits).
__device__ __forceinline__ void count4_add(unsigned w, int c[4]) {
  const unsigned nw = ~w;
  c[0] += __popc((nw >> 1) & nw & kM55);
  c[1] += __popc((nw >> 1) & w & kM55);
  c[2] += __popc((w >> 1) & nw & kM55);
  c[3] += __popc((w >> 1) & w & kM55);
}

// bwt_occ4(k): counts of each code in bwt[0..k], for 0 <= k <= seq_len.
__device__ __forceinline__ void occ4(const int4* __restrict__ occ_cp,
                                     const uint4* __restrict__ bwt, int primary,
                                     int k, int c[4]) {
  const int kk = k - (k >= primary);
  const int blk = kk >> 7;
  const int4 base = __ldg(occ_cp + blk);
  c[0] = base.x;
  c[1] = base.y;
  c[2] = base.z;
  c[3] = base.w;
  const uint4 lo = __ldg(bwt + 2 * blk);
  const uint4 hi = __ldg(bwt + 2 * blk + 1);
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int jk = (kk & 0x7F) >> 4;
  const int shift = (~kk & 0xF) << 1;  // 0..30
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < jk) {
      count4_add(w[j], c);
    } else if (j == jk) {
      // the masked-out low bases read as code 0; corrected below
      count4_add(w[j] & ~((1u << shift) - 1u), c);
    }
  }
  c[0] -= ~kk & 0xF;
}

__global__ void __launch_bounds__(128)
seed_scan_kernel(const int4* __restrict__ occ_cp, const uint4* __restrict__ bwt,
                 const int* __restrict__ L2, int primary,
                 const int* __restrict__ reads, const int* __restrict__ rlens,
                 int B, int l_max, int min_seed_len, int max_seeds,
                 int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* read = reads + static_cast<size_t>(b) * l_max;
  const int rlen = rlens[b];
  int* row = out + static_cast<size_t>(b) * (1 + 4 * max_seeds);
  int* rpos = row + 1;
  int* slen = rpos + max_seeds;
  int* k0 = slen + max_seeds;
  int* freq = k0 + max_seeds;

  bool active = false;
  int start = 0, x0 = 0, x1 = 0, x2 = 0, n_seeds = 0;
  // p == l_max reads an extra ambiguous column, so the last extension of
  // every read ends, and emits, inside the loop
  for (int p = 0; p <= l_max; ++p) {
    const int c = p < l_max ? read[p] : 4;
    const bool amb = c > 3;
    const int cs = amb ? 3 : c;

    bool ext_fail = true;
    int nx0 = 0, nx1 = 0, nx2 = 0;
    if (active && !amb) {
      int tk[4], tl[4];
      occ4(occ_cp, bwt, primary, x1 - 1, tk);
      occ4(occ_cp, bwt, primary, x1 - 1 + x2, tl);
      const int i = 3 - cs;  // complement base
      const int s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary));
      const int s2 = s3 + (tl[3] - tk[3]);
      const int s1 = s2 + (tl[2] - tk[2]);
      const int s0 = s1 + (tl[1] - tk[1]);
      const int tki = i == 0 ? tk[0] : i == 1 ? tk[1] : i == 2 ? tk[2] : tk[3];
      const int tli = i == 0 ? tl[0] : i == 1 ? tl[1] : i == 2 ? tl[2] : tl[3];
      nx0 = i == 0 ? s0 : i == 1 ? s1 : i == 2 ? s2 : s3;
      nx1 = __ldg(L2 + i) + 1 + tki;
      nx2 = tli - tki;
      ext_fail = nx2 == 0;
    }

    if (active && ext_fail) {
      const int length = p - start;
      if (length >= min_seed_len && x2 <= kOccThr) {
        if (n_seeds < max_seeds) {  // past max_seeds the record is dropped
          rpos[n_seeds] = start;
          slen[n_seeds] = length;
          k0[n_seeds] = x0;
          freq[n_seeds] = x2;
        }
        ++n_seeds;
      }
    }

    const bool cont = active && !ext_fail;
    const bool can_start = !active && !amb && p < rlen - min_seed_len;
    if (cont) {
      x0 = nx0;
      x1 = nx1;
      x2 = nx2;
    } else if (can_start) {
      start = p;
      x0 = __ldg(L2 + cs) + 1;
      x1 = __ldg(L2 + 3 - cs) + 1;
      x2 = __ldg(L2 + cs + 1) - __ldg(L2 + cs);
    }
    active = cont || can_start;
  }

  row[0] = n_seeds;
  for (int s = min(n_seeds, max_seeds); s < max_seeds; ++s) {
    rpos[s] = 0;
    slen[s] = 0;
    k0[s] = 0;
    freq[s] = 0;
  }
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; occ_cp and
// bwt_words must be 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int kart_fm_seed_scan(const void* occ_cp, const void* bwt_words,
                                 const void* L2, int primary, const void* reads,
                                 const void* rlens, int B, int l_max,
                                 int min_seed_len, int max_seeds, void* out,
                                 void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  seed_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(occ_cp), static_cast<const uint4*>(bwt_words),
      static_cast<const int*>(L2), primary, static_cast<const int*>(reads),
      static_cast<const int*>(rlens), B, l_max, min_seed_len, max_seeds,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
