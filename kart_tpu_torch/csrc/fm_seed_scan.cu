// FM-index seeding scans for Hopper (sm_90a), a group of lanes per read:
// FastMode (seed_scan_kernel) and SensitiveMode (sensitive_scan_kernel, at
// the end of this file, which shares the occ4 step).
//
// Replaces kart_tpu/ops/fm_search.py::seed_scan_impl together with occ4,
// occ4_from, _count4_word and _occ4_pair_replicated: the jnp FM stepper that
// XLA ran as l_max+1 uniform batched steps.  The plain PyTorch version is
// kart_tpu_torch/ops/fm_search.py::seed_scan_plain; the output is the same
// packed (B, 1 + 4*max_seeds) int32 row per read:
//   [n_seeds | rpos[max_seeds] | slen[max_seeds] | k0[max_seeds] | freq[max_seeds]]
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOccThr = 50;
constexpr unsigned kM55 = 0x55555555u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;
constexpr int kGroup = 16;                     // lanes a read
constexpr int kPerBlock = kThreads / kGroup;   // reads a block
constexpr size_t kMaxSmem = 232448;            // a block's shared memory on sm_90

// Per-code counts of one 32-bit BWT word (16 bases of 2 bits), one byte each:
// code c in bits 8c..8c+7.
__device__ __forceinline__ unsigned count4_packed(unsigned w) {
  const unsigned nw = ~w;
  return __popc((nw >> 1) & nw & kM55) | (__popc((nw >> 1) & w & kM55) << 8) |
         (__popc((w >> 1) & nw & kM55) << 16) | (__popc((w >> 1) & w & kM55) << 24);
}

// One lane's share of occ4(k) (kk is k less the primary shift): the counts of
// word wj of k's block, bases past k masked out (they read as code 0 and are
// taken off again), nothing for the words past k.
__device__ __forceinline__ unsigned word_counts(const unsigned* __restrict__ bwt, int kk, int wj) {
  const int jk = (kk & 0x7F) >> 4;
  if (wj > jk) return 0;
  unsigned w = __ldg(bwt + (static_cast<size_t>(kk >> 7) << 3) + wj);
  if (wj == jk) w &= ~((1u << ((~kk & 0xF) << 1)) - 1u);
  unsigned cnt = count4_packed(w);
  if (wj == jk) cnt -= ~kk & 0xF;
  return cnt;
}

// occ4(k) less its checkpoint row, the four counts one byte each, summed over
// the eight lanes that share the block's words; a block holds 128 bases, so
// the byte-wide sums cannot carry.  Every lane of the warp calls this; `on`
// says whether the lane's read takes a step.
__device__ __forceinline__ unsigned block_counts(const unsigned* __restrict__ bwt, bool on, int kk,
                                                 int wj) {
  unsigned v = on ? word_counts(bwt, kk, wj) : 0;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ int pick4(int i, int a, int b, int c, int d) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// Shared memory of a block, per read: the seed row (row_len ints), then the
// read's codes as bytes (code_words ints).
__global__ void __launch_bounds__(kThreads)
seed_scan_kernel(const int4* __restrict__ occ_cp, const unsigned* __restrict__ bwt,
                 const int* __restrict__ L2, int primary,
                 const int* __restrict__ reads, const int* __restrict__ rlens,
                 int B, int l_max, int min_seed_len, int max_seeds, int code_words,
                 int* __restrict__ out) {
  extern __shared__ int smem[];
  const int row_len = 1 + 4 * max_seeds;
  const int g = threadIdx.x / kGroup;  // the read of this block
  const int j = threadIdx.x % kGroup;  // the lane of its group
  const int end = j / 8;               // 0 the lower interval end, 1 the upper
  const int wj = j % 8;                // the lane's word of a BWT block
  const int b = blockIdx.x * kPerBlock + g;
  const bool valid = b < B;
  int* row = smem + g * (row_len + code_words);
  unsigned char* codes = reinterpret_cast<unsigned char*>(row + row_len);

  const int l2_0 = __ldg(L2), l2_1 = __ldg(L2 + 1), l2_2 = __ldg(L2 + 2), l2_3 = __ldg(L2 + 3),
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
  int start = 0, x0 = 0, x1 = 0, x2 = 0, n_seeds = 0;
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
    int kka = 0, kkb = 0;
    int4 cpk = make_int4(0, 0, 0, 0), cpl = cpk;
    if (extend) {
      const int ka = x1 - 1, kb = ka + x2;
      kka = ka - (ka >= primary);
      kkb = kb - (kb >= primary);
      cpk = __ldg(occ_cp + (kka >> 7));
      cpl = __ldg(occ_cp + (kkb >> 7));
    }
    const unsigned mine = block_counts(bwt, extend, end ? kkb : kka, wj);
    const unsigned other = __shfl_xor_sync(kFull, mine, 8);
    const unsigned ck = end ? other : mine, cl = end ? mine : other;

    bool ext_fail = true;
    int nx0 = 0, nx1 = 0, nx2 = 0;
    if (extend) {
      const int tk0 = cpk.x + (ck & 0xFF), tk1 = cpk.y + ((ck >> 8) & 0xFF),
                tk2 = cpk.z + ((ck >> 16) & 0xFF), tk3 = cpk.w + (ck >> 24);
      const int tl0 = cpl.x + (cl & 0xFF), tl1 = cpl.y + ((cl >> 8) & 0xFF),
                tl2 = cpl.z + ((cl >> 16) & 0xFF), tl3 = cpl.w + (cl >> 24);
      const int i = 3 - cs;  // complement base
      const int s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary));
      const int s2 = s3 + (tl3 - tk3);
      const int s1 = s2 + (tl2 - tk2);
      const int s0 = s1 + (tl1 - tk1);
      const int tki = pick4(i, tk0, tk1, tk2, tk3);
      const int tli = pick4(i, tl0, tl1, tl2, tl3);
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
          row[1 + j * max_seeds + n_seeds] = pick4(j, start, length, x0, x2);
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
    int* dst = out + static_cast<size_t>(b) * row_len;
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
// Reads go up to 32,768 bases with some 2,500 seeds each, so nothing of a
// read is kept in shared memory: the code at p is one load from global
// memory (the lanes of a group ask for the same word; it does not feed the
// index loads' addresses, so it overlaps them), and the four lanes that hold
// a seed's fields store them straight into the row, which the launch zeroed.
// What bounds it: the chain of trips, about two a base, each one dependent
// occ4 pair; 16 lanes a read keep a trip short, as in the FastMode kernel.
__global__ void __launch_bounds__(kThreads)
sensitive_scan_kernel(const int4* __restrict__ occ_cp, const unsigned* __restrict__ bwt,
                      const int* __restrict__ L2, int primary,
                      const int* __restrict__ reads, const int* __restrict__ rlens,
                      int B, int width, int min_seed_len, int max_seeds, int max_trips,
                      int* __restrict__ out) {
  const int g = threadIdx.x / kGroup;
  const int j = threadIdx.x % kGroup;
  const int end = j / 8;
  const int wj = j % 8;
  const int b = blockIdx.x * kPerBlock + g;
  const bool valid = b < B;
  const int l2_0 = __ldg(L2), l2_1 = __ldg(L2 + 1), l2_2 = __ldg(L2 + 2), l2_3 = __ldg(L2 + 3),
            l2_4 = __ldg(L2 + 4);
  const int rlen = valid ? __ldg(rlens + b) : 0;
  const int end_pos = rlen - min_seed_len;  // a seed can start at p only while p < end_pos
  const int* read = reads + static_cast<size_t>(valid ? b : 0) * width;
  int* row = out + static_cast<size_t>(valid ? b : 0) * (1 + 4 * max_seeds);

  bool active = false;
  int p = 0, start = 0, x0 = 0, x1 = 1, x2 = 0, n_seeds = 0;
  for (int it = 0;; ++it) {
    const bool live = it < max_trips && (active || p < end_pos);
    if (!__any_sync(kFull, live)) break;
    // past its last column the read continues with one ambiguous base
    const int c = (live && p < width) ? __ldg(read + p) : 4;
    const bool amb = c > 3;
    const int cs = amb ? 3 : c;
    const bool at_stop = p >= min(start + 30, rlen);
    const bool extend = live && active && !amb && !at_stop;

    int kka = 0, kkb = 0;
    int4 cpk = make_int4(0, 0, 0, 0), cpl = cpk;
    if (extend) {
      const int ka = x1 - 1, kb = ka + x2;
      kka = ka - (ka >= primary);
      kkb = kb - (kb >= primary);
      cpk = __ldg(occ_cp + (kka >> 7));
      cpl = __ldg(occ_cp + (kkb >> 7));
    }
    const unsigned mine = block_counts(bwt, extend, end ? kkb : kka, wj);
    const unsigned other = __shfl_xor_sync(kFull, mine, 8);
    const unsigned ck = end ? other : mine, cl = end ? mine : other;

    bool ext_fail = live && active;  // of an extension that was running
    int nx0 = 0, nx1 = 0, nx2 = 0;
    if (extend) {
      const int tk0 = cpk.x + (ck & 0xFF), tk1 = cpk.y + ((ck >> 8) & 0xFF),
                tk2 = cpk.z + ((ck >> 16) & 0xFF), tk3 = cpk.w + (ck >> 24);
      const int tl0 = cpl.x + (cl & 0xFF), tl1 = cpl.y + ((cl >> 8) & 0xFF),
                tl2 = cpl.z + ((cl >> 16) & 0xFF), tl3 = cpl.w + (cl >> 24);
      const int i = 3 - cs;  // complement base
      const int s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary));
      const int s2 = s3 + (tl3 - tk3);
      const int s1 = s2 + (tl2 - tk2);
      const int s0 = s1 + (tl1 - tk1);
      const int tki = pick4(i, tk0, tk1, tk2, tk3);
      const int tli = pick4(i, tl0, tl1, tl2, tl3);
      nx0 = pick4(i, s0, s1, s2, s3);
      nx1 = pick4(i, l2_0, l2_1, l2_2, l2_3) + 1 + tki;
      nx2 = tli - tki;
      ext_fail = nx2 == 0;
    }

    const int length = p - start;
    const bool freq_ok = length >= min_seed_len && x2 <= kOccThr;
    if (ext_fail && freq_ok && n_seeds < max_seeds) {
      if (j < 4) row[1 + j * max_seeds + n_seeds] = pick4(j, start, length, x0, x2);
      ++n_seeds;
    }

    const bool cont = extend && !ext_fail;
    const bool fail_restart = ext_fail && !freq_ok;
    // a lane idle at p, never started or just ended with a good seed, may
    // start its next extension at p in this same trip
    const bool can_start = live && !cont && !fail_restart && !amb && p < end_pos;
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
    // a failed seed sends p to MinSeed past its start, which can lie behind p
    if (live) p = fail_restart ? start + min_seed_len : p + 1;
    active = cont || can_start;
  }
  if (valid && j == 0) row[0] = n_seeds;
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers; occ_cp and
// bwt_words must be 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue where a block's reads of
// l_max bases and their seed rows exceed its shared memory.
extern "C" int kart_fm_seed_scan(const void* occ_cp, const void* bwt_words,
                                 const void* L2, int primary, const void* reads,
                                 const void* rlens, int B, int l_max,
                                 int min_seed_len, int max_seeds, void* out,
                                 void* stream) {
  if (B <= 0) return 0;
  const int code_words = l_max / 4 + 1;
  const size_t smem = sizeof(int) * kPerBlock * (1 + 4 * static_cast<size_t>(max_seeds) + code_words);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        seed_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  seed_scan_kernel<<<(B + kPerBlock - 1) / kPerBlock, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(occ_cp), static_cast<const unsigned*>(bwt_words),
      static_cast<const int*>(L2), primary, static_cast<const int*>(reads),
      static_cast<const int*>(rlens), B, l_max, min_seed_len, max_seeds, code_words,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// SensitiveMode scan.  reads: (B, width) int32 codes; out: (B, 1 +
// 4*max_seeds) int32, zeroed here; max_trips: the trip limit of the loop.
// One memset and one launch on the stream; returns the first CUDA error.
extern "C" int kart_fm_sensitive_scan(const void* occ_cp, const void* bwt_words,
                                      const void* L2, int primary, const void* reads,
                                      const void* rlens, int B, int width, int min_seed_len,
                                      int max_seeds, int max_trips, void* out, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(
      out, 0, sizeof(int) * static_cast<size_t>(B) * (1 + 4 * static_cast<size_t>(max_seeds)), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  sensitive_scan_kernel<<<(B + kPerBlock - 1) / kPerBlock, kThreads, 0, st>>>(
      static_cast<const int4*>(occ_cp), static_cast<const unsigned*>(bwt_words),
      static_cast<const int*>(L2), primary, static_cast<const int*>(reads),
      static_cast<const int*>(rlens), B, width, min_seed_len, max_seeds, max_trips,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
