// Seed clustering of the python backend's FastMode candidates, and the
// multi-device front half's whole candidate tail, for Hopper (sm_90a).
//
// `kart_cluster_illumina` replaces kart_tpu/ops/cluster.py::cluster_illumina
// (kart_tpu/ops/cluster.py:27): the jnp kernel that ran one fori_loop over
// the S seed slots to give each seed its cluster id, a scatter-add for the
// clusters' scores and a second fori_loop over the cluster slots for the
// rising acceptance threshold.  Its plain PyTorch version is
// kart_tpu_torch/ops/cluster.py::cluster_illumina_plain; the output is the
// same three (B, S) arrays: cluster_id (-1 for none), accept (bytes) and
// scores, both per cluster slot.
//
// `kart_candidate_tail` replaces the candidate stretch of
// kart_tpu/parallel/dp.py::make_full_mapping_step (kart_tpu/parallel/dp.py:223-244):
// the threshold and padded posdiff of each read, cluster_illumina, the
// scatter-min of each cluster's posdiff, the candidates' scores and
// posdiffs, and pair_candidates over the (even, odd) rows.  Its plain
// version is kart_tpu_torch/parallel/dp.py::candidate_tail_plain (those
// lines, as eager torch ops).
//
// The rules (kart_tpu/ops/cluster.py:27-96), per read, over its
// PosDiff-sorted seed slots t < S.  A seed is valid when t < n_seeds and pd
// >= 0 (an invalid seed keeps its slot and gets id -1).  A valid seed opens
// a cluster when it is the first valid seed, when pd - prev_pd > max_gaps
// (prev_pd: the previous valid seed's), or when gp > gend, gend being the
// chromosome end of the seed that opened the current cluster: the first
// key >= its gp (a left binary search), or 2**31 - 1 past the last key.  A
// cluster's score is the wrapping int32 sum of its seeds' lengths; the
// threshold rises over the cluster slots in order (thr -> s - 50 where s >
// thr and s - 50 > thr, wrapping), and a slot is accepted where s > thr.
// The slots past the last cluster get score 0 and the acceptance the scan
// gives a score of 0 (thr < 0).
//
// Clustering alone: a warp a read, its 32-slot chunks by warp scans.
// Since the keys are sorted, gp > keys[lb_o] holds exactly when lb(gp) >
// lb_o (duplicate keys and a seed on a key included; lb_o == K never opens),
// so inside a run between two posdiff breaks the openers are the seeds
// whose lb is a strict running maximum of lb: a segmented prefix max over
// the lanes (five shuffle rounds), the run's max carried to the next chunk.
// A cluster's score is a segmented sum (int32 adds that wrap, in any order),
// and where s - 50 does not wrap the threshold's rule is thr = max(thr, s -
// 50), so cluster c is accepted when s_c > max(thr0, max over c' < c of
// s_c' - 50): a prefix max over the chunk's closing clusters.  A chunk that
// closes a cluster whose score lies below INT_MIN + 50 takes the rule in
// order (one shuffle a closing cluster).  The first port's kernel walked
// the valid seeds in order instead, three shuffles and a key search a seed.
//
// The candidate tail: one launch for a block of B reads (B even, the reads
// of pair p on rows 2p and 2p + 1), a thread a read.  A warp a read was
// issue-bound there (some 20 shuffle rounds a read, half the lanes idle at
// S 16; PERF.md), so a thread walks its read's slots in order, the
// rules as written, in a few instructions a slot.  Its rows in device memory
// are S slots apart, so a block of kReads reads first copies them into
// shared memory with consecutive threads on consecutive elements
// (`for_each_slot`, kPerRead threads a read; pd_in = present ? pd : 2**31 -
// 1 and gp narrowed to int32 as it copies), finds every slot's chromosome
// end at once, and each thread then walks its row there (an odd row stride:
// the walks are conflict-free), reading the next slot while it decides the
// current one and writing its outputs into the same row (a slot is written
// only after it is read); they are copied out the same way.  The walk also
// leaves each cluster slot's candidate score (the score where accepted,
// else 0) and posdiff (the least of its members', not the first's: the
// plain version is a scatter-min, and an unsorted edge input must match;
// clamped at 0 where accepted, else 0) in shared memory, slot by slot across
// the reads.  The pair's two threads then mate the two rows
// (kart_tpu/ops/pairing.py:22-70): each read-1 slot i with score1 > 0 takes,
// among the read-2 slots j with score2 > 0, pd2 >= pd1[i] and pd2 - pd1[i] <
// est (wrapping), the one of the best score if no other slot has it (the
// first maximum, as argmax); those choices do not depend on one another, so
// both threads make them (eight slots a sweep of the read-2 slots, bounded
// by each read's count of clusters: the slots past it score 0), and the
// pair's first thread makes the decisions in order from shared memory (i
// links to j if j is free or score1[i] is strictly greater than that of j's
// owner, who is left without a mate).  Nothing of the glue goes to device
// memory.
//
// What bounds both on this card: the bytes, at S 16 some 424 a read for the
// tail (thirteen a slot in, 17 out), at a few integer operations a slot.  The
// chromosome keys (2 a chromosome) are read where they lie in device memory
// by the warp kernel (every read searches the same few, so they stay in L1;
// `launch_cluster<true>` stages them in shared memory, and chip_smoke.py
// times both, also on 9,000 keys), and staged in shared memory by the tail
// where there are at most kKeysShared of them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBig = 0x7FFFFFFF;  // the chromosome end past the last key, the pad posdiff
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;         // reads a block of cluster_kernel (a warp each)
constexpr int kReads = 32;        // reads a block of the tail (a thread each)
constexpr int kPerRead = 4;       // threads a read of the tail for its copies
constexpr int kKeysShared = 512;  // chromosome keys the tail stages in shared memory
constexpr int kTailMax = 32;      // slots a read of the tail (F's s_occ at most)

// A timing hook of the tail kernel: phase k of a block ends at
// KART_TAIL_STAMP(k).  Nothing here; a probe that includes this file
// defines it first to record clock64() (chip_smoke.py's TAIL_STAMP_PROBE).
#ifndef KART_TAIL_STAMP
#define KART_TAIL_STAMP(k)
#endif

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// The first key >= x among keys[0, K) (sorted), as an index.
__device__ __forceinline__ int lower_bound(const int* keys, int K, int x) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// ---------------------------------------------------------------------------
// Clustering alone: a warp a read
// ---------------------------------------------------------------------------

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct AddOp {  // int32 that wraps
  __device__ __forceinline__ int operator()(int a, int b) const {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
};

// Inclusive scan of op over the lanes [seg, lane] (seg: the start of this
// lane's segment, the same for every lane of a segment).
template <class Op>
__device__ __forceinline__ int seg_scan(int x, int seg, int lane, Op op) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane - d >= seg) x = op(x, y);
  }
  return x;
}

// The start of each lane's segment, segments starting at the lanes of
// `starts`; a lane before the first start is in the segment of lane 0.
__device__ __forceinline__ int segment_of(unsigned starts, unsigned upto) {
  const unsigned s = starts & upto;
  return s ? 31 - __clz(static_cast<int>(s)) : 0;
}

template <bool kSmemKeys>
__global__ void __launch_bounds__(32 * kWarps)
cluster_kernel(const int* __restrict__ keys, int K, const int* __restrict__ pd,
               const int* __restrict__ gp, const int* __restrict__ ln,
               const int* __restrict__ n_seeds, const int* __restrict__ thr0, int max_gaps,
               int B, int S, int* __restrict__ cluster_id, unsigned char* __restrict__ accept,
               int* __restrict__ scores) {
  extern __shared__ int skeys[];
  const int* kk = keys;
  if (kSmemKeys) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) skeys[i] = keys[i];
    __syncthreads();
    kk = skeys;
  }
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no block barrier follows
  const size_t row = static_cast<size_t>(b) * S;
  const int lane = threadIdx.x & 31;
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;  // lanes <= this one
  const unsigned below = (1u << lane) - 1u;
  const int n = n_seeds[b];
  int thr = thr0[b];
  int ncl = 0;        // clusters opened before this chunk
  int lb_run = -1;    // the open cluster's opener's lb (the run's max)
  int score = 0;      // the open cluster's score so far
  int prev_pd = 0;    // the last valid seed's posdiff before this chunk
  bool started = false;
  for (int base = 0; base < S; base += 32) {
    const int t = base + lane;
    const bool in = t < S;
    const int p = in ? pd[row + t] : 0;
    const int g = in ? gp[row + t] : 0;
    const int l = in ? ln[row + t] : 0;
    const bool v = in && t < n && p >= 0;
    const unsigned vmask = __ballot_sync(kFull, v);
    // posdiff breaks: against the previous valid seed, in this chunk or carried in
    const unsigned vb = vmask & below;
    const int from = __shfl_sync(kFull, p, vb ? 31 - __clz(static_cast<int>(vb)) : 0);
    const bool gap = v && (!(vb || started) || wrap_sub(p, vb ? from : prev_pd) > max_gaps);
    const unsigned gapmask = __ballot_sync(kFull, gap);
    // chromosome breaks: lb a strict running max inside a run of breaks
    const int lb = v ? lower_bound(kk, K, g) : -1;
    const bool carry_lb = lane == 0 && !(gapmask & 1u);
    const int run = seg_scan(carry_lb ? MaxOp()(lb, lb_run) : lb, segment_of(gapmask, upto), lane,
                             MaxOp());
    const int run_up = __shfl_up_sync(kFull, run, 1);
    const bool open = v && (gap || lb > (lane == 0 ? lb_run : run_up));
    const unsigned newmask = __ballot_sync(kFull, open);
    lb_run = __shfl_sync(kFull, run, 31);
    const int c = ncl - 1 + __popc(newmask & upto);  // this seed's cluster
    if (in) cluster_id[row + t] = v ? c : -1;
    // each cluster's score: a sum segmented at the openers
    const bool carry_c = lane == 0 && !(newmask & 1u);
    const int lv = v ? l : 0;
    const int sum = seg_scan(carry_c ? AddOp()(lv, score) : lv, segment_of(newmask, upto), lane,
                             AddOp());
    const int sum_up = __shfl_up_sync(kFull, sum, 1);
    // an opener closes the cluster before its own
    const bool closes = open && c >= 1;
    const unsigned cmask = __ballot_sync(kFull, closes);
    if (cmask) {
      const int cs = lane == 0 ? score : sum_up;
      bool acc = false;
      if (__ballot_sync(kFull, closes && cs < INT_MIN + 50)) {
        for (unsigned m = cmask; m; m &= m - 1) {  // s - 50 wraps: in order
          const int j = __ffs(static_cast<int>(m)) - 1;
          const int s = __shfl_sync(kFull, cs, j);
          const bool a = s > thr;
          if (a && wrap_sub(s, 50) > thr) thr = wrap_sub(s, 50);
          if (lane == j) acc = a;
        }
      } else {
        const int lifted = seg_scan(closes ? cs - 50 : INT_MIN, 0, lane, MaxOp());
        const int lifted_up = __shfl_up_sync(kFull, lifted, 1);
        acc = cs > MaxOp()(thr, lane == 0 ? INT_MIN : lifted_up);
        thr = MaxOp()(thr, __shfl_sync(kFull, lifted, 31));
      }
      if (closes) {
        scores[row + c - 1] = cs;
        accept[row + c - 1] = acc;
      }
    }
    ncl += __popc(newmask);
    score = __shfl_sync(kFull, sum, 31);
    if (vmask) {
      prev_pd = __shfl_sync(kFull, p, 31 - __clz(static_cast<int>(vmask)));
      started = true;
    }
  }
  if (ncl > 0) {  // the last cluster
    const bool a = score > thr;
    if (a && wrap_sub(score, 50) > thr) thr = wrap_sub(score, 50);
    if (lane == 0) {
      scores[row + ncl - 1] = score;
      accept[row + ncl - 1] = a;
    }
  }
  // the slots past the last cluster: score 0, accepted where 0 > thr (a
  // score of 0 lifts a threshold below -50 to -50, which 0 still passes)
  for (int k = ncl + lane; k < S; k += 32) {
    scores[row + k] = 0;
    accept[row + k] = thr < 0;
  }
}

template <bool kSmemKeys>
int launch_cluster(const void* chr_keys, int K, const void* pd, const void* gp, const void* ln,
                   const void* n_seeds, const void* thr0, int max_gaps, int B, int S,
                   void* cluster_id, void* accept, void* scores, cudaStream_t stream) {
  const size_t smem = kSmemKeys ? static_cast<size_t>(K) * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_kernel<kSmemKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cluster_kernel<kSmemKeys><<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem, stream>>>(
      static_cast<const int*>(chr_keys), K, static_cast<const int*>(pd),
      static_cast<const int*>(gp), static_cast<const int*>(ln), static_cast<const int*>(n_seeds),
      static_cast<const int*>(thr0), max_gaps, B, S, static_cast<int*>(cluster_id),
      static_cast<unsigned char*>(accept), static_cast<int*>(scores));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The candidate tail: a thread a read, its rows staged in shared memory
// ---------------------------------------------------------------------------

// Element k at p[k * stride]: a read's candidate row, laid out slot by slot
// across the block's reads (conflict-free).
struct Strided {
  int* p;
  int stride;
  __device__ __forceinline__ int& operator[](int k) const { return p[k * stride]; }
};

// fn(f, r, t) for every element f = r * S + t of `rows` rows of S slots, the
// block's threads on consecutive f (coalesced in device memory); one
// division a thread, none a step.
template <class Fn>
__device__ __forceinline__ void for_each_slot(int rows, int S, Fn fn) {
  const int T = blockDim.x;
  int r = static_cast<int>(threadIdx.x) / S;
  int t = static_cast<int>(threadIdx.x) - r * S;
  const int dr = T / S, dt = T - dr * S;
  for (int f = threadIdx.x; f < rows * S; f += T) {
    fn(f, r, t);
    t += dt;
    r += dr;
    if (t >= S) {
      t -= S;
      ++r;
    }
  }
}

// One read's clustering by one thread, on its rows of shared memory: pd
// (pd_in), gp, ln and end (each slot's chromosome end).  Only slots t < n
// are read, the next one while the current one is decided.  Writes
// cid_row[0, S) (-1 for an invalid seed), per cluster slot sc_row and
// acc_row (0 or 1) and the candidate rows cand_sc, cand_pd; a slot of each
// row is written only after the same slot of the inputs is read, so they
// may be the inputs' own rows.  Returns the read's count of clusters.
__device__ __forceinline__ int cluster_thread(const int* pd, const int* gp, const int* ln,
                                              const int* end, int S, int n, int thr,
                                              int max_gaps, int* cid_row, int* acc_row,
                                              int* sc_row, Strided cand_sc, Strided cand_pd) {
  int cid = -1;      // the open cluster
  int gend = 0;      // its chromosome end
  int score = 0;     // its score so far (int32 that wraps)
  int pmin = kBig;   // its least posdiff so far
  int prev_pd = 0;   // the last valid seed's posdiff
  auto close = [&]() {
    const bool a = score > thr;
    if (a && wrap_sub(score, 50) > thr) thr = wrap_sub(score, 50);
    sc_row[cid] = score;
    acc_row[cid] = a;
    cand_sc[cid] = a ? score : 0;
    cand_pd[cid] = a ? (pmin > 0 ? pmin : 0) : 0;
  };
  const int m = n < S ? n : S;
  int p = 0, g = 0, l = 0, e = 0;
  if (m > 0) {
    p = pd[0];
    g = gp[0];
    l = ln[0];
    e = end[0];
  }
  for (int t = 0; t < m; ++t) {
    const int u = t + 1 < m ? t + 1 : t;  // the next slot, read before this one's writes
    const int pu = pd[u], gu = gp[u], lu = ln[u], eu = end[u];
    int id = -1;
    if (p >= 0) {
      if (cid < 0 || g > gend || wrap_sub(p, prev_pd) > max_gaps) {
        if (cid >= 0) close();
        ++cid;
        gend = e;
        score = 0;
        pmin = kBig;
      }
      score = static_cast<int>(static_cast<unsigned>(score) + static_cast<unsigned>(l));
      pmin = p < pmin ? p : pmin;
      prev_pd = p;
      id = cid;
    }
    cid_row[t] = id;
    p = pu;
    g = gu;
    l = lu;
    e = eu;
  }
  for (int t = m < 0 ? 0 : m; t < S; ++t) cid_row[t] = -1;
  if (cid >= 0) close();
  // the slots past the last cluster: score 0, accepted where 0 > thr (a
  // score of 0 lifts a threshold below -50 to -50, which 0 still passes)
  for (int c = cid + 1; c < S; ++c) {
    sc_row[c] = 0;
    acc_row[c] = thr < 0;
    cand_sc[c] = 0;
    cand_pd[c] = thr < 0 ? kBig : 0;
  }
  return cid + 1;
}

// Each read-1 slot's unique best mate into sel, by the pair's two threads
// (thread w takes slots w, w + 2, ...), eight slots a sweep of C2
// (independent chains); sel may be d1 itself (a sweep reads its slots of d1
// before it writes them).
__device__ __forceinline__ void mate_choose(int w, Strided s1, Strided d1, Strided s2, Strided d2,
                                            int C1, int C2, int est, Strided sel) {
  constexpr int kChunk = 8;
  for (int i0 = w; i0 < C1; i0 += 2 * kChunk) {
    int di[kChunk], best[kChunk], count[kChunk], first[kChunk];
    bool on[kChunk];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + 2 * k;
      on[k] = i < C1 && s1[i] > 0;
      di[k] = on[k] ? d1[i] : 0;
      best[k] = 0;
      count[k] = 0;
      first[k] = -1;
      any |= on[k];
    }
    for (int j = 0; any && j < C2; ++j) {
      const int s = s2[j];
      if (s <= 0) continue;  // absent: no slot takes it
      const int d = d2[j];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int sc = (on[k] && d >= di[k] && wrap_sub(d, di[k]) < est) ? s : 0;
        const bool up = sc > best[k];
        count[k] = up ? 1 : count[k] + (sc == best[k] && sc > 0);
        first[k] = up ? j : first[k];
        best[k] = up ? sc : best[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + 2 * k;
      if (i < C1) sel[i] = best[k] > 0 && count[k] == 1 ? first[k] : -1;
    }
  }
}

// The decisions in order (free, steal, unlink) from the choices of the
// slots i < n1 (the slots past them chose nothing), on one thread, reading
// the links and score1 from shared memory; the links go to m1 and m2 (S
// slots each).  Returns whether a read-1 slot took a mate, or the first
// read-1 score is negative.
__device__ __forceinline__ bool mate_decide(Strided s1, Strided sel, int n1, int S, Strided m1,
                                            Strided m2) {
  for (int k = 0; k < S; ++k) {
    m1[k] = -1;
    m2[k] = -1;
  }
  bool paired = s1[0] < 0;  // kart_tpu's carry starts as score1[:, 0] < 0
  for (int i = 0; i < n1; ++i) {
    const int j = sel[i];
    if (j < 0) continue;
    const int owner = m2[j];
    if (owner < 0 || s1[i] > s1[owner]) {
      if (owner >= 0) m1[owner] = -1;
      m1[i] = j;
      m2[j] = i;
      paired = true;
    }
  }
  return paired;
}

// floor((2 * rlen) / 10) capped at 50, in int32 that wraps, as the torch and
// jnp lines compute it
__device__ __forceinline__ int tail_thr0(int rlen) {
  const int a = static_cast<int>(static_cast<unsigned>(rlen) * 2u);
  int q = a / 10;
  if (a % 10 != 0 && a < 0) --q;
  return q < 50 ? q : 50;
}

// Registers for eight blocks an SM: phase 12's block of 32,000 reads (1,000
// blocks) runs in one wave on 132 SMs.
template <typename GP>
__global__ void __launch_bounds__(kPerRead * kReads, 8)
candidate_tail_kernel(const int* __restrict__ keys, int K, const int* __restrict__ n_occ,
                      const int* __restrict__ ln, const GP* __restrict__ gp,
                      const int* __restrict__ pd, const unsigned char* __restrict__ present,
                      const int* __restrict__ rlens, int max_gaps, int est, int B, int S,
                      int* __restrict__ cluster_id, unsigned char* __restrict__ accept,
                      int* __restrict__ scores, int* __restrict__ paired1,
                      int* __restrict__ paired2, unsigned char* __restrict__ pairing) {
  // the rows (stride kTailMax + 1, odd); each read's candidate scores and
  // posdiffs, slot k of read r at [k * kReads + r], where the mating then
  // keeps its choices (read 1's posdiffs) and links (read 2's rows); the
  // keys; each read's count of clusters
  constexpr int st = kTailMax + 1;
  __shared__ int spd[kReads * st], sgp[kReads * st], sln[kReads * st], send[kReads * st];
  __shared__ int cand_sc[kTailMax * kReads], cand_pd[kTailMax * kReads], skeys[kKeysShared],
      ncl[kReads];
  const int b0 = blockIdx.x * kReads;
  const int rows = B - b0 < kReads ? B - b0 : kReads;  // even
  const int r = threadIdx.x;  // the read this thread walks, if r < rows
  const size_t base = static_cast<size_t>(b0) * S;
  KART_TAIL_STAMP(0);
  int n = 0, thr = 0;
  if (r < rows) {  // issued before the copies
    n = n_occ[b0 + r];
    thr = tail_thr0(rlens[b0 + r]);
  }
  const int* kk = keys;
  if (K <= kKeysShared) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) skeys[i] = keys[i];
    kk = skeys;
  }
  for_each_slot(rows, S, [&](int f, int i, int t) {
    const int p = pd[base + f];
    spd[i * st + t] = present[base + f] ? p : kBig;
    sgp[i * st + t] = static_cast<int>(gp[base + f]);
    sln[i * st + t] = ln[base + f];
  });
  __syncthreads();
  for_each_slot(rows, S, [&](int, int i, int t) {  // every slot's chromosome end
    const int lb = lower_bound(kk, K, sgp[i * st + t]);
    send[i * st + t] = lb < K ? kk[lb] : kBig;
  });
  __syncthreads();
  KART_TAIL_STAMP(1);
  if (r < rows) {  // cluster_id into pd's row, accept into ln's, scores into gp's
    int* const rp = spd + r * st;
    int* const rg = sgp + r * st;
    int* const rl = sln + r * st;
    ncl[r] = cluster_thread(rp, rg, rl, send + r * st, S, n, thr, max_gaps, rp, rl, rg,
                            Strided{cand_sc + r, kReads}, Strided{cand_pd + r, kReads});
  }
  __syncthreads();
  KART_TAIL_STAMP(2);
  for_each_slot(rows, S, [&](int f, int i, int t) {
    cluster_id[base + f] = spd[i * st + t];
    accept[base + f] = static_cast<unsigned char>(sln[i * st + t]);
    scores[base + f] = sgp[i * st + t];
  });
  KART_TAIL_STAMP(3);
  // pair q of the block on the walkers' lanes 2q (read 1) and 2q + 1; a
  // read's candidate slots past its clusters score 0: none chooses or is chosen
  const int q = r >> 1;
  const bool live = r < rows;
  const Strided s1{cand_sc + 2 * q, kReads}, d1{cand_pd + 2 * q, kReads};
  const Strided s2{cand_sc + 2 * q + 1, kReads}, d2{cand_pd + 2 * q + 1, kReads};
  const int n1 = live ? ncl[2 * q] : 0, n2 = live ? ncl[2 * q + 1] : 0;
  if (live) mate_choose(r & 1, s1, d1, s2, d2, n1, n2, est, d1);
  __syncthreads();
  KART_TAIL_STAMP(4);
  if (live && !(r & 1)) pairing[(b0 >> 1) + q] = mate_decide(s1, d1, n1, S, d2, s2);
  __syncthreads();
  KART_TAIL_STAMP(5);
  // the links: paired1 from read 2's posdiffs, paired2 from its scores
  const size_t pbase = static_cast<size_t>(b0 >> 1) * S;
  for_each_slot(rows >> 1, S, [&](int f, int pq, int t) {
    paired1[pbase + f] = cand_pd[t * kReads + 2 * pq + 1];
    paired2[pbase + f] = cand_sc[t * kReads + 2 * pq + 1];
  });
  KART_TAIL_STAMP(6);
}

template <typename GP>
int launch_tail(const void* chr_keys, int K, const void* n_occ, const void* ln, const void* gp,
                const void* pd, const void* present, const void* rlens, int max_gaps, int est,
                int B, int S, void* cluster_id, void* accept, void* scores, void* paired1,
                void* paired2, void* pairing, cudaStream_t stream) {
  if (B % 2 || S < 1 || S > kTailMax) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  candidate_tail_kernel<GP><<<(B + kReads - 1) / kReads, kPerRead * kReads, 0, stream>>>(
      static_cast<const int*>(chr_keys), K, static_cast<const int*>(n_occ),
      static_cast<const int*>(ln), static_cast<const GP*>(gp), static_cast<const int*>(pd),
      static_cast<const unsigned char*>(present), static_cast<const int*>(rlens), max_gaps, est,
      B, S, static_cast<int*>(cluster_id), static_cast<unsigned char*>(accept),
      static_cast<int*>(scores), static_cast<int*>(paired1), static_cast<int*>(paired2),
      static_cast<unsigned char*>(pairing));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers: chr_keys (K,)
// int32 sorted; pd, gp, ln (B, S) int32 row-major; n_seeds, thr0 (B,) int32;
// cluster_id, scores (B, S) int32 and accept (B, S) bytes, all written.
// Returns cudaGetLastError() after the launch.
extern "C" int kart_cluster_illumina(const void* chr_keys, int K, const void* pd, const void* gp,
                                     const void* ln, const void* n_seeds, const void* thr0,
                                     int max_gaps, int B, int S, void* cluster_id, void* accept,
                                     void* scores, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  return launch_cluster<false>(chr_keys, K, pd, gp, ln, n_seeds, thr0, max_gaps, B, S, cluster_id,
                               accept, scores, static_cast<cudaStream_t>(stream));
}

// The front half's candidate tail of a block of B reads (B even; rows 2p
// and 2p + 1 are pair p), from F's outputs.  Pointers are device pointers:
// chr_keys (K,) int32 sorted; n_occ (B,) int32; ln, pd (B, S) int32; gp
// (B, S) int32 (int64 for the _i64 entry); present (B, S) bytes; rlens (B,)
// int32.  Writes cluster_id, scores (B, S) int32, accept (B, S) bytes,
// paired1, paired2 (B / 2, S) int32 and pairing (B / 2,) bytes.  1 <= S <=
// 32.  Returns cudaErrorInvalidValue for an odd B or S out of range, else
// cudaGetLastError() after the launch.
extern "C" int kart_candidate_tail(const void* chr_keys, int K, const void* n_occ, const void* ln,
                                   const void* gp, const void* pd, const void* present,
                                   const void* rlens, int max_gaps, int est, int B, int S,
                                   void* cluster_id, void* accept, void* scores, void* paired1,
                                   void* paired2, void* pairing, void* stream) {
  return launch_tail<int>(chr_keys, K, n_occ, ln, gp, pd, present, rlens, max_gaps, est, B, S,
                          cluster_id, accept, scores, paired1, paired2, pairing,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int kart_candidate_tail_i64(const void* chr_keys, int K, const void* n_occ,
                                       const void* ln, const void* gp, const void* pd,
                                       const void* present, const void* rlens, int max_gaps,
                                       int est, int B, int S, void* cluster_id, void* accept,
                                       void* scores, void* paired1, void* paired2, void* pairing,
                                       void* stream) {
  return launch_tail<long long>(chr_keys, K, n_occ, ln, gp, pd, present, rlens, max_gaps, est, B,
                                S, cluster_id, accept, scores, paired1, paired2, pairing,
                                static_cast<cudaStream_t>(stream));
}
