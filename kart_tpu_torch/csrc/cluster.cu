// Seed clustering of the python backend's FastMode candidates for Hopper
// (sm_90a).
//
// Replaces kart_tpu/ops/cluster.py::cluster_illumina (kart_tpu/ops/cluster.py:27):
// the jnp kernel that ran one fori_loop over the S seed slots to give each
// seed its cluster id, a scatter-add for the clusters' scores and a second
// fori_loop over the cluster slots for the rising acceptance threshold.  The
// plain PyTorch version is kart_tpu_torch/ops/cluster.py::cluster_illumina_plain;
// the output is the same three (B, S) arrays: cluster_id (-1 for none),
// accept (bytes) and scores, both per cluster slot.
//
// The rules, per read, over its PosDiff-sorted seed slots t < S.  A seed is
// valid when t < n_seeds and pd >= 0 (an invalid seed keeps its slot and
// gets id -1).  A valid seed opens a cluster when it is the first valid
// seed, when gp > gend, or when pd - prev_pd > max_gaps, where prev_pd is
// the previous valid seed's posdiff and gend the chromosome end of the seed
// that opened the current cluster: the first chromosome key >= its gp (a
// left binary search), or 2**31 - 1 past the last key.  All of it is int32
// arithmetic that wraps, as the jnp kernel's.
//
// One warp a read.  The warp loads 32 seed slots at a time (coalesced: the
// arrays are row-major), and each lane finds its own seed's chromosome end
// and, with a ballot and a shuffle, its own posdiff break.  Only the gp >
// gend test is a chain (gend changes where a cluster opens), so the warp then
// walks the valid seeds of the 32 in order, three shuffles each, with the
// state of the open cluster (its id, gend, its score so far and the
// threshold) the same in every lane.  Cluster ids only grow along t, so a
// cluster's score is final when the next one opens: lane 0 then writes the
// score and the acceptance of that slot, and no scatter-add is needed.  The
// slots past the last cluster get score 0 and the acceptance the jnp scan
// gives a score of 0 (true only where the threshold is negative).  The
// chromosome keys (2 per chromosome) are searched where they lie in device
// memory; every read searches the same few, so they stay in L1.
//
// What bounds it on this card: the bytes, (B, S) int32 three times in and
// three arrays out, at a few tens of integer operations a slot; the chain
// is S in-order steps a read, all in registers (shuffles), with B reads in
// flight at once.  A simple kernel that is right: a later PR makes it fast
// (a chunk's walk could skip the seeds whose cluster is already decided by
// a posdiff break).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // reads a block
constexpr int kBig = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

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

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(32 * kWarps)
cluster_kernel(const int* __restrict__ keys, int K, const int* __restrict__ pd,
               const int* __restrict__ gp, const int* __restrict__ ln,
               const int* __restrict__ n_seeds, const int* __restrict__ thr0, int max_gaps,
               int B, int S, int* __restrict__ cluster_id, unsigned char* __restrict__ accept,
               int* __restrict__ scores) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no barrier follows
  const size_t row = static_cast<size_t>(b) * S;
  const int n = n_seeds[b];
  // the open cluster's state, the same in every lane
  int thr = thr0[b];
  int cid = -1;  // the open cluster's id; -1 before the first
  int gend = 0;
  unsigned score = 0;  // the open cluster's score so far (int32 that wraps)
  int prev_pd = 0;  // the last valid seed's posdiff before this chunk
  bool started = false;  // a valid seed before this chunk

  for (int base = 0; base < S; base += 32) {
    const int t = base + lane;
    const bool in = t < S;
    const int p = in ? pd[row + t] : 0;
    const int g = in ? gp[row + t] : 0;
    const int l = in ? ln[row + t] : 0;
    const bool v = in && t < n && p >= 0;
    const unsigned vmask = __ballot_sync(kFull, v);
    // the previous valid seed's posdiff: in this chunk, or carried in
    const unsigned below = vmask & ((1u << lane) - 1u);
    const int from = __shfl_sync(kFull, p, below ? 31 - __clz(static_cast<int>(below)) : 0);
    const bool had = below != 0 || started;
    const bool gap = !had || wrap_sub(p, below ? from : prev_pd) > max_gaps;
    const unsigned gapmask = __ballot_sync(kFull, v && gap);
    int lb = 0;
    if (v) lb = lower_bound(keys, K, g);
    const int end = lb < K ? keys[lb] : kBig;
    // in order over the valid seeds: does each open a cluster?
    const int cid0 = cid;
    unsigned newmask = 0;
    for (unsigned m = vmask; m; m &= m - 1) {
      const int j = __ffs(static_cast<int>(m)) - 1;
      const int gj = __shfl_sync(kFull, g, j);
      const int ej = __shfl_sync(kFull, end, j);
      const int lj = __shfl_sync(kFull, l, j);
      if (((gapmask >> j) & 1u) || gj > gend) {
        if (cid >= 0) {  // close the open cluster
          const int s = static_cast<int>(score);
          const bool a = s > thr;
          if (a && wrap_sub(s, 50) > thr) thr = wrap_sub(s, 50);
          if (lane == 0) {
            scores[row + cid] = s;
            accept[row + cid] = a;
          }
        }
        ++cid;
        gend = ej;
        score = 0;
        newmask |= 1u << j;
      }
      score += static_cast<unsigned>(lj);
    }
    if (in) {
      const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
      cluster_id[row + t] = v ? cid0 + __popc(newmask & upto) : -1;
    }
    if (vmask) {
      prev_pd = __shfl_sync(kFull, p, 31 - __clz(static_cast<int>(vmask)));
      started = true;
    }
  }
  if (cid >= 0) {
    const int s = static_cast<int>(score);
    const bool a = s > thr;
    if (a && wrap_sub(s, 50) > thr) thr = wrap_sub(s, 50);
    if (lane == 0) {
      scores[row + cid] = s;
      accept[row + cid] = a;
    }
  }
  // the slots past the last cluster: score 0, accepted where 0 > thr (a
  // score of 0 lifts a threshold below -50 to -50, which 0 still passes)
  for (int c = cid + 1 + lane; c < S; c += 32) {
    scores[row + c] = 0;
    accept[row + c] = thr < 0;
  }
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
  cluster_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(chr_keys), K, static_cast<const int*>(pd),
      static_cast<const int*>(gp), static_cast<const int*>(ln), static_cast<const int*>(n_seeds),
      static_cast<const int*>(thr0), max_gaps, B, S, static_cast<int*>(cluster_id),
      static_cast<unsigned char*>(accept), static_cast<int*>(scores));
  return static_cast<int>(cudaGetLastError());
}
