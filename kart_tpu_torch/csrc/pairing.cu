// Paired-end candidate mating of the python backend for Hopper (sm_90a).
//
// Replaces kart_tpu/ops/pairing.py::pair_candidates (kart_tpu/ops/pairing.py:22):
// the jnp kernel that ran one fori_loop over the C1 read-1 slots, a masked
// max over the C2 read-2 slots of every pair at each step.  The plain
// PyTorch version is kart_tpu_torch/ops/pairing.py::pair_candidates_plain; the
// output is the same: paired1 (P, C1) and paired2 (P, C2), the mate's index
// or -1, and pairing (P,) bytes.
//
// The rules, per pair, for each read-1 slot i in order (slots of score 0 are
// absent): among the read-2 slots j with score2 > 0, pd2 >= pd1[i] and
// pd2 - pd1[i] < est (int32 that wraps, as the jnp kernel's), the one with
// the best score is i's mate if it is the only one with that score (a tie
// gives no mate).  i takes it if it is free, or if score1[i] is strictly
// greater than score1 of its current owner, who is then left without one;
// a pair whose read-1 slot took a mate is `pairing`.
//
// One warp a pair.  At each step the lanes stride over C2 (so any C2 works),
// each keeping the best masked score it saw, how many times it saw it and
// the first slot it saw it at; three warp reductions (__reduce_max_sync,
// __reduce_add_sync, __reduce_min_sync) give the best score, the count of
// slots that hold it and its first slot.  Lane 0 then makes the step's one
// decision.  paired1 and paired2 of the pair are kept in the output arrays
// (only lane 0 touches them after the warp has set them to -1).
//
// What bounds it on this card: the bytes, the four (P, C) int32 inputs in and
// the outputs out once, at a few integer operations a (i, j) pair; the chain
// is C1 in-order steps a pair, each a sweep of C2 / 32 loads a lane (they hit
// L1 after the first step), three reductions and lane 0's dependent reads of
// paired2[j] and of the owner's score.  P pairs run at once.  A simple kernel
// that is right: a later PR makes it fast (the masked scores of a step do not
// depend on the step before, so the sweeps of all C1 steps could run at once
// and only the decisions in order).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // pairs a block
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32 * kWarps)
pair_kernel(const int* __restrict__ score1, const int* __restrict__ pd1,
            const int* __restrict__ score2, const int* __restrict__ pd2, int est, int P, int C1,
            int C2, int* __restrict__ paired1, int* __restrict__ paired2,
            unsigned char* __restrict__ pairing) {
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + w;
  if (p >= P) return;  // the whole warp: no block barrier in this kernel
  int* const m1 = paired1 + static_cast<size_t>(p) * C1;
  int* const m2 = paired2 + static_cast<size_t>(p) * C2;
  const int* const s1 = score1 + static_cast<size_t>(p) * C1;
  const int* const d1 = pd1 + static_cast<size_t>(p) * C1;
  const int* const s2 = score2 + static_cast<size_t>(p) * C2;
  const int* const d2 = pd2 + static_cast<size_t>(p) * C2;
  for (int k = lane; k < C1; k += 32) m1[k] = -1;
  for (int k = lane; k < C2; k += 32) m2[k] = -1;
  __syncwarp();
  bool paired = false;  // lane 0's
  for (int i = 0; i < C1; ++i) {
    const int si = s1[i];
    if (si <= 0) continue;  // the same in every lane
    const int di = d1[i];
    int best = 0, count = 0, first = INT_MAX;
    for (int j = lane; j < C2; j += 32) {
      const int s = s2[j];
      const int d = d2[j];
      const int dist = static_cast<int>(static_cast<unsigned>(d) - static_cast<unsigned>(di));
      const int sc = (s > 0 && d >= di && dist < est) ? s : 0;
      if (sc > best) {
        best = sc;
        count = 1;
        first = j;
      } else if (sc == best && sc > 0) {
        ++count;
      }
    }
    const int top = __reduce_max_sync(kFull, best);
    if (top <= 0) continue;
    const int n_top = __reduce_add_sync(kFull, best == top ? count : 0);
    if (n_top != 1) continue;
    const int j = __reduce_min_sync(kFull, best == top ? first : INT_MAX);
    if (lane == 0) {
      const int owner = m2[j];
      if (owner < 0 || si > s1[owner]) {
        if (owner >= 0) m1[owner] = -1;
        m1[i] = j;
        m2[j] = i;
        paired = true;
      }
    }
  }
  if (lane == 0) pairing[p] = paired;
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers: score1, pd1 (P, C1)
// and score2, pd2 (P, C2) int32 row-major; paired1 (P, C1), paired2 (P, C2)
// int32 and pairing (P,) bytes, all written.  Returns cudaGetLastError()
// after the launch.
extern "C" int kart_pair_candidates(const void* score1, const void* pd1, const void* score2,
                                    const void* pd2, int est, int P, int C1, int C2,
                                    void* paired1, void* paired2, void* pairing, void* stream) {
  if (P <= 0) return 0;
  pair_kernel<<<(P + kWarps - 1) / kWarps, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(score1), static_cast<const int*>(pd1),
      static_cast<const int*>(score2), static_cast<const int*>(pd2), est, P, C1, C2,
      static_cast<int*>(paired1), static_cast<int*>(paired2),
      static_cast<unsigned char*>(pairing));
  return static_cast<int>(cudaGetLastError());
}
