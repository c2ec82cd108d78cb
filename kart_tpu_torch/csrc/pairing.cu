// Paired-end candidate mating of the python backend for Hopper (sm_90a).
//
// Replaces kart_tpu/ops/pairing.py::pair_candidates (kart_tpu/ops/pairing.py:22):
// the jnp kernel that ran one fori_loop over the C1 read-1 slots, a masked
// max over the C2 read-2 slots of every pair at each step.  The plain
// PyTorch version is kart_tpu_torch/ops/pairing.py::pair_candidates_plain; the
// output is the same: paired1 (P, C1) and paired2 (P, C2), the mate's index
// or -1, and pairing (P,) bytes.
//
// The rules (kart_tpu/ops/pairing.py:22-70), per pair, for each read-1 slot
// i in order (slots of score 0 are absent): among the read-2 slots j with
// score2 > 0, pd2 >= pd1[i] and pd2 - pd1[i] < est (int32 that wraps), the
// one with the best score is i's mate if it is the only one with that score
// (a tie gives no mate).  i takes it if it is free, or if score1[i] is
// strictly greater than score1 of its current owner, who is then left
// without one; a pair whose read-1 slot took a mate is `pairing`, and so is
// one whose first read-1 score is negative (kart_tpu's carry starts as
// score1[:, 0] < 0).
//
// One warp a pair, in two parts.  The masked sweeps do not depend on one
// another, so every read-1 slot's unique best mate is found at once: a
// lane a slot (striding over C1), sweeping C2, keeping the first maximum as
// argmax does.  Only the decisions (free, steal, unlink) run in order, on
// lane 0, reading the choices, the links and score1 from the warp's shared
// memory; the warp then writes the links out once.  The first port's kernel
// swept C2 from device memory at each of the C1 in-order steps, with three
// warp reductions and lane 0's dependent reads of paired2[j] and
// score1[owner] from device memory inside the chain.
//
// A pair's state (score1, the choices and paired1: 3 * C1 ints; paired2:
// C2) lives in shared memory, kWarps pairs a block, fewer where they do not
// fit in 48 KB (one pair a block past that, up to the card's 227 KB, and a
// refusal beyond).  score2 and pd2, which every lane of the sweep reads
// (the same slot at once), are staged in shared memory beside it while the
// block's total stays within 48 KB, and read from device memory (L1) past
// that.
//
// What bounds it on this card: the bytes, the four (P, C) int32 inputs in and
// the outputs out once, at a few integer operations a (i, j) pair; the chain
// is C1 steps of two dependent shared-memory loads on lane 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // pairs a block, at most
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

template <bool kStage>
__global__ void __launch_bounds__(32 * kWarps)
pair_kernel(const int* __restrict__ score1, const int* __restrict__ pd1,
            const int* __restrict__ score2, const int* __restrict__ pd2, int est, int P, int C1,
            int C2, int per_pair, int* __restrict__ paired1, int* __restrict__ paired2,
            unsigned char* __restrict__ pairing) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + w;
  if (p >= P) return;  // the whole warp: no block barrier in this kernel
  int* const s1 = smem + static_cast<size_t>(w) * per_pair;
  int* const sel = s1 + C1;
  int* const m1 = sel + C1;
  int* const m2 = m1 + C1;
  const size_t r1 = static_cast<size_t>(p) * C1, r2 = static_cast<size_t>(p) * C2;
  for (int k = lane; k < C1; k += 32) s1[k] = score1[r1 + k];
  const int* s2 = score2 + r2;
  const int* d2 = pd2 + r2;
  if (kStage) {
    int* const ss2 = m2 + C2;
    int* const dd2 = ss2 + C2;
    for (int k = lane; k < C2; k += 32) {
      ss2[k] = s2[k];
      dd2[k] = d2[k];
    }
    s2 = ss2;
    d2 = dd2;
  }
  __syncwarp();
  // every slot's unique best mate, at once
  for (int i = lane; i < C1; i += 32) {
    int pick = -1;
    if (s1[i] > 0) {
      const int di = pd1[r1 + i];
      int best = 0, count = 0, first = -1;
      for (int j = 0; j < C2; ++j) {
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
      if (best > 0 && count == 1) pick = first;
    }
    sel[i] = pick;
    m1[i] = -1;
  }
  for (int j = lane; j < C2; j += 32) m2[j] = -1;
  __syncwarp();
  // the decisions in order
  if (lane == 0) {
    bool paired = C1 > 0 && s1[0] < 0;  // kart_tpu's carry starts so
    for (int i = 0; i < C1; ++i) {
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
    pairing[p] = paired;
  }
  __syncwarp();
  for (int i = lane; i < C1; i += 32) paired1[r1 + i] = m1[i];
  for (int j = lane; j < C2; j += 32) paired2[r2 + j] = m2[j];
}

template <bool kStage>
int launch_pair(const void* score1, const void* pd1, const void* score2, const void* pd2, int est,
                int P, int C1, int C2, int warps, int per_pair, void* paired1, void* paired2,
                void* pairing, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(warps) * per_pair * sizeof(int);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_kernel<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pair_kernel<kStage><<<(P + warps - 1) / warps, 32 * warps, smem, stream>>>(
      static_cast<const int*>(score1), static_cast<const int*>(pd1),
      static_cast<const int*>(score2), static_cast<const int*>(pd2), est, P, C1, C2, per_pair,
      static_cast<int*>(paired1), static_cast<int*>(paired2),
      static_cast<unsigned char*>(pairing));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  Pointers are device pointers: score1, pd1 (P, C1)
// and score2, pd2 (P, C2) int32 row-major; paired1 (P, C1), paired2 (P, C2)
// int32 and pairing (P,) bytes, all written.  Returns cudaErrorInvalidValue
// where one pair's state does not fit a block's shared memory (3 * C1 + C2
// ints past 227 KB), else cudaGetLastError() after the launch.
extern "C" int kart_pair_candidates(const void* score1, const void* pd1, const void* score2,
                                    const void* pd2, int est, int P, int C1, int C2,
                                    void* paired1, void* paired2, void* pairing, void* stream) {
  if (P <= 0) return 0;
  const size_t state = (3 * static_cast<size_t>(C1) + C2) * sizeof(int);
  if (state > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int warps = kWarps;
  while (warps > 1 && warps * state > kSmemDefault) warps >>= 1;
  const size_t staged = state + 2 * static_cast<size_t>(C2) * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warps * staged <= kSmemDefault)
    return launch_pair<true>(score1, pd1, score2, pd2, est, P, C1, C2, warps,
                             static_cast<int>(staged / sizeof(int)), paired1, paired2, pairing,
                             st);
  return launch_pair<false>(score1, pd1, score2, pd2, est, P, C1, C2, warps,
                            static_cast<int>(state / sizeof(int)), paired1, paired2, pairing, st);
}
