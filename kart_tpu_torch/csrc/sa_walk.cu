// Sampled-SA resolution of a list of SA rows for Hopper (sm_90a).
//
// Replaces kart_tpu/ops/fm_search.py::sa_walk with inv_psi and bwt_char: the
// jnp while-loop that stepped every row of the batch until all had reached a
// sampled row (or max_steps).  The plain PyTorch version is
// kart_tpu_torch/ops/fm_search.py::sa_walk_plain; the output is the same
// (pos, done) per row: pos = steps + sa_samples[row >> 5] also for a walk
// that max_steps cut, and done whether it reached a sample.
//
// One thread a row walks it alone (fm_index.cuh); no row waits for another.
// What bounds it on this card: a chain of dependent loads, not bytes.  A
// walk's length is geometric with mean 32, so the slowest of H rows takes
// about 32 ln H steps (some 370 at H = 96,000), each a load that hits L2;
// the launch puts every row in flight at once (a 96,000-row list is 750
// blocks of 128, under six an SM), so the time is about the longest walk's.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"

namespace {

constexpr int kWalkThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
sa_walk_kernel(FmWalk<T> fm, const T* __restrict__ L2, const T* __restrict__ rows, int n,
               int max_steps, T* __restrict__ pos, unsigned char* __restrict__ done) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  FmWalk<T> f = fm;
  load_l2(f, L2);
  bool d;
  pos[i] = sa_walk_row(f, __ldg(rows + i), max_steps, d);
  done[i] = d;
}

template <typename T>
int launch_sa_walk(const void* occ_cp, const void* bwt_words, const void* L2,
                   const void* sa_samples, long long primary, const void* rows, int n,
                   int max_steps, void* pos, void* done, void* stream) {
  if (n <= 0) return 0;
  FmWalk<T> fm;
  fm.occ_cp = static_cast<const typename CpRow<T>::type*>(occ_cp);
  fm.bwt4 = static_cast<const uint4*>(bwt_words);
  fm.sa_samples = static_cast<const T*>(sa_samples);
  fm.primary = static_cast<T>(primary);
  sa_walk_kernel<T><<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      fm, static_cast<const T*>(L2), static_cast<const T*>(rows), n, max_steps,
      static_cast<T*>(pos), static_cast<unsigned char*>(done));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one an index type.  Pointers are device
// pointers: occ_cp (n_blocks*4,), L2 (5,), sa_samples, rows (n,) and pos (n,)
// of the index type, bwt_words (n_blocks*8,) 32-bit words 16-byte aligned,
// done (n,) bytes.  Returns cudaGetLastError() after the launch.
extern "C" int kart_sa_walk(const void* occ_cp, const void* bwt_words, const void* L2,
                            const void* sa_samples, int primary, const void* rows, int n,
                            int max_steps, void* pos, void* done, void* stream) {
  return launch_sa_walk<int>(occ_cp, bwt_words, L2, sa_samples, primary, rows, n, max_steps,
                             pos, done, stream);
}

extern "C" int kart_sa_walk_i64(const void* occ_cp, const void* bwt_words, const void* L2,
                                const void* sa_samples, long long primary, const void* rows,
                                int n, int max_steps, void* pos, void* done, void* stream) {
  return launch_sa_walk<long long>(occ_cp, bwt_words, L2, sa_samples, primary, rows, n,
                                   max_steps, pos, done, stream);
}
