// Sampled-SA resolution of a list of SA rows for Hopper (sm_90a), on the
// replicated index and on the block-sharded one.
//
// Replaces kart_tpu/ops/fm_search.py::sa_walk with inv_psi and bwt_char: the
// jnp while-loop that stepped every row of the batch until all had reached a
// sampled row (or max_steps).  The plain PyTorch version is
// kart_tpu_torch/ops/fm_search.py::sa_walk_plain; the output is the same
// (pos, done) per row: pos = steps + sa_samples[row >> 5] also for a walk
// that max_steps cut, and done whether it reached a sample.
//
// Also replaces kart_tpu/parallel/sharded_index.py::sharded_sa_walk with
// sharded_inv_psi_batch and its sample gather where one device holds every
// shard (kart_sharded_sa_walk): the same loop through the shard table
// (fm_index.cuh's ShardedIndex), each step's block and the sample at the
// walk's end read from the owner's slabs, in one launch.  Its plain version
// is parallel/sharded_index.py::resident_sa_walk_plain.
//
// One thread a row walks it alone (fm_index.cuh); no row waits for another.
// What bounds it on this card: a chain of dependent loads, not bytes.  A
// walk's length is geometric with mean 32, so the slowest of H rows takes
// about 32 ln H steps (some 370 at H = 96,000), each a load that hits L2
// and the step's instructions after it (fm_index.cuh's inv_psi_at); the
// launch puts every row in flight at once (a 96,000-row list is 750 blocks
// of 128, under six an SM), so the time is about the longest walk's, its
// first steps slowed by every other row's loads.  Through the shard table
// a step adds the owner's reciprocal multiply and a read of shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"

namespace {

constexpr int kWalkThreads = 128;

template <typename T, typename Ix>
__global__ void __launch_bounds__(kWalkThreads)
sa_walk_kernel(FmWalk<T, Ix> fm, const T* __restrict__ L2, const T* __restrict__ rows, int n,
               int max_steps, T* __restrict__ pos, unsigned char* __restrict__ done) {
  extern __shared__ int smem[];
  FmWalk<T, Ix> f = fm;
  f.ix.stage(smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  load_l2(f, L2);
  bool d;
  pos[i] = sa_walk_row(f, __ldg(rows + i), max_steps, d);
  done[i] = d;
}

template <typename T, typename Ix>
int launch_sa_walk(const Ix& ix, int n_shards, const void* L2, long long primary,
                   const void* rows, int n, int max_steps, void* pos, void* done, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = Ix::smem_bytes(n_shards);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  FmWalk<T, Ix> fm;
  fm.ix = ix;
  fm.primary = static_cast<T>(primary);
  sa_walk_kernel<T, Ix><<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      fm, static_cast<const T*>(L2), static_cast<const T*>(rows), n, max_steps,
      static_cast<T*>(pos), static_cast<unsigned char*>(done));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flat_walk(const void* occ_cp, const void* bwt_words, const void* L2, const void* sa_samples,
              long long primary, const void* rows, int n, int max_steps, void* pos, void* done,
              void* stream) {
  FlatIndex<T> ix;
  ix.occ_cp = static_cast<const typename CpRow<T>::type*>(occ_cp);
  ix.bwt4 = static_cast<const uint4*>(bwt_words);
  ix.sa_samples = static_cast<const T*>(sa_samples);
  return launch_sa_walk<T>(ix, 0, L2, primary, rows, n, max_steps, pos, done, stream);
}

template <typename T>
int sharded_walk(const void* table, int n_shards, long long nb_local, long long nsamp_local,
                 const void* L2, long long primary, const void* rows, int n, int max_steps,
                 void* pos, void* done, void* stream) {
  ShardedIndex<T> ix;
  ix.table = static_cast<const ShardSlabs<T>*>(table);
  ix.n_shards = n_shards;
  ix.set_blocks(static_cast<unsigned>(nb_local));
  ix.nsamp_local = static_cast<unsigned>(nsamp_local);
  return launch_sa_walk<T>(ix, n_shards, L2, primary, rows, n, max_steps, pos, done, stream);
}

}  // namespace

// Plain C entries for ctypes, one an index type.  Pointers are device
// pointers: occ_cp (n_blocks*4,), L2 (5,), sa_samples, rows (n,) and pos (n,)
// of the index type, bwt_words (n_blocks*8,) 32-bit words 16-byte aligned,
// done (n,) bytes.  Returns cudaGetLastError() after the launch.
extern "C" int kart_sa_walk(const void* occ_cp, const void* bwt_words, const void* L2,
                            const void* sa_samples, int primary, const void* rows, int n,
                            int max_steps, void* pos, void* done, void* stream) {
  return flat_walk<int>(occ_cp, bwt_words, L2, sa_samples, primary, rows, n, max_steps, pos, done,
                        stream);
}

extern "C" int kart_sa_walk_i64(const void* occ_cp, const void* bwt_words, const void* L2,
                                const void* sa_samples, long long primary, const void* rows,
                                int n, int max_steps, void* pos, void* done, void* stream) {
  return flat_walk<long long>(occ_cp, bwt_words, L2, sa_samples, primary, rows, n, max_steps, pos,
                              done, stream);
}

// The walk on the block-sharded index, every shard on this device: table
// (n_shards, 4) 64-bit words, shard s's occ_cp, bwt_words, sa_samples and
// sa_full slab pointers (none of the first three null; the walk reads no
// full SA), nb_local blocks and nsamp_local sampled rows a slab; L2, rows,
// pos and done as above.  cudaErrorInvalidValue where the table exceeds
// 48 KB of shared memory (some 1,500 shards).
extern "C" int kart_sharded_sa_walk(const void* table, int n_shards, long long nb_local,
                                    long long nsamp_local, const void* L2, int primary,
                                    const void* rows, int n, int max_steps, void* pos, void* done,
                                    void* stream) {
  return sharded_walk<int>(table, n_shards, nb_local, nsamp_local, L2, primary, rows, n,
                           max_steps, pos, done, stream);
}

extern "C" int kart_sharded_sa_walk_i64(const void* table, int n_shards, long long nb_local,
                                        long long nsamp_local, const void* L2, long long primary,
                                        const void* rows, int n, int max_steps, void* pos,
                                        void* done, void* stream) {
  return sharded_walk<long long>(table, n_shards, nb_local, nsamp_local, L2, primary, rows, n,
                                 max_steps, pos, done, stream);
}
