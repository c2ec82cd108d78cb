// Host stand-ins for the CUDA constructs that the port's kernels use, so
// that a .cu source, run through translate.py, compiles as C++20 and runs
// on the CPU: a block's threads are std::threads, __syncthreads a
// std::barrier, a warp's shuffles and ballots an exchange array with a
// barrier per warp, atomics std::atomic_ref.  A launch with a cluster
// attribute runs the blocks of one cluster at the same time, cluster.sync()
// being a barrier over all their threads and map_shared_rank a pointer at
// the same offset of the peer block's shared-memory arena; a plain launch
// runs kConcurrentBlocks blocks at a time, so that blocks which wait for one
// another through global memory (a chained scan) make progress.  A thread
// that waits at a barrier for more than kStallSeconds aborts the process.
//
// This checks a kernel's arithmetic, indexing and barrier placement against
// its plain version without a card.  It cannot show that nvcc accepts the
// source, nor any ordering fault of the real memory model.

#pragma once

#include <atomic>
#include <algorithm>
#include <barrier>
#include <chrono>
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint3 {
  unsigned x, y, z;
};

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaLaunchAttributeClusterDimension = 4;

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

namespace shim {

constexpr int kConcurrentBlocks = 4;
constexpr int kStallSeconds = 20;
constexpr size_t kStaticArena = 16 * 1024;

// A barrier whose wait aborts the process when it stalls.
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    const unsigned long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lk, std::chrono::seconds(kStallSeconds), [&] { return gen_ != gen; })) {
      std::fprintf(stderr, "cuda_shim: a barrier of %d threads stalled (%d arrived)\n", n_, count_);
      std::abort();
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  int n_, count_ = 0;
  unsigned long gen_ = 0;
};

struct Warp {
  Barrier bar{32};
  long long slot[32];
};

struct ClusterCtx {
  int n_blocks;
  std::unique_ptr<Barrier> bar;
  std::vector<struct BlockCtx*> blocks;
};

struct BlockCtx {
  int n_threads;
  uint3 block_idx;
  int rank = 0;  // in its cluster
  ClusterCtx* cluster = nullptr;
  std::unique_ptr<Barrier> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<char> arena;  // dynamic shared memory, then the static variables
  size_t dyn_bytes = 0;
  std::mutex m;
  std::map<int, size_t> statics;  // source line -> offset of the variable
  size_t static_used = 0;
  std::atomic<int> vote{0};
};

struct ThreadCtx {
  BlockCtx* blk;
  uint3 tid;
};
inline thread_local ThreadCtx tc;

inline char* dyn_smem() { return tc.blk->arena.data(); }

// The block's instance of the `__shared__` variable declared at `line`.
template <typename T>
T* static_smem(int line, size_t count) {
  BlockCtx* b = tc.blk;
  std::lock_guard<std::mutex> lk(b->m);
  auto it = b->statics.find(line);
  if (it == b->statics.end()) {
    size_t off = (b->static_used + alignof(T) - 1) / alignof(T) * alignof(T);
    if (off + sizeof(T) * count > kStaticArena) {
      std::fprintf(stderr, "cuda_shim: static shared memory exceeds the arena\n");
      std::abort();
    }
    b->static_used = off + sizeof(T) * count;
    it = b->statics.emplace(line, b->dyn_bytes + off).first;
  }
  return reinterpret_cast<T*>(b->arena.data() + it->second);
}

template <typename K, typename... Args>
void run_block(K kernel, BlockCtx* b, dim3 grid, dim3 block, Args... args) {
  std::vector<std::thread> ths;
  ths.reserve(b->n_threads);
  for (int t = 0; t < b->n_threads; ++t) {
    ths.emplace_back([=] {
      tc.blk = b;
      tc.tid = threadIdx = uint3{(unsigned)t, 0, 0};
      blockIdx = b->block_idx;
      blockDim = block;
      gridDim = grid;
      kernel(args...);
    });
  }
  for (auto& th : ths) th.join();
}

// Runs blocks [first, first + n) of the grid at the same time; with
// `cluster` they are the blocks of one cluster.
template <typename K, typename... Args>
void run_blocks(K kernel, dim3 grid, dim3 block, size_t smem, unsigned first, unsigned n,
                bool cluster, Args... args) {
  if (block.x % 32) {
    std::fprintf(stderr, "cuda_shim: %u threads a block is not a multiple of 32\n", block.x);
    std::abort();
  }
  ClusterCtx cl;
  cl.n_blocks = cluster ? (int)n : 1;
  cl.bar = std::make_unique<Barrier>((int)(n * block.x));
  std::vector<std::unique_ptr<BlockCtx>> blocks;
  for (unsigned i = 0; i < n; ++i) {
    auto b = std::make_unique<BlockCtx>();
    b->n_threads = (int)block.x;
    b->block_idx = uint3{first + i, 0, 0};
    b->rank = cluster ? (int)i : 0;
    b->cluster = cluster ? &cl : nullptr;
    b->bar = std::make_unique<Barrier>((int)block.x);
    for (unsigned w = 0; w < block.x / 32; ++w) b->warps.push_back(std::make_unique<Warp>());
    b->dyn_bytes = (smem + 15) / 16 * 16;
    b->arena.assign(b->dyn_bytes + kStaticArena, (char)0xCD);  // shared memory starts as garbage
    cl.blocks.push_back(b.get());
    blocks.push_back(std::move(b));
  }
  std::vector<std::thread> runners;
  for (unsigned i = 0; i < n; ++i)
    runners.emplace_back([&, i] { run_block(kernel, blocks[i].get(), grid, block, args...); });
  for (auto& r : runners) r.join();
}

template <typename K, typename... Args>
void launch(K kernel, dim3 grid, dim3 block, size_t smem, Args... args) {
  for (unsigned first = 0; first < grid.x; first += kConcurrentBlocks)
    run_blocks(kernel, grid, block, smem, first,
               std::min<unsigned>(kConcurrentBlocks, grid.x - first), false, args...);
}

}  // namespace shim


using std::max;
using std::min;

inline void __syncthreads() { shim::tc.blk->bar->wait(); }

inline int __syncthreads_or(int v) {
  shim::BlockCtx* b = shim::tc.blk;
  if (v) b->vote.store(1);
  b->bar->wait();
  const int r = b->vote.load();
  b->bar->wait();
  if (shim::tc.tid.x == 0) b->vote.store(0);
  b->bar->wait();
  return r;
}

namespace shim {
// Every lane of the warp calls this with its value and gets all 32.
inline void warp_exchange(long long v, long long out[32]) {
  Warp* w = tc.blk->warps[tc.tid.x >> 5].get();
  w->slot[tc.tid.x & 31] = v;
  w->bar.wait();
  for (int i = 0; i < 32; ++i) out[i] = w->slot[i];
  w->bar.wait();
}
}  // namespace shim

inline int __shfl_up_sync(unsigned, int v, int delta) {
  long long all[32];
  shim::warp_exchange(v, all);
  const int lane = threadIdx.x & 31;
  return lane >= delta ? (int)all[lane - delta] : v;
}

inline int __shfl_xor_sync(unsigned, int v, int mask) {
  long long all[32];
  shim::warp_exchange(v, all);
  return (int)all[(threadIdx.x & 31) ^ mask];
}

inline unsigned __ballot_sync(unsigned, bool pred) {
  long long all[32];
  shim::warp_exchange(pred, all);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)(all[i] != 0) << i;
  return r;
}

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return (unsigned)(((((unsigned long long)hi) << 32) | lo) >> (sh & 31));
}

inline unsigned atomicOr(unsigned* p, unsigned v) { return std::atomic_ref<unsigned>(*p).fetch_or(v); }
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline unsigned long long atomicExch(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).exchange(v);
}

namespace cooperative_groups {
struct cluster_group {
  static unsigned num_blocks() { return shim::tc.blk->cluster ? shim::tc.blk->cluster->n_blocks : 1; }
  static unsigned block_rank() { return shim::tc.blk->rank; }
  static void sync() {
    shim::BlockCtx* b = shim::tc.blk;
    if (b->cluster) b->cluster->bar->wait(); else b->bar->wait();
  }
  template <typename T>
  static T* map_shared_rank(T* p, unsigned rank) {
    shim::BlockCtx* b = shim::tc.blk;
    const ptrdiff_t off = reinterpret_cast<char*>(p) - b->arena.data();
    if (off < 0 || (size_t)off >= b->arena.size()) {
      std::fprintf(stderr, "cuda_shim: map_shared_rank of a pointer outside shared memory\n");
      std::abort();
    }
    if (!b->cluster) return p;
    if (rank >= (unsigned)b->cluster->n_blocks) {
      std::fprintf(stderr, "cuda_shim: map_shared_rank to rank %u of %d\n", rank, b->cluster->n_blocks);
      std::abort();
    }
    return reinterpret_cast<T*>(b->cluster->blocks[rank]->arena.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// ---- runtime calls ---------------------------------------------------------

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}

struct cudaLaunchAttribute {
  int id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};

template <typename K, typename... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, Args... args) {
  unsigned c = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) c = cfg->attrs[i].val.clusterDim.x;
  if (cfg->gridDim.x % c) return cudaErrorInvalidValue;
  for (unsigned first = 0; first < cfg->gridDim.x; first += c)
    shim::run_blocks(kernel, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, first, c, c > 1,
                     args...);
  return cudaSuccess;
}
