// Row gather for Hopper (sm_90a): out[i, :] = table[rid[i], :] for a
// (n_rows, 128) int32 table and (n_out,) int32 row ids in [0, n_rows),
// byte-equal to the plain version `table[rid]`
// (kart_tpu_torch/tools/bench_gather.py).
//
// Replaces the Pallas probe kernel of tools/bench_gather.py:208 (`pallas_dma`,
// driven by `f_pallas`): a pipeline of asynchronous HBM -> VMEM row copies,
// one 128-word row per prefetched row id, 8 in flight, tracked by DMA
// semaphores.  Hopper's counterpart of that copy is the TMA bulk copy
// (`cp.async.bulk`) tracked by an mbarrier, and so is this kernel's.
//
// What bounds it on this card (times by slope over CUDA graphs, NVIDIA H100
// 80GB HBM3 at 700 W): the probe's lists are 8,192 rows (4 MB out) at its
// defaults and 65,536 rows (32 MB out) at --h 262144 --runs 65536, drawn
// from a 37 MB table, and about half and a third of them are padding (row
// 0).  The small list takes about 3.0 us, of which a 1-row call's launch
// and round trip are 1.6 us: latency bounds it.  The large one moves about
// 22 MB of distinct rows in and 32 MB out in about 19 us, near the card's
// copy rate: device memory bounds it.
//
// Design:
// - Persistent grid of one-warp blocks, min(tiles, 32 x SMs), each walking
//   tiles of T = 8 consecutive output rows with stride gridDim.x.  Many
//   small blocks keep the most rows in flight: T = 8, S = 2 and 32 blocks
//   per SM were the best of a sweep of T in {8, 16, 32}, S in {2, 4} and 1
//   to 32 blocks per SM at both sizes (PERF.md).
// - A ring of S = 2 stages of T rows in shared memory, one mbarrier per
//   stage.  Each lane issues one 512-byte bulk copy for its row, straight
//   from device memory into the stage; lane 0 arms the stage's barrier with
//   the tile's real byte count.  No loaded byte passes through registers.
// - A run of equal ids in a tile is loaded once and copied by the warp
//   within shared memory (the one path through registers).  Bulk copies
//   bypass L1, so thousands of copies of one row (the padding) would queue
//   on one L2 line, where plain loads hit in each SM's L1.  It pays only on
//   lists that repeat ids, as the probe's padding does.
// - A tile's rows are contiguous in `out`, so once its barrier completes one
//   bulk store writes them (rows x 512 bytes), with an L2 evict_first policy
//   (the output is streamed).  The stage of the previous tile is refilled
//   once its store has read it (wait_group.read 1), so one tile of loads
//   and one store are in flight per block.
// - The row ids of a tile come in one coalesced load, one id per lane, a
//   tile ahead of their copies (the counterpart of the scalar prefetch).
// - A barrier that has not completed after about 2^34 cycles traps: a fault
//   in the pipeline fails the launch instead of hanging the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowBytes = 512;  // 128 int32
constexpr int kLanes = 32;
constexpr int T = 8;              // rows per tile
constexpr int S = 2;              // stages of the ring
constexpr int kBlocksPerSm = 32;  // the grid's cap per SM
constexpr int kMaxDevices = 64;
constexpr long long kWaitLimit = 1LL << 34;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!bar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitLimit) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Store from shared memory with an L2 evict_first policy: the output is
// streamed, and the table's rows should stay in L2.  Every thread that wrote
// the source must have run fence_async_shared() first.
__device__ __forceinline__ void bulk_store_streaming(void* dst, const void* src, uint32_t bytes) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Make this thread's writes to shared memory visible to bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Wait until at most one committed store still has to read shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__global__ void __launch_bounds__(kLanes)
    row_gather_kernel(const unsigned char* __restrict__ table, const int* __restrict__ rid,
                      int n_out, unsigned char* __restrict__ out) {
  static_assert(T <= kLanes && S >= 2, "one row per lane; a stage is refilled a tile late");
  __shared__ __align__(128) unsigned char ring[S * T * kRowBytes];  // S stages of T rows
  __shared__ uint64_t full[S];                                      // one mbarrier per stage
  __shared__ unsigned repeats[S];  // per stage: rows whose id repeats the row above's
  const int lane = threadIdx.x;
  const int first = blockIdx.x, step = gridDim.x;
  const int n_tiles = (n_out + T - 1) / T;
  const int nt = (n_tiles - 1 - first) / step + 1;  // this block's tiles (first < n_tiles)

  auto rows_of = [&](int j) { return min(T, n_out - (first + j * step) * T); };
  auto load_id = [&](int j) {  // this lane's row id of the block's j-th tile
    if (j >= nt || lane >= T) return 0;
    const int i = (first + j * step) * T + lane;
    return i < n_out ? __ldg(rid + i) : 0;
  };
  // the block's j-th tile into stage j % S, this lane's row from row id `id`;
  // a run of equal ids (the probe's padding is row 0) is loaded once
  auto issue = [&](int j, int id) {
    const int s = j % S, rows = rows_of(j);
    const int above = __shfl_up_sync(~0u, id, 1);
    const bool load = lane < rows && (lane == 0 || id != above);
    const unsigned loads = __ballot_sync(~0u, load);
    if (lane == 0) {
      repeats[s] = ~loads & (rows < kLanes ? (1u << rows) - 1 : ~0u);
      bar_arrive_expect_tx(&full[s], __popc(loads) * kRowBytes);
    }
    __syncwarp();
    if (load) {
      bulk_load(ring + (s * T + lane) * kRowBytes, table + (size_t)id * kRowBytes, kRowBytes,
                &full[s]);
    }
  };
  // copy each repeated row of stage s from the loaded row above it
  auto fill_repeats = [&](int s) {
    const unsigned rep = repeats[s];
    for (unsigned left = rep; left; left &= left - 1) {
      const int r = __ffs(left) - 1;
      const int src = 31 - __clz(~rep & ((2u << r) - 1));
      const int4* from = reinterpret_cast<const int4*>(ring + (s * T + src) * kRowBytes);
      reinterpret_cast<int4*>(ring + (s * T + r) * kRowBytes)[lane] = from[lane];
    }
  };

  int ids[S + 1];  // the first S tiles' ids and the first refill's, loaded before the set-up
#pragma unroll
  for (int j = 0; j <= S; ++j) ids[j] = load_id(j);
  if (lane == 0) {
    for (int s = 0; s < S; ++s) bar_init(&full[s]);
    bar_init_fence();
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (j < nt) issue(j, ids[j]);
  }
  int next = ids[S];
  for (int j = 0; j < nt; ++j) {
    const int s = j % S;
    bar_wait(&full[s], (j / S) & 1);
    fill_repeats(s);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      bulk_store_streaming(out + (size_t)(first + j * step) * T * kRowBytes,
                           ring + s * T * kRowBytes, rows_of(j) * kRowBytes);
    }
    // refill the stage of tile j-1 with tile j-1+S once its store has read it
    const int r = j - 1 + S;
    if (j >= 1 && r < nt) {
      if (lane == 0) bulk_wait_read_all_but_one();
      __syncwarp();
      issue(r, next);
      next = load_id(r + 1);
    }
  }
  if (lane == 0) bulk_wait_read_all();  // shared memory must outlive the stores' reads
}

}  // namespace

// table: (n_rows, 128) int32, 16-byte aligned; rid: (n_out,) int32; out:
// (n_out, 128) int32, 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int kart_row_gather(const void* table, const void* rid, int n_out, void* out,
                               void* stream) {
  static int sm_count[kMaxDevices];  // per device, read at first use
  if (n_out == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (n_out + T - 1) / T;
  const int cap = kBlocksPerSm * sm_count[dev];
  row_gather_kernel<<<tiles < cap ? tiles : cap, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table), static_cast<const int*>(rid), n_out,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
