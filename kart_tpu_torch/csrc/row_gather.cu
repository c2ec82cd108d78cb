// Row gather for Hopper (sm_90a): out[i, :] = table[rid[i], :] for a
// (n_rows, 128) int32 table.
//
// Replaces the Pallas probe kernel of tools/bench_gather.py (`pallas_dma`,
// called from `f_pallas`): one 128-word row per prefetched row id, copied
// HBM -> VMEM by DMA with 8 copies in flight.  The plain PyTorch version is
// `table[rid]` (kart_tpu_torch/tools/bench_gather.py).  Row ids must lie in
// [0, n_rows).
//
// What bounds it on this card: one random 512-byte row per id, so the
// latency of device memory unless enough rows are in flight.  One warp
// moves one row as 32 lanes x 16 bytes (one coalesced 512-byte load and
// store); each warp loads 8 rows into registers before it stores any, the
// counterpart of the TPU kernel's 8 DMAs in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kRowInts = 128;
constexpr int kLanes = 32;  // one int4 of each row per lane
constexpr int kInFlight = 8;

__global__ void row_gather_kernel(const int4* __restrict__ table,
                                  const int* __restrict__ rid, int n_out,
                                  int4* __restrict__ out) {
  const int lane = threadIdx.x % kLanes;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int n_warps = gridDim.x * blockDim.x / kLanes;
  for (int base = warp * kInFlight; base < n_out; base += n_warps * kInFlight) {
    int4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = base + k;
      if (i < n_out) {
        v[k] = __ldg(table + (size_t)__ldg(rid + i) * kLanes + lane);
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int i = base + k;
      if (i < n_out) out[(size_t)i * kLanes + lane] = v[k];
    }
  }
}

}  // namespace

// table: (n_rows, 128) int32, 16-byte aligned; rid: (n_out,) int32; out:
// (n_out, 128) int32, 16-byte aligned.  Returns cudaGetLastError() after
// the launch.
extern "C" int kart_row_gather(const void* table, const void* rid, int n_out, void* out,
                               void* stream) {
  static_assert(kRowInts == kLanes * 4, "one int4 per lane per row");
  if (n_out == 0) return 0;
  const int threads = 256;
  const int rows_per_block = threads / kLanes * kInFlight;
  const int blocks = (n_out + rows_per_block - 1) / rows_per_block;
  row_gather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int*>(rid), n_out,
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
