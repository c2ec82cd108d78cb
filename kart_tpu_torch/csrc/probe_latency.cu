// Latency of one dependent load from device memory on this card: a single
// thread walks a random cycle through a table far larger than L2, each
// load's address coming from the load before it.  Not a kernel of the
// mapping path and not part of its library: tools/bench_kernels.py builds
// it on its own and uses the time of one step to turn a kernel's chain of
// dependent loads into a time.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start, int steps, int* out) {
  int i = start;
  for (int s = 0; s < steps; ++s) i = __ldg(next + i);
  *out = i;
}

}  // namespace

// next: (n,) int32, a permutation with one cycle; out: (1,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int kart_probe_chase(const void* next, int start, int steps, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), start, steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
