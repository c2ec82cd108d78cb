// The window through which a SensitiveMode chase (fm_seed_scan.cu's
// fm_chase_kernel, kmer_funnel.cu's funnel_chase_kernel) reads one row of
// its int2 outcomes (longlong2 on an int64 index): 64 entries, two a lane
// of the warp (entries base + j and base + 32 + j).  The chase's next position lies within some 30 to 60
// entries, so a window serves several steps, and a lookup in it is two
// shuffles.

#pragma once

#include <climits>

namespace {

__device__ __forceinline__ int2 shfl_entry(int2 h, int src) {
  return make_int2(__shfl_sync(0xFFFFFFFFu, h.x, src), __shfl_sync(0xFFFFFFFFu, h.y, src));
}

__device__ __forceinline__ longlong2 shfl_entry(longlong2 h, int src) {
  return make_longlong2(__shfl_sync(0xFFFFFFFFu, h.x, src), __shfl_sync(0xFFFFFFFFu, h.y, src));
}

// E: int2, or longlong2 where an outcome holds an int64 interval bound.
template <typename E>
struct WindowOf {
  int base = INT_MIN / 2;
  E lo, hi;
};
using Window = WindowOf<int2>;

// Entry p of e (p < n): every lane of the warp calls this with the same p.
template <typename E>
__device__ __forceinline__ E window_at(WindowOf<E>& w, const E* __restrict__ e, int n, int p) {
  const int j = threadIdx.x & 31;
  if (p < w.base || p >= w.base + 64) {
    w.base = p;
    w.lo = p + j < n ? __ldg(e + p + j) : E{};
    w.hi = p + 32 + j < n ? __ldg(e + p + 32 + j) : E{};
  }
  const int d = p - w.base;
  return shfl_entry(d < 32 ? w.lo : w.hi, d & 31);
}

}  // namespace
