// The window through which a SensitiveMode chase (fm_seed_scan.cu's
// fm_chase_kernel, kmer_funnel.cu's funnel_chase_kernel) reads one row of
// its int2 outcomes: 64 entries, two a lane of the warp (entries base + j
// and base + 32 + j).  The chase's next position lies within some 30 to 60
// entries, so a window serves several steps, and a lookup in it is two
// shuffles.

#pragma once

#include <climits>

namespace {

struct Window {
  int base = INT_MIN / 2;
  int2 lo, hi;
};

// Entry p of e (p < n): every lane of the warp calls this with the same p.
__device__ __forceinline__ int2 window_at(Window& w, const int2* __restrict__ e, int n, int p) {
  const int j = threadIdx.x & 31;
  if (p < w.base || p >= w.base + 64) {
    w.base = p;
    w.lo = p + j < n ? __ldg(e + p + j) : make_int2(0, 0);
    w.hi = p + 32 + j < n ? __ldg(e + p + 32 + j) : make_int2(0, 0);
  }
  const int d = p - w.base;
  const int2 h = d < 32 ? w.lo : w.hi;
  return make_int2(__shfl_sync(0xFFFFFFFFu, h.x, d & 31), __shfl_sync(0xFFFFFFFFu, h.y, d & 31));
}

}  // namespace
