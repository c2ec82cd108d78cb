// Needleman-Wunsch decision planes for Hopper (sm_90a), one thread per
// fragment pair.
//
// Replaces kart_tpu/ops/nw.py::_nw_kernel (plane form, 16/32 tiles) and
// kart_tpu/ops/nw.py::_nw_kernel_wave (wavefront form, 64/128 tiles) with
// one kernel templated on the tile LM.  The plain PyTorch version is
// kart_tpu_torch/ops/nw.py::nw_batch_planes_plain.
//
// It runs the reference's 3-matrix affine-gap DP (src/nw_alignment.cpp) on
// doubled integer scores (+3/-3, new gap -3, extend -1, open -2,
// MAX_PENALTY -131072), which is exact for every float32 value the
// reference forms, so the ties and the decision bits are the reference's.
// For every cell of the padded (LM+1)^2 tile, pads included, it stores one
// byte: bit0 = (s == r), bit1 = (s == t).  The backtrace stays on the host.
//
// What bounds it on this card: the store of (LM+1)^2 bytes per pair; the
// compute is O(LM^2) integer max/add.  The TPU kernels' 128-lane batch and
// diagonal-major output were artefacts of the vector unit and VMEM; here a
// thread sweeps its tile row by row, keeps the previous row's t and s and
// the current row's r and s in registers (spilling to L1-cached local memory
// at LM=128), holds its pair's second string as packed bytes, and writes
// each decision byte straight to its (i, j) place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPenalty = -131072;
constexpr int kOpenGap = -2;
constexpr int kExtendGap = -1;
constexpr int kNewGap = -3;
constexpr int kMatch = 3;
constexpr int kMismatch = -3;

template <int LM>
__global__ void __launch_bounds__(32)
nw_planes_kernel(const int8_t* __restrict__ c1, const int8_t* __restrict__ c2,
                 int n, uint8_t* __restrict__ out) {
  constexpr int LP = LM + 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int8_t* a = c1 + static_cast<size_t>(k) * LM;
  uint8_t* eq = out + static_cast<size_t>(k) * LP * LP;

  // second string, 4 codes per word (rows are 16-byte aligned: LM % 16 == 0)
  unsigned bw[LM / 4];
  const uint4* b4 = reinterpret_cast<const uint4*>(c2 + static_cast<size_t>(k) * LM);
#pragma unroll
  for (int q = 0; q < LM / 16; ++q) {
    const uint4 v = __ldg(b4 + q);
    bw[4 * q] = v.x;
    bw[4 * q + 1] = v.y;
    bw[4 * q + 2] = v.z;
    bw[4 * q + 3] = v.w;
  }

  // row 0: origin r = t = s = 0; (0, j): r = s = gap_j, t = MAX
  int tp[LP], sp[LP];  // t and s of the previous row
  tp[0] = 0;
  sp[0] = 0;
  eq[0] = 3;
#pragma unroll
  for (int j = 1; j <= LM; ++j) {
    tp[j] = kMaxPenalty;
    sp[j] = kOpenGap + kExtendGap * j;
    eq[j] = 1;
  }

  for (int i = 1; i <= LM; ++i) {
    const unsigned ca = static_cast<uint8_t>(a[i - 1]);
    const int gap_i = kOpenGap + kExtendGap * i;
    uint8_t* row = eq + i * LP;
    // (i, 0): r = MAX, t = s = gap_i
    int s_diag = sp[0];
    int r = kMaxPenalty;
    int s_left = gap_i;
    tp[0] = gap_i;
    sp[0] = gap_i;
    row[0] = 2;
#pragma unroll
    for (int j = 1; j <= LM; ++j) {
      const unsigned cb = (bw[(j - 1) >> 2] >> (8 * ((j - 1) & 3))) & 0xFFu;
      const int rv = max(r + kExtendGap, s_left + kNewGap);
      const int tv = max(tp[j] + kExtendGap, sp[j] + kNewGap);
      const int sub = ca == cb ? kMatch : kMismatch;
      const int sv = max(max(s_diag + sub, rv), tv);
      s_diag = sp[j];
      tp[j] = tv;
      sp[j] = sv;
      r = rv;
      s_left = sv;
      row[j] = static_cast<uint8_t>((sv == rv) | ((sv == tv) << 1));
    }
  }
}

template <int LM>
int launch(const void* c1, const void* c2, int n, void* out, cudaStream_t stream) {
  const int threads = 32;  // small blocks spread a few thousand pairs over all SMs
  const int blocks = (n + threads - 1) / threads;
  nw_planes_kernel<LM><<<blocks, threads, 0, stream>>>(
      static_cast<const int8_t*>(c1), static_cast<const int8_t*>(c2), n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  c1, c2: (n, lm) int8 device arrays, 16-byte
// aligned; out: (n, lm+1, lm+1) uint8.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unsupported lm.
extern "C" int kart_nw_planes(const void* c1, const void* c2, int n, int lm,
                              void* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lm) {
    case 16: return launch<16>(c1, c2, n, out, s);
    case 32: return launch<32>(c1, c2, n, out, s);
    case 64: return launch<64>(c1, c2, n, out, s);
    case 128: return launch<128>(c1, c2, n, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
