// Needleman-Wunsch decision planes for Hopper (sm_90a): a wavefront across
// the lanes of a warp, planes staged in shared memory and stored in full
// lines.
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
// What bounds it on this card: the store of (LM+1)^2 bytes per pair, with
// about a dozen integer operations a cell close behind.  The design keeps
// both near their rates:
//   - a warp owns a pair at LM 128 and a half-warp below (two pairs a warp:
//     fewer idle steps at the skew's ends than a warp a pair), and the lanes
//     split the columns, LM / lanes each (4 at LM 128 and 64, 2 at 32, 1 at
//     16).  At step t lane q works on row t - q + 1 of its strip and hands
//     the r and s of its right edge, and the row's code of the first
//     string, to lane q + 1 with two shuffles; t and s of the row above stay
//     in 2 * columns registers.  LM + lanes - 1 steps a pair, nothing
//     indexed by column, nothing spilled;
//   - a pair's plane is one contiguous run of (LM+1)^2 bytes.  It is built
//     in shared memory at the byte offset its destination has within a
//     16-byte line, so after the sweep the lanes copy it out with aligned
//     16-byte stores, whole lines a warp, and only the ragged head and tail
//     go out by bytes ((LM+1)^2 is odd: no plane starts on a line);
//   - blocks are small (1 warp at LM 128 and 64, 4 below), so a few hundred
//     pairs already spread over all SMs and a block's 17 KB at LM 128 lets
//     an SM hold thirteen.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPenalty = -131072;
constexpr int kOpenGap = -2;
constexpr int kExtendGap = -1;
constexpr int kNewGap = -3;
constexpr int kMatch = 3;
constexpr int kMismatch = -3;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Shared memory of one pair, in 16-byte lines: the plane shifted by up to 15
// bytes, then the first string's codes.
template <int LM>
constexpr int kSlotLines = ((LM + 1) * (LM + 1) + 15 + 15) / 16 + LM / 16;

template <int LM, int LANES, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
nw_planes_kernel(const int8_t* __restrict__ c1, const int8_t* __restrict__ c2,
                 int n, uint8_t* __restrict__ out) {
  constexpr int LP = LM + 1;
  constexpr int TILE = LP * LP;
  constexpr int COLS = LM / LANES;  // columns a lane
  constexpr int PAIRS = 32 / LANES;  // pairs a warp
  extern __shared__ uint4 stage[];

  const int lane = threadIdx.x & 31;
  const int q = lane % LANES;
  const int slot = (threadIdx.x >> 5) * PAIRS + lane / LANES;
  const int k = blockIdx.x * (WARPS * PAIRS) + slot;
  const bool valid = k < n;
  uint8_t* dst = out + static_cast<size_t>(valid ? k : 0) * TILE;
  uint4* lines = stage + slot * kSlotLines<LM>;
  // the plane sits in shared memory at its destination's offset in a line
  uint8_t* eq = reinterpret_cast<uint8_t*>(lines) + (reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* a = reinterpret_cast<uint8_t*>(lines + kSlotLines<LM> - LM / 16);

  // first string to shared memory (rows are 16-byte aligned: LM % 16 == 0);
  // this lane's columns of the second string to registers
  const int j0 = q * COLS;  // the lane owns columns j0+1 .. j0+COLS
  unsigned cb[COLS];
  if (valid) {
    if (q < LM / 16)
      reinterpret_cast<uint4*>(a)[q] =
          __ldg(reinterpret_cast<const uint4*>(c1 + static_cast<size_t>(k) * LM) + q);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      cb[c] = static_cast<uint8_t>(__ldg(c2 + static_cast<size_t>(k) * LM + j0 + c));
  } else {
    if (q < LM / 16) reinterpret_cast<uint4*>(a)[q] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int c = 0; c < COLS; ++c) cb[c] = 0;
  }
  // row 0: origin r = t = s = 0; (0, j): r = s = gap_j, t = MAX;
  // column 0: (i, 0): r = MAX, t = s = gap_i
  for (int j = q; j <= LM; j += LANES) eq[j] = j == 0 ? 3 : 1;
  for (int i = 1 + q; i <= LM; i += LANES) eq[i * LP] = 2;
  int tp[COLS], sp[COLS];  // t and s of the row above, this lane's columns
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    tp[c] = kMaxPenalty;
    sp[c] = kOpenGap + kExtendGap * (j0 + 1 + c);
  }
  __syncwarp();

  // what this lane hands to the next: r of its right edge, and s of its right
  // edge with the row's code of the first string in the low byte
  int edge_r = 0, edge_s = 0;
  int diag = q == 0 ? 0 : kOpenGap + kExtendGap * j0;  // s(i-1, j0) of the next row
  for (int t = 0; t < LM + LANES - 1; ++t) {
    int r = __shfl_up_sync(kFull, edge_r, 1);
    int in_s = __shfl_up_sync(kFull, edge_s, 1);
    const int i = t - q + 1;
    if (q == 0) {  // column 0 instead of a neighbour
      r = kMaxPenalty;
      in_s = (kOpenGap + kExtendGap * i) * 256 + a[t < LM ? t : 0];
    }
    if (i >= 1 && i <= LM) {
      const unsigned ca = in_s & 0xFF;
      int s_left = in_s >> 8;
      int s_diag = diag;
      diag = s_left;
      uint8_t* row = eq + i * LP + j0 + 1;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int rv = max(r + kExtendGap, s_left + kNewGap);
        const int tv = max(tp[c] + kExtendGap, sp[c] + kNewGap);
        const int sub = ca == cb[c] ? kMatch : kMismatch;
        const int sv = max(max(s_diag + sub, rv), tv);
        s_diag = sp[c];
        tp[c] = tv;
        sp[c] = sv;
        r = rv;
        s_left = sv;
        row[c] = static_cast<uint8_t>((sv == rv) | ((sv == tv) << 1));
      }
      edge_r = r;
      edge_s = s_left * 256 + static_cast<int>(ca);
    }
  }
  __syncwarp();

  // the plane out: bytes up to the first line, whole lines, bytes after
  if (!valid) return;
  const int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  const int n_lines = (TILE - head) / 16;
  for (int v = q; v < head; v += LANES) dst[v] = eq[v];
  const uint4* src4 = reinterpret_cast<const uint4*>(eq + head);
  uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
  for (int v = q; v < n_lines; v += LANES) dst4[v] = src4[v];
  for (int v = head + 16 * n_lines + q; v < TILE; v += LANES) dst[v] = eq[v];
}

template <int LM, int LANES, int WARPS>
int launch(const void* c1, const void* c2, int n, void* out, cudaStream_t stream) {
  constexpr int per_block = WARPS * (32 / LANES);
  const int blocks = (n + per_block - 1) / per_block;
  const size_t smem = sizeof(uint4) * per_block * kSlotLines<LM>;
  nw_planes_kernel<LM, LANES, WARPS><<<blocks, 32 * WARPS, smem, stream>>>(
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
    case 16: return launch<16, 16, 4>(c1, c2, n, out, s);
    case 32: return launch<32, 16, 4>(c1, c2, n, out, s);
    case 64: return launch<64, 16, 1>(c1, c2, n, out, s);
    case 128: return launch<128, 32, 1>(c1, c2, n, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
