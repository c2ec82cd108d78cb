// The block-sharded FM index (-idx-shards) for Hopper (sm_90a): the four
// kernels of kart_tpu_torch/parallel/sharded_index.py.
//
// Replaces kart_tpu/parallel/sharded_index.py: sharded_occ4_batch and
// sharded_occ4_pair (G1), the step of sharded_seed_scan, seed_scan_impl's
// body over the combined counts (G2), sharded_inv_psi_batch, the step of
// sharded_sa_walk (G3), and sharded_sa_gather with the walk's sample gather
// (G4).  kart_tpu ran each as a masked local lookup on every member of an
// `idx` mesh axis followed by a psum; here each shard's slab is a tensor on
// the shard's device, a kernel answers the queries its slab owns (zeros
// elsewhere), and the host sums the shards' results on the first shard's
// device.  Exactly one shard owns each query, so the sum is exact.  The plain
// PyTorch versions are sharded_index.py's *_plain functions and
// ops/fm_search.py::seed_scan_step_plain.
//
// A shard's slab is blocks [lo, lo + nb_local) of the index (occ_cp four
// counts a block, bwt_words eight 32-bit words a block), or rows [lo, lo +
// n_local) of the full SA or of the sampled SA.  The last shard's slab is
// padded with zero blocks past the index, which own no query: a query's
// block is that of kk = k - (k >= primary), at most (seq_len - 1) >> 7.
//
//   sharded_occ4_kernel     a thread a row k: occ4(k) from the slab's block
//                           if the shard owns it, else zeros; a scan step
//                           asks for both interval ends of every lane in one
//                           launch of 2B rows.
//   sharded_scan_step_kernel a thread a lane: one FastMode step from the
//                           combined counts (the branch-for-branch twin of
//                           seed_scan_step_plain): records a seed that ended,
//                           starts or extends the interval, and writes the
//                           next step's pair of rows.  The state goes from
//                           one buffer to another, so a launch on the same
//                           inputs writes the same outputs.
//   sharded_inv_psi_kernel  a thread a row k: a row at a sample (k % 32 ==
//                           0) stays, else bwt_invPsi(k), from the owner's
//                           block (the BWT char at x = k - (k > primary) lies
//                           in kk's block for every k != primary), zeros on
//                           the other shards; the first shard's launch also
//                           counts the step of every row not at a sample.
//   sharded_gather_kernel   a thread a row: slab[(row >> shift) - lo] if the
//                           shard owns it, else 0 (shift 0 for the full SA,
//                           5 for the sample at a walk's end).
//
// What bounds them on this card: dependent loads, not bytes.  A scan step is
// l_max + 1 rounds of (N occ4 launches, the sum, the step), each round's rows
// depending on the round before; an occ4 row is two independent loads (a
// 16- or 32-byte checkpoint row and a 32-byte block), so a round costs the
// latency of a few launches and one load that hits L2.  The walk is the same
// with one inverse-Psi launch a shard a step.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"

namespace {

constexpr int kOccThr = 50;
constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// The slab block that holds kk, or -1 where the shard does not own it.
template <typename T>
__device__ __forceinline__ long long owned_block(T kk, long long lo, long long nb_local) {
  const long long row = static_cast<long long>(kk >> 7) - lo;
  return row >= 0 && row < nb_local ? row : -1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_occ4_kernel(const typename CpRow<T>::type* __restrict__ occ_cp,
                    const uint4* __restrict__ bwt4, T primary, long long lo, long long nb_local,
                    const T* __restrict__ k, int n, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T kq = __ldg(k + i);
  const T kk = kq - (kq >= primary ? 1 : 0);
  const long long blk = owned_block(kk, lo, nb_local);
  typename CpRow<T>::type r = {0, 0, 0, 0};
  if (blk >= 0)
    r = occ4_words(load_cp(occ_cp, blk), __ldg(bwt4 + 2 * blk), __ldg(bwt4 + 2 * blk + 1), kk);
  T* o = out + 4 * static_cast<size_t>(i);
  o[0] = r.x;
  o[1] = r.y;
  o[2] = r.z;
  o[3] = r.w;
}

// The scan's state, a lane a column: ist (3, B) int32 = start, n_seeds,
// active; tst (3, B) of the index type = x0, x1, x2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_scan_step_kernel(const T* __restrict__ cnt, const int* __restrict__ codes_t,
                         const int* __restrict__ rlens, const T* __restrict__ L2, T primary, int B,
                         int l_max, int p, int min_seed_len, int max_seeds,
                         const int* __restrict__ ist, const T* __restrict__ tst,
                         int* __restrict__ ist_out, T* __restrict__ tst_out, T* __restrict__ out,
                         T* __restrict__ k_next) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int start = ist[b], n_seeds = ist[B + b];
  bool active = ist[2 * B + b] != 0;
  T x0 = tst[b], x1 = tst[B + b], x2 = tst[2 * B + b];
  const T l2[5] = {__ldg(L2), __ldg(L2 + 1), __ldg(L2 + 2), __ldg(L2 + 3), __ldg(L2 + 4)};
  // column l_max is the extra ambiguous column that ends every extension
  const int c = p < l_max ? __ldg(codes_t + static_cast<size_t>(p) * B + b) : 4;
  const bool amb = c > 3;
  const int cs = amb ? 3 : c;

  // the extension by the complement base i from the counts at both ends
  const T* tk = cnt + 4 * static_cast<size_t>(b);
  const T* tl = cnt + 4 * (static_cast<size_t>(B) + b);
  const int i = 3 - cs;
  const T s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary) ? 1 : 0);
  const T s2 = s3 + (tl[3] - tk[3]);
  const T s1 = s2 + (tl[2] - tk[2]);
  const T s0 = s1 + (tl[1] - tk[1]);
  const T nx0 = pick4(i, s0, s1, s2, s3);
  const T nx1 = l2[i] + 1 + tk[i];
  const T nx2 = tl[i] - tk[i];
  const bool ext_fail = amb || nx2 == 0;

  // a seed ends at p: recorded at slot n_seeds, dropped (and counted) past
  // max_seeds
  const int length = p - start;
  if (active && ext_fail && length >= min_seed_len && x2 <= kOccThr) {
    if (n_seeds < max_seeds) {
      T* row = out + static_cast<size_t>(b) * (1 + 4 * max_seeds) + 1 + n_seeds;
      row[0] = start;
      row[max_seeds] = length;
      row[2 * max_seeds] = x0;
      row[3 * max_seeds] = x2;
    }
    ++n_seeds;
  }

  const bool can_start = !active && !amb && p < __ldg(rlens + b) - min_seed_len;
  const bool cont = active && !ext_fail;
  if (cont) {
    x0 = nx0;
    x1 = nx1;
    x2 = nx2;
  } else if (can_start) {
    start = p;
    x0 = l2[cs] + 1;
    x1 = l2[3 - cs] + 1;
    x2 = l2[cs + 1] - l2[cs];
  }
  active = cont || can_start;
  ist_out[b] = start;
  ist_out[B + b] = n_seeds;
  ist_out[2 * B + b] = active;
  tst_out[b] = x0;
  tst_out[B + b] = x1;
  tst_out[2 * B + b] = x2;
  out[static_cast<size_t>(b) * (1 + 4 * max_seeds)] = n_seeds;
  // an idle lane asks for row 0 (its counts are not used)
  k_next[b] = active ? x1 - 1 : T(0);
  k_next[B + b] = active ? x1 - 1 + x2 : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_inv_psi_kernel(FmWalk<T> fm, const T* __restrict__ L2, long long lo, long long nb_local,
                       const T* __restrict__ k, int n, T* __restrict__ out, int* __restrict__ add) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T kq = __ldg(k + i);
  const bool at_sample = (kq & ((T(1) << kSaIntvLog2) - 1)) == 0;
  if (add && !at_sample) ++add[i];
  const T kk = kq - (kq >= fm.primary ? 1 : 0);
  const long long blk = owned_block(kk, lo, nb_local);
  T v = 0;
  if (blk >= 0) {
    if (at_sample) {
      v = kq;
    } else {
      FmWalk<T> f = fm;
      load_l2(f, L2);
      v = inv_psi_at(f, kq, kk, static_cast<size_t>(blk));
    }
  }
  out[i] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_gather_kernel(const T* __restrict__ slab, long long lo, long long n_local,
                      const T* __restrict__ rows, int n, int shift, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = static_cast<long long>(__ldg(rows + i) >> shift) - lo;
  out[i] = r >= 0 && r < n_local ? __ldg(slab + r) : T(0);
}

template <typename T>
int launch_occ4(const void* occ_cp, const void* bwt_words, long long primary, long long lo,
                long long nb_local, const void* k, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  sharded_occ4_kernel<T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename CpRow<T>::type*>(occ_cp), static_cast<const uint4*>(bwt_words),
      static_cast<T>(primary), lo, nb_local, static_cast<const T*>(k), n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scan_step(const void* cnt, const void* codes_t, const void* rlens, const void* L2,
                     long long primary, int B, int l_max, int p, int min_seed_len, int max_seeds,
                     const void* ist, const void* tst, void* ist_out, void* tst_out, void* out,
                     void* k_next, void* stream) {
  if (B <= 0) return 0;
  sharded_scan_step_kernel<T><<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cnt), static_cast<const int*>(codes_t),
      static_cast<const int*>(rlens), static_cast<const T*>(L2), static_cast<T>(primary), B,
      l_max, p, min_seed_len, max_seeds, static_cast<const int*>(ist),
      static_cast<const T*>(tst), static_cast<int*>(ist_out), static_cast<T*>(tst_out),
      static_cast<T*>(out), static_cast<T*>(k_next));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inv_psi(const void* occ_cp, const void* bwt_words, const void* L2, long long primary,
                   long long lo, long long nb_local, const void* k, int n, void* out, void* add,
                   void* stream) {
  if (n <= 0) return 0;
  FmWalk<T> fm;
  fm.occ_cp = static_cast<const typename CpRow<T>::type*>(occ_cp);
  fm.bwt4 = static_cast<const uint4*>(bwt_words);
  fm.sa_samples = nullptr;
  fm.primary = static_cast<T>(primary);
  sharded_inv_psi_kernel<T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fm, static_cast<const T*>(L2), lo, nb_local, static_cast<const T*>(k), n,
      static_cast<T*>(out), static_cast<int*>(add));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* slab, long long lo, long long n_local, const void* rows, int n,
                  int shift, void* out, void* stream) {
  if (n <= 0) return 0;
  sharded_gather_kernel<T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(slab), lo, n_local, static_cast<const T*>(rows), n, shift,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one an index type (T int, or long long for the
// _i64 entries).  Pointers are device pointers of one shard's device.
//   occ_cp (nb_local*4,) T and bwt_words (nb_local*8,) 32-bit words, both
//   16-byte aligned: the shard's slab of blocks [lo, lo + nb_local);
//   k (n,) T rows; out (n, 4) T counts.
extern "C" int kart_sharded_occ4(const void* occ_cp, const void* bwt_words, int primary,
                                 long long lo, long long nb_local, const void* k, int n, void* out,
                                 void* stream) {
  return launch_occ4<int>(occ_cp, bwt_words, primary, lo, nb_local, k, n, out, stream);
}

extern "C" int kart_sharded_occ4_i64(const void* occ_cp, const void* bwt_words, long long primary,
                                     long long lo, long long nb_local, const void* k, int n,
                                     void* out, void* stream) {
  return launch_occ4<long long>(occ_cp, bwt_words, primary, lo, nb_local, k, n, out, stream);
}

//   cnt (2B, 4) T: the combined counts of the rows ka (lanes 0..B-1) and kb;
//   codes_t (l_max, B) int32 read codes (>3 ambiguous), rlens (B,) int32, L2
//   (5,) T; ist, ist_out (3, B) int32 and tst, tst_out (3, B) T the state
//   before and after step p; out (B, 1 + 4*max_seeds) T the packed seeds,
//   zero before step 0; k_next (2B,) T the next step's rows.
extern "C" int kart_sharded_scan_step(const void* cnt, const void* codes_t, const void* rlens,
                                      const void* L2, int primary, int B, int l_max, int p,
                                      int min_seed_len, int max_seeds, const void* ist,
                                      const void* tst, void* ist_out, void* tst_out, void* out,
                                      void* k_next, void* stream) {
  return launch_scan_step<int>(cnt, codes_t, rlens, L2, primary, B, l_max, p, min_seed_len,
                               max_seeds, ist, tst, ist_out, tst_out, out, k_next, stream);
}

extern "C" int kart_sharded_scan_step_i64(const void* cnt, const void* codes_t, const void* rlens,
                                          const void* L2, long long primary, int B, int l_max,
                                          int p, int min_seed_len, int max_seeds, const void* ist,
                                          const void* tst, void* ist_out, void* tst_out,
                                          void* out, void* k_next, void* stream) {
  return launch_scan_step<long long>(cnt, codes_t, rlens, L2, primary, B, l_max, p, min_seed_len,
                                     max_seeds, ist, tst, ist_out, tst_out, out, k_next, stream);
}

//   occ_cp, bwt_words as kart_sharded_occ4's, L2 (5,) T; k, out (n,) T;
//   add (n,) int32 step counts, incremented where a row is not at a sample,
//   or null (every shard but the first).
extern "C" int kart_sharded_inv_psi(const void* occ_cp, const void* bwt_words, const void* L2,
                                    int primary, long long lo, long long nb_local, const void* k,
                                    int n, void* out, void* add, void* stream) {
  return launch_inv_psi<int>(occ_cp, bwt_words, L2, primary, lo, nb_local, k, n, out, add,
                             stream);
}

extern "C" int kart_sharded_inv_psi_i64(const void* occ_cp, const void* bwt_words, const void* L2,
                                        long long primary, long long lo, long long nb_local,
                                        const void* k, int n, void* out, void* add, void* stream) {
  return launch_inv_psi<long long>(occ_cp, bwt_words, L2, primary, lo, nb_local, k, n, out, add,
                                   stream);
}

//   slab (n_local,) T rows [lo, lo + n_local) of the full or the sampled SA;
//   rows, out (n,) T.
extern "C" int kart_sharded_gather(const void* slab, long long lo, long long n_local,
                                   const void* rows, int n, int shift, void* out, void* stream) {
  return launch_gather<int>(slab, lo, n_local, rows, n, shift, out, stream);
}

extern "C" int kart_sharded_gather_i64(const void* slab, long long lo, long long n_local,
                                       const void* rows, int n, int shift, void* out,
                                       void* stream) {
  return launch_gather<long long>(slab, lo, n_local, rows, n, shift, out, stream);
}
