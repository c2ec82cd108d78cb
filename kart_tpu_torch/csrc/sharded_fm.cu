// The block-sharded FM index (-idx-shards) for Hopper (sm_90a): the step
// kernels of kart_tpu_torch/parallel/sharded_index.py's cross-device path.
//
// Replaces kart_tpu/parallel/sharded_index.py: sharded_occ4_batch and
// sharded_occ4_pair (G1), the step of sharded_seed_scan, seed_scan_impl's
// body over the combined counts (G2, fused with the stepping device's G1),
// sharded_inv_psi_batch, the step of sharded_sa_walk (G3), and
// sharded_sa_gather with the walk's sample gather (G4).  kart_tpu ran each
// as a masked local lookup on every member of an `idx` mesh axis followed
// by a psum.  Here the shards' slabs are tensors on their devices.  Where
// one device holds every shard, the whole scan and the whole walk are one
// launch each (fm_seed_scan.cu's and sa_walk.cu's loops through the shard
// table), and a resolve reads the full SA through the table inside
// resolve_pack.cu's passes; the kernels here serve shards spread over
// several devices, where the host steps: a scan step is one G1 launch on
// every other device and one fused step on the first (its own shards'
// counts, the others' parts, the step); the walk one G3 launch a device a
// step, summed on the first, then one G4 a device.  Exactly one shard owns
// each query, so the sum is exact.  The plain PyTorch versions are
// sharded_index.py's table_occ4_plain, fused_step_plain (table_occ4_plain,
// the parts' sum and ops/fm_search.py::seed_scan_step_plain),
// table_inv_psi_plain and table_gather_plain (shard_gather_plain a shard,
// summed).
//
// The shard table (fm_index.cuh's ShardedIndex) has a row for every shard
// of the index: the pointers of its slabs where it lies on the launching
// device, nulls elsewhere.  Block b belongs to shard b / nb_local; a row
// picks its owner first and loads that slab's checkpoint row and block only
// (one pair of loads a row, where a launch a shard asked every shard about
// every row), and answers zeros where the owner lies elsewhere.  A slab is
// blocks [s * nb_local, (s + 1) * nb_local) of the index; the last shard's
// is padded with zero blocks past the index, which own no query: a query's
// block is that of kk = k - (k >= primary), at most (seq_len - 1) >> 7.
//
//   sharded_occ4_kernel     a thread a row k: occ4(k) from its owner's block
//                           if the table holds it, else zeros; a scan step
//                           asks for both interval ends of every lane in one
//                           launch of 2B rows.
//   sharded_fused_step_kernel a thread a lane: occ4 of both of its rows
//                           from the launching device's shards (G1's body),
//                           plus the other devices' parts, read through a
//                           device array of pointers, then one FastMode step
//                           from the summed counts (the branch-for-branch
//                           twin of seed_scan_step_plain): records a seed
//                           that ended, starts or extends the interval, and
//                           writes the next step's pair of rows.  The state
//                           goes from one buffer to another (the caller
//                           swaps two), so a launch on the same inputs
//                           writes the same outputs.
//   sharded_inv_psi_kernel  a thread a row k: a row at a sample (k % 32 ==
//                           0) stays, else bwt_invPsi(k), from the owner's
//                           block (the BWT char at x = k - (k > primary) lies
//                           in kk's block for every k != primary), zeros
//                           where the table does not hold the owner; the
//                           first device's launch also counts the step of
//                           every row not at a sample.
//   sharded_gather_kernel   a thread a row, one launch for every shard of
//                           the device: q = row >> shift, its owner q /
//                           n_local by fm_index.cuh's ShardedSa (a multiply
//                           by the reciprocal; for an int64 index, whose rows
//                           pass 2**32, a multiply and a compare more), then
//                           the owner's slab at q % n_local where the table
//                           holds it, else 0 (shift 0: the full-SA column,
//                           the full-SA lookup of a cross-device resolve and
//                           sharded_sa_gather; shift 5: the samples at a
//                           cross-device walk's end).  One launch a device
//                           where there was one a shard, each writing a
//                           whole zero-padded part for a sum.
//
// What bounds them on this card: dependent loads, not bytes, and above all
// the host's launches.  A cross-device scan is l_max + 1 rounds of (a G1
// launch on each other device, the fused step), each round's rows depending
// on the round before; a lane's occ4 is the table read, then two
// independent loads (a 16- or 32-byte checkpoint row and a 32-byte block),
// so a round costs the latency of N launches for N devices and one load
// that hits L2.  The walk is one G3 launch a device a step and the sum.
// G4 reads each row and its slab word once (96,000 rows: some 1.8 MB by
// distinct sector, 0.5 us at 3.35 TB/s); a launch of it is near the card's
// floor for a kernel that small, so what it saves is launches and passes.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"

namespace {

constexpr int kOccThr = 50;
constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// occ4 of row kq from its owner's block where the table holds the owner,
// else zeros (G1's body).
template <typename T>
__device__ __forceinline__ typename CpRow<T>::type table_occ4(const ShardedIndex<T>& ix, T primary,
                                                             T kq) {
  const T kk = kq - (kq >= primary ? 1 : 0);
  typename CpRow<T>::type r = {0, 0, 0, 0};
  if (ix.holds(kk)) {
    const BlockRef<T> b = ix.block(kk);
    r = occ4_words(load_cp(b.cp, 0), __ldg(b.bwt4), __ldg(b.bwt4 + 1), kk);
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sharded_occ4_kernel(ShardedIndex<T> ix, T primary, const T* __restrict__ k, int n,
                    T* __restrict__ out) {
  extern __shared__ int smem[];
  ix.stage(smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const typename CpRow<T>::type r = table_occ4(ix, primary, __ldg(k + i));
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
sharded_fused_step_kernel(ShardedIndex<T> ix, const T* const* __restrict__ parts, int n_parts,
                          const T* __restrict__ k, const int* __restrict__ codes_t,
                          const int* __restrict__ rlens, const T* __restrict__ L2, T primary,
                          int B, int l_max, int p, int min_seed_len, int max_seeds,
                          const int* __restrict__ ist, const T* __restrict__ tst,
                          int* __restrict__ ist_out, T* __restrict__ tst_out, T* __restrict__ out,
                          T* __restrict__ k_next) {
  using C = typename CpRow<T>::type;
  extern __shared__ int smem[];
  ix.stage(smem);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // the counts at both ends of the lane's interval: this device's shards,
  // then each other device's part
  C tk = table_occ4(ix, primary, __ldg(k + b));
  C tl = table_occ4(ix, primary, __ldg(k + B + b));
  for (int j = 0; j < n_parts; ++j) {
    const C* part = reinterpret_cast<const C*>(parts[j]);
    const C pk = load_cp(part, b), pl = load_cp(part, B + b);
    tk.x += pk.x, tk.y += pk.y, tk.z += pk.z, tk.w += pk.w;
    tl.x += pl.x, tl.y += pl.y, tl.z += pl.z, tl.w += pl.w;
  }

  int start = ist[b], n_seeds = ist[B + b];
  bool active = ist[2 * B + b] != 0;
  T x0 = tst[b], x1 = tst[B + b], x2 = tst[2 * B + b];
  const T l2[5] = {__ldg(L2), __ldg(L2 + 1), __ldg(L2 + 2), __ldg(L2 + 3), __ldg(L2 + 4)};
  // column l_max is the extra ambiguous column that ends every extension
  const int c = p < l_max ? __ldg(codes_t + static_cast<size_t>(p) * B + b) : 4;
  const bool amb = c > 3;
  const int cs = amb ? 3 : c;

  // the extension by the complement base i from the counts at both ends
  const int i = 3 - cs;
  const T s3 = x0 + ((x1 <= primary) && (x1 + x2 - 1 >= primary) ? 1 : 0);
  const T s2 = s3 + (tl.w - tk.w);
  const T s1 = s2 + (tl.z - tk.z);
  const T s0 = s1 + (tl.y - tk.y);
  const T nx0 = pick4(i, s0, s1, s2, s3);
  const T nx1 = pick4(i, l2[0], l2[1], l2[2], l2[3]) + 1 + pick4(i, tk.x, tk.y, tk.z, tk.w);
  const T nx2 = pick4(i, tl.x, tl.y, tl.z, tl.w) - pick4(i, tk.x, tk.y, tk.z, tk.w);
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
sharded_inv_psi_kernel(FmWalk<T, ShardedIndex<T>> fm, const T* __restrict__ L2,
                       const T* __restrict__ k, int n, T* __restrict__ out, int* __restrict__ add) {
  extern __shared__ int smem[];
  FmWalk<T, ShardedIndex<T>> f = fm;
  f.ix.stage(smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T kq = __ldg(k + i);
  const bool at_sample = (kq & ((T(1) << kSaIntvLog2) - 1)) == 0;
  if (add && !at_sample) ++add[i];
  const T kk = kq - (kq >= f.primary ? 1 : 0);
  T v = 0;
  if (f.ix.holds(kk)) {
    if (at_sample) {
      v = kq;
    } else {
      load_l2(f, L2);
      v = inv_psi_at(f, kq, kk, load_block(f.ix.block(kk)));
    }
  }
  out[i] = v;
}

// Sa: ShardedSa<T>, or a type with its stage and at (a probe's other owner
// computation).
// The row's load is issued before the table is staged, so the two overlap.
template <typename T, typename Sa>
__global__ void __launch_bounds__(kThreads)
sharded_gather_kernel(Sa sa, const T* __restrict__ rows, int n, int shift, T* __restrict__ out) {
  extern __shared__ int smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const T row = i < n ? __ldg(rows + i) : T(0);
  sa.stage(smem);
  if (i >= n) return;
  out[i] = sa.at(row >> shift);
}

template <typename T>
ShardedIndex<T> table_index(const void* table, int n_shards, long long nb_local) {
  ShardedIndex<T> ix;
  ix.table = static_cast<const ShardSlabs<T>*>(table);
  ix.n_shards = n_shards;
  ix.set_blocks(static_cast<unsigned>(nb_local));
  ix.nsamp_local = 1;  // the step kernels read no sample
  return ix;
}

template <typename T>
int launch_occ4(const void* table, int n_shards, long long nb_local, long long primary,
                const void* k, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = ShardedIndex<T>::smem_bytes(n_shards);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  sharded_occ4_kernel<T><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table_index<T>(table, n_shards, nb_local), static_cast<T>(primary),
      static_cast<const T*>(k), n, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fused_step(const void* table, int n_shards, long long nb_local, const void* parts,
                      int n_parts, const void* k, const void* codes_t, const void* rlens,
                      const void* L2, long long primary, int B, int l_max, int p,
                      int min_seed_len, int max_seeds, const void* ist, const void* tst,
                      void* ist_out, void* tst_out, void* out, void* k_next, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = ShardedIndex<T>::smem_bytes(n_shards);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  sharded_fused_step_kernel<T><<<blocks_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table_index<T>(table, n_shards, nb_local), static_cast<const T* const*>(parts), n_parts,
      static_cast<const T*>(k), static_cast<const int*>(codes_t), static_cast<const int*>(rlens),
      static_cast<const T*>(L2), static_cast<T>(primary), B, l_max, p, min_seed_len, max_seeds,
      static_cast<const int*>(ist), static_cast<const T*>(tst), static_cast<int*>(ist_out),
      static_cast<T*>(tst_out), static_cast<T*>(out), static_cast<T*>(k_next));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inv_psi(const void* table, int n_shards, long long nb_local, const void* L2,
                   long long primary, const void* k, int n, void* out, void* add, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = ShardedIndex<T>::smem_bytes(n_shards);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  FmWalk<T, ShardedIndex<T>> fm;
  fm.ix = table_index<T>(table, n_shards, nb_local);
  fm.primary = static_cast<T>(primary);
  sharded_inv_psi_kernel<T><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fm, static_cast<const T*>(L2), static_cast<const T*>(k), n, static_cast<T*>(out),
      static_cast<int*>(add));
  return static_cast<int>(cudaGetLastError());
}

// The table's full-SA column (shift 0) or its sampled-SA column (shift
// kSaIntvLog2), n_local rows a slab.
template <typename T>
ShardedSa<T> table_sa(const void* table, int n_shards, long long n_local, int shift) {
  ShardedSa<T> sa;
  sa.table = static_cast<const ShardSlabs<T>*>(table);
  sa.n_shards = n_shards;
  sa.samples = shift != 0;
  sa.set_rows(static_cast<unsigned long long>(n_local));
  return sa;
}

template <typename T, typename Sa>
int launch_gather(Sa sa, const void* rows, int n, int shift, void* out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = Sa::smem_bytes(sa.n_shards);
  if ((shift != 0 && shift != kSaIntvLog2) || sa.n_local < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  sharded_gather_kernel<T, Sa><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sa, static_cast<const T*>(rows), n, shift, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, one an index type (T int, or long long for the
// _i64 entries).  Pointers are device pointers of the launching device.
//   table (n_shards, 4) 64-bit words: shard s's occ_cp (nb_local*4,) T and
//   bwt_words (nb_local*8,) 32-bit words, both 16-byte aligned, its
//   sa_samples slab and its sa_full slab (null in the sampled SA mode), or
//   four nulls where shard s lies on another device;
//   k (n,) T rows; out (n, 4) T counts, zeros for a row whose owner the
//   table does not hold.  cudaErrorInvalidValue where the table exceeds 48 KB
//   of shared memory (some 1,500 shards).
extern "C" int kart_sharded_occ4(const void* table, int n_shards, long long nb_local, int primary,
                                 const void* k, int n, void* out, void* stream) {
  return launch_occ4<int>(table, n_shards, nb_local, primary, k, n, out, stream);
}

extern "C" int kart_sharded_occ4_i64(const void* table, int n_shards, long long nb_local,
                                     long long primary, const void* k, int n, void* out,
                                     void* stream) {
  return launch_occ4<long long>(table, n_shards, nb_local, primary, k, n, out, stream);
}

//   table as kart_sharded_occ4's (this device's shards); parts (n_parts,)
//   device pointers, each (2B, 4) T: another device's occ4 of the rows k,
//   on this device (null where n_parts is 0); k (2B,) T the rows ka (lanes
//   0..B-1) and kb of step p; codes_t (l_max, B) int32 read codes (>3
//   ambiguous), rlens (B,) int32, L2 (5,) T; ist, ist_out (3, B) int32 and
//   tst, tst_out (3, B) T the state before and after step p; out (B, 1 +
//   4*max_seeds) T the packed seeds, zero before step 0; k_next (2B,) T the
//   next step's rows.
extern "C" int kart_sharded_fused_step(const void* table, int n_shards, long long nb_local,
                                       const void* parts, int n_parts, const void* k,
                                       const void* codes_t, const void* rlens, const void* L2,
                                       int primary, int B, int l_max, int p, int min_seed_len,
                                       int max_seeds, const void* ist, const void* tst,
                                       void* ist_out, void* tst_out, void* out, void* k_next,
                                       void* stream) {
  return launch_fused_step<int>(table, n_shards, nb_local, parts, n_parts, k, codes_t, rlens, L2,
                                primary, B, l_max, p, min_seed_len, max_seeds, ist, tst, ist_out,
                                tst_out, out, k_next, stream);
}

extern "C" int kart_sharded_fused_step_i64(const void* table, int n_shards, long long nb_local,
                                           const void* parts, int n_parts, const void* k,
                                           const void* codes_t, const void* rlens, const void* L2,
                                           long long primary, int B, int l_max, int p,
                                           int min_seed_len, int max_seeds, const void* ist,
                                           const void* tst, void* ist_out, void* tst_out,
                                           void* out, void* k_next, void* stream) {
  return launch_fused_step<long long>(table, n_shards, nb_local, parts, n_parts, k, codes_t,
                                      rlens, L2, primary, B, l_max, p, min_seed_len, max_seeds,
                                      ist, tst, ist_out, tst_out, out, k_next, stream);
}

//   table as kart_sharded_occ4's, L2 (5,) T; k, out (n,) T; add (n,) int32
//   step counts, incremented where a row is not at a sample, or null (every
//   device but the first).
extern "C" int kart_sharded_inv_psi(const void* table, int n_shards, long long nb_local,
                                    const void* L2, int primary, const void* k, int n, void* out,
                                    void* add, void* stream) {
  return launch_inv_psi<int>(table, n_shards, nb_local, L2, primary, k, n, out, add, stream);
}

extern "C" int kart_sharded_inv_psi_i64(const void* table, int n_shards, long long nb_local,
                                        const void* L2, long long primary, const void* k, int n,
                                        void* out, void* add, void* stream) {
  return launch_inv_psi<long long>(table, n_shards, nb_local, L2, primary, k, n, out, add,
                                   stream);
}

//   table as kart_sharded_occ4's; rows, out (n,) T: out[i] = the full SA at
//   rows[i] (shift 0, the table's sa_full column, n_local = ns_local) or the
//   sampled SA at rows[i] >> 5 (shift 5, sa_samples, n_local = nsamp_local),
//   0 where the table does not hold the row's owner.  cudaErrorInvalidValue
//   for another shift.
extern "C" int kart_sharded_gather(const void* table, int n_shards, long long n_local,
                                   const void* rows, int n, int shift, void* out, void* stream) {
  return launch_gather<int>(table_sa<int>(table, n_shards, n_local, shift), rows, n, shift, out,
                            stream);
}

extern "C" int kart_sharded_gather_i64(const void* table, int n_shards, long long n_local,
                                       const void* rows, int n, int shift, void* out,
                                       void* stream) {
  return launch_gather<long long>(table_sa<long long>(table, n_shards, n_local, shift), rows, n,
                                  shift, out, stream);
}
