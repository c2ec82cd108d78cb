// Clock stamps and times of the sampled-SA walk's step on this card, in
// several designs side by side.  A thread a row walks it, as csrc/sa_walk.cu
// does, and the thread of one chosen row stamps each of its steps with
// clock64.  Not a kernel of the mapping path and not part of its library:
// tools/stamp_walk.py builds it on its own, with this checkout's
// fm_index.cuh, and reads the stamps.
//
// A step from row k (not at a sample): kk = k - (k >= primary), the block's
// addresses, the loads (its checkpoint row and eight BWT words), then the
// next row.  Four stamps a step: t0 with k known, ta with the addresses
// made, t1 with every loaded value in a register, t2 with the next row
// made.  Each stamp waits for what it follows by a store of it to shared
// memory.
//
// Designs (template parameter D):
//   0  fm_index.cuh's first design: size_t block numbers, the word at
//      kk by a chain of 7 selects, c, then 8 masked popcounts that wait for
//      c, pick4 of L2 and of the checkpoint;
//   1  c first: 32-bit block numbers, the word at kk by a tree of 3
//      selects, c's bases of a pair of words in one popcount (4 popcounts),
//      L2 and the checkpoint summed before c is known;
//   2  the four codes' counts (occ4_words' 12 popcounts) beside c, picked
//      at the end;
//   3, 4  designs 1 and 2 on 64-byte records (the checkpoint row, the eight
//      words, 16 bytes of padding at int32);
//   5  c first on 64-byte records whose last 16 bytes hold each code's
//      count in the words before each pair of words (a byte a code): one
//      popcount, of the pair that holds kk (int32 only);
//   6  c first on the two arrays: each pair of words muxed into its bases'
//      low bits and high bits (two LOP3s a pair, before c is known), c's
//      bases of a pair two more LOP3s and a popcount under a pair mask made
//      from kk before the loads return, the primary row by an AND, no
//      branch;
//   7  design 6 with its masks made before the loads are issued (the
//      addresses depend on them).
// With `pin` each loaded value passes an empty asm that names it (which,
// the SASS shows, does not keep the compiler from sinking a load), else the
// compiler places them unhindered.  The header's own step (fm_index.cuh's inv_psi_row
// on FlatIndex or ShardedIndex) is stamped whole: t0 and t2 only.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_index.cuh"

namespace {

constexpr int kStampThreads = 128;
constexpr int kMaxStamped = 1024;  // steps stamped at most

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

template <typename T>
struct Arrays {
  const typename CpRow<T>::type* occ_cp;
  const uint4* bwt4;
  const uint4* rec;  // (n_blocks * 4,): a block's 64-byte record, or null
  const T* sa_samples;
  T primary;
  T l2[4];
  unsigned zero;  // 0: design 7's dependency of the addresses on the masks
};

template <typename T>
struct Loaded {
  typename CpRow<T>::type cp;
  uint4 a, b, s;  // s: design 5's counts before each pair of words
};

template <typename T>
struct Where {
  const typename CpRow<T>::type* cp;
  const uint4* w;
};

// designs 6 and 7 use fm_index.cuh's pair_masks and word_at (design 6 is
// the header's step)

template <int D, typename T>
__device__ __forceinline__ Where<T> locate(const Arrays<T>& A, T kk) {
  if (D == 7) {
    unsigned mp[4];
    pair_masks(static_cast<int>(kk & 0x7F), mp);
    const unsigned b = static_cast<unsigned>(kk >> 7) + ((mp[0] ^ mp[1] ^ mp[2] ^ mp[3]) & A.zero);
    return {A.occ_cp + b, A.bwt4 + 2u * b};
  }
  if (D == 0) {
    const size_t b = static_cast<size_t>(kk >> 7);
    return {A.occ_cp + b, A.bwt4 + 2 * b};
  }
  const unsigned b = static_cast<unsigned>(kk >> 7);
  if (D <= 2 || D == 6) return {A.occ_cp + b, A.bwt4 + 2u * b};  // D 3-5: records
  const uint4* r = A.rec + 4u * b;
  using C = typename CpRow<T>::type;
  return {reinterpret_cast<const C*>(r), r + sizeof(C) / 16};
}

__device__ __forceinline__ void hold(unsigned& x) { asm volatile("" : "+r"(x)); }
__device__ __forceinline__ void hold(int& x) { asm volatile("" : "+r"(x)); }
#if defined(__CUDA_ARCH__)
__device__ __forceinline__ void hold(long long& x) { asm volatile("" : "+l"(x)); }
#else  // a host compiler's 64-bit register
__device__ __forceinline__ void hold(long long& x) { asm volatile("" : "+r"(x)); }
#endif
__device__ __forceinline__ void hold(uint4& v) { hold(v.x), hold(v.y), hold(v.z), hold(v.w); }
template <typename C>
__device__ __forceinline__ void hold_cp(C& v) {
  hold(v.x), hold(v.y), hold(v.z), hold(v.w);
}

template <int D, bool Pin, typename T>
__device__ __forceinline__ Loaded<T> load(Where<T> p) {
  Loaded<T> L{load_cp(p.cp, 0), __ldg(p.w), __ldg(p.w + 1),
              D == 5 ? __ldg(p.w + 2) : make_uint4(0, 0, 0, 0)};
  if (Pin) {
    hold_cp(L.cp);
    hold(L.a);
    hold(L.b);
    if (D == 5) hold(L.s);
  }
  return L;
}

template <int D, typename T>
__device__ __forceinline__ T next_row(const Arrays<T>& A, T k, T kk, const Loaded<T>& L) {
  const unsigned w[8] = {L.a.x, L.a.y, L.a.z, L.a.w, L.b.x, L.b.y, L.b.z, L.b.w};
  const int low = static_cast<int>(kk & 0x7F);
  const int jk = low >> 4;
  const int shift = (~low & 0xF) << 1;
  const unsigned part = ~((1u << shift) - 1u) & kM55;
  if (D == 0) {
    unsigned wk = w[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) wk = j == jk ? w[j] : wk;
    const int c = (wk >> shift) & 3;
    int n = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned m = j < jk ? kM55 : j == jk ? part : 0u;
      const unsigned lo = (c & 1) ? w[j] : ~w[j];
      const unsigned hi = (c & 2) ? w[j] >> 1 : ~(w[j] >> 1);
      n += __popc(lo & hi & m);
    }
    const T nk = pick4(c, A.l2[0], A.l2[1], A.l2[2], A.l2[3]) +
                 pick4(c, L.cp.x, L.cp.y, L.cp.z, L.cp.w) + n;
    return k == A.primary ? T(0) : nk;
  }
  if (D == 5) {
    const int s = jk >> 1;
    const unsigned we = (s & 1) ? ((s & 2) ? w[6] : w[2]) : ((s & 2) ? w[4] : w[0]);
    const unsigned wo = (s & 1) ? ((s & 2) ? w[7] : w[3]) : ((s & 2) ? w[5] : w[1]);
    const unsigned sw = (s & 1) ? ((s & 2) ? L.s.w : L.s.y) : ((s & 2) ? L.s.z : L.s.x);
    const bool odd = jk & 1;
    const T b0 = A.l2[0] + L.cp.x, b1 = A.l2[1] + L.cp.y, b2 = A.l2[2] + L.cp.z,
            b3 = A.l2[3] + L.cp.w;
    const int c = ((odd ? wo : we) >> shift) & 3;
    const unsigned me = odd ? kM55 : part, mo = odd ? part : 0u;
    const unsigned cpat = static_cast<unsigned>(c) * kM55;
    const unsigned x0 = we ^ cpat, x1 = wo ^ cpat;
    const int n = __popc((~(x0 | (x0 >> 1)) & me) | ((~(x1 | (x1 >> 1)) & mo) << 1)) +
                  static_cast<int>((sw >> (c << 3)) & 0xFF);
    return k == A.primary ? T(0) : pick4(c, b0, b1, b2, b3) + n;
  }
  if (D == 6 || D == 7) {
    unsigned mp[4];
    pair_masks(low, mp);
    const T b0 = A.l2[0] + L.cp.x, b1 = A.l2[1] + L.cp.y, b2 = A.l2[2] + L.cp.z,
            b3 = A.l2[3] + L.cp.w;
    unsigned lo[4], hi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = (w[2 * q] & kM55) | ((w[2 * q + 1] << 1) & ~kM55);
      hi[q] = ((w[2 * q] >> 1) & kM55) | (w[2 * q + 1] & ~kM55);
    }
    const int c = (word_at(w, jk) >> shift) & 3;
    const unsigned x0 = (c & 1) - 1u, x1 = ((c >> 1) & 1) - 1u;
    int n = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) n += __popc((lo[q] ^ x0) & (hi[q] ^ x1) & mp[q]);
    return (pick4(c, b0, b1, b2, b3) + n) & -static_cast<T>(k != A.primary);
  }
  const int c = (word_at(w, jk) >> shift) & 3;
  if (D == 1 || D == 3) {
    const T b0 = A.l2[0] + L.cp.x, b1 = A.l2[1] + L.cp.y, b2 = A.l2[2] + L.cp.z,
            b3 = A.l2[3] + L.cp.w;
    const unsigned cpat = static_cast<unsigned>(c) * kM55;
    int n = 0;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const unsigned m0 = j < jk ? kM55 : j == jk ? part : 0u;
      const unsigned m1 = j + 1 < jk ? kM55 : j + 1 == jk ? part : 0u;
      const unsigned x0 = w[j] ^ cpat, x1 = w[j + 1] ^ cpat;
      n += __popc((~(x0 | (x0 >> 1)) & m0) | ((~(x1 | (x1 >> 1)) & m1) << 1));
    }
    return k == A.primary ? T(0) : pick4(c, b0, b1, b2, b3) + n;
  }
  const typename CpRow<T>::type r = occ4_words(L.cp, L.a, L.b, kk);
  return k == A.primary ? T(0)
                        : pick4(c, A.l2[0] + r.x, A.l2[1] + r.y, A.l2[2] + r.z, A.l2[3] + r.w);
}

template <typename T>
__device__ __forceinline__ unsigned fold(const Loaded<T>& L) {
  return L.a.x ^ L.a.y ^ L.a.z ^ L.a.w ^ L.b.x ^ L.b.y ^ L.b.z ^ L.b.w ^ L.s.x ^ L.s.y ^ L.s.z ^
         L.s.w ^ static_cast<unsigned>(L.cp.x ^ L.cp.y ^ L.cp.z ^ L.cp.w);
}

// stamps (kMaxStamped, 4) of the target row's steps: t0, ta, t1, t2
template <int D, bool Pin, bool Stamp, typename T>
__global__ void __launch_bounds__(kStampThreads)
design_walk_kernel(Arrays<T> A, const T* __restrict__ rows, int n, int max_steps, int target,
                   long long* __restrict__ stamps, T* __restrict__ pos,
                   unsigned char* __restrict__ done) {
  __shared__ unsigned long long sink[kStampThreads];
  volatile unsigned long long* s = sink;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool me = Stamp && i == target;
  T k = __ldg(rows + i);
  int steps = 0;
  while ((k & 31) != 0 && steps < max_steps) {
    long long t0 = 0, ta = 0, t1 = 0;
    if (me) t0 = stamp();
    const T kk = k - (k >= A.primary ? 1 : 0);
    const Where<T> p = locate<D>(A, kk);
    if (me) {
      s[threadIdx.x] = reinterpret_cast<uintptr_t>(p.cp) ^ reinterpret_cast<uintptr_t>(p.w);
      ta = stamp();
    }
    const Loaded<T> L = load<D, Pin>(p);
    if (me) {
      s[threadIdx.x] = fold(L);
      t1 = stamp();
    }
    k = next_row<D>(A, k, kk, L);
    if (me) {
      s[threadIdx.x] = static_cast<unsigned long long>(k);
      const long long t2 = stamp();
      if (steps < kMaxStamped) {
        long long* o = stamps + 4 * steps;
        o[0] = t0;
        o[1] = ta;
        o[2] = t1;
        o[3] = t2;
      }
    }
    ++steps;
  }
  done[i] = (k & 31) == 0;
  pos[i] = static_cast<T>(steps) + __ldg(A.sa_samples + (k >> kSaIntvLog2));
}

// the header's own step, through either accessor, stamped whole
template <bool Stamp, typename T, typename Ix>
__global__ void __launch_bounds__(kStampThreads)
header_walk_kernel(FmWalk<T, Ix> fm, const T* __restrict__ L2, const T* __restrict__ rows, int n,
                   int max_steps, int target, long long* __restrict__ stamps, T* __restrict__ pos,
                   unsigned char* __restrict__ done) {
  extern __shared__ int smem[];
  __shared__ unsigned long long sink[kStampThreads];
  volatile unsigned long long* s = sink;
  FmWalk<T, Ix> f = fm;
  f.ix.stage(smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  load_l2(f, L2);
  const bool me = Stamp && i == target;
  T k = __ldg(rows + i);
  int steps = 0;
  while ((k & 31) != 0 && steps < max_steps) {
    long long t0 = 0;
    if (me) t0 = stamp();
    k = inv_psi_row(f, k);
    if (me) {
      s[threadIdx.x] = static_cast<unsigned long long>(k);
      const long long t2 = stamp();
      if (steps < kMaxStamped) {
        long long* o = stamps + 4 * steps;
        o[0] = o[1] = o[2] = t0;
        o[3] = t2;
      }
    }
    ++steps;
  }
  done[i] = (k & 31) == 0;
  pos[i] = static_cast<T>(steps) + f.ix.sample(k);
}

inline unsigned grid(int n) {
  return static_cast<unsigned>((n + kStampThreads - 1) / kStampThreads);
}

template <int D, bool Pin, typename T>
int launch_design(bool st, const Arrays<T>& A, const void* rows, int n, int max_steps, int target,
                  void* stamps, void* pos, void* done, cudaStream_t stream) {
  const T* r = static_cast<const T*>(rows);
  long long* sp = static_cast<long long*>(stamps);
  T* p = static_cast<T*>(pos);
  unsigned char* d = static_cast<unsigned char*>(done);
  if (st)
    design_walk_kernel<D, Pin, true, T><<<grid(n), kStampThreads, 0, stream>>>(A, r, n, max_steps,
                                                                          target, sp, p, d);
  else
    design_walk_kernel<D, Pin, false, T><<<grid(n), kStampThreads, 0, stream>>>(A, r, n, max_steps,
                                                                           target, sp, p, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int design_walk(int design, bool pin, bool st, const void* occ_cp, const void* bwt4,
                const void* rec, const void* sa_samples, const void* L2host, long long primary,
                const void* rows, int n, int max_steps, int target, void* stamps, void* pos,
                void* done, cudaStream_t stream) {
  Arrays<T> A;
  A.occ_cp = static_cast<const typename CpRow<T>::type*>(occ_cp);
  A.bwt4 = static_cast<const uint4*>(bwt4);
  A.rec = static_cast<const uint4*>(rec);
  A.sa_samples = static_cast<const T*>(sa_samples);
  A.primary = static_cast<T>(primary);
  for (int c = 0; c < 4; ++c) A.l2[c] = static_cast<const long long*>(L2host)[c];
  A.zero = 0;
#define KART_DESIGN(d)                                                                        \
  case d:                                                                                   \
    return pin ? launch_design<d, true, T>(st, A, rows, n, max_steps, target, stamps, pos,  \
                                           done, stream)                                    \
               : launch_design<d, false, T>(st, A, rows, n, max_steps, target, stamps, pos, \
                                            done, stream);
  switch (design) {
    KART_DESIGN(0)
    KART_DESIGN(1)
    KART_DESIGN(2)
    KART_DESIGN(3)
    KART_DESIGN(4)
    KART_DESIGN(5)
    KART_DESIGN(6)
    KART_DESIGN(7)
  }
#undef KART_DESIGN
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename Ix>
int launch_header(bool st, const Ix& ix, int n_shards, const void* L2, long long primary,
                  const void* rows, int n, int max_steps, int target, void* stamps, void* pos,
                  void* done, cudaStream_t stream) {
  FmWalk<T, Ix> fm;
  fm.ix = ix;
  fm.primary = static_cast<T>(primary);
  const size_t smem = Ix::smem_bytes(n_shards);
  const T* l2 = static_cast<const T*>(L2);
  const T* r = static_cast<const T*>(rows);
  long long* sp = static_cast<long long*>(stamps);
  T* p = static_cast<T*>(pos);
  unsigned char* d = static_cast<unsigned char*>(done);
  if (st)
    header_walk_kernel<true, T, Ix><<<grid(n), kStampThreads, smem, stream>>>(
        fm, l2, r, n, max_steps, target, sp, p, d);
  else
    header_walk_kernel<false, T, Ix><<<grid(n), kStampThreads, smem, stream>>>(
        fm, l2, r, n, max_steps, target, sp, p, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One walk of rows (n,) in a design (0-7) on the flat index: occ_cp, bwt4,
// sa_samples, rows, pos (n,) of the index type (int, or long long where
// i64), done (n,) bytes, rec the 64-byte records (designs 3-5) or null;
// `pin` holds the loads together;
// L2host four counts as 64-bit integers in host memory.  Where `stamp`,
// row `target`'s thread writes stamps (1024, 4) int64.
extern "C" int kart_stamp_design_walk(int design, int pin, int i64, int stamp, const void* occ_cp,
                                      const void* bwt4, const void* rec, const void* sa_samples,
                                      const void* L2host, long long primary, const void* rows,
                                      int n, int max_steps, int target, void* stamps, void* pos,
                                      void* done, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i64)
    return design_walk<long long>(design, pin, stamp, occ_cp, bwt4, rec, sa_samples, L2host,
                                  primary, rows, n, max_steps, target, stamps, pos, done, s);
  return design_walk<int>(design, pin, stamp, occ_cp, bwt4, rec, sa_samples, L2host, primary,
                          rows, n, max_steps, target, stamps, pos, done, s);
}

// The header's step: on the flat index (table null: occ_cp, bwt4,
// sa_samples) or through a shard table of every shard (table (n_shards, 4),
// nb_local, nsamp_local); L2 (5,) of the index type on the device.
extern "C" int kart_stamp_header_walk(int i64, int stamp, const void* table, int n_shards,
                                      long long nb_local, long long nsamp_local,
                                      const void* occ_cp, const void* bwt4,
                                      const void* sa_samples, const void* L2, long long primary,
                                      const void* rows, int n, int max_steps, int target,
                                      void* stamps, void* pos, void* done, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    if (i64) {
      ShardedIndex<long long> ix;
      ix.table = static_cast<const ShardSlabs<long long>*>(table);
      ix.n_shards = n_shards;
      ix.set_blocks(static_cast<unsigned>(nb_local));
      ix.nsamp_local = static_cast<unsigned>(nsamp_local);
      return launch_header<long long>(stamp, ix, n_shards, L2, primary, rows, n, max_steps,
                                      target, stamps, pos, done, s);
    }
    ShardedIndex<int> ix;
    ix.table = static_cast<const ShardSlabs<int>*>(table);
    ix.n_shards = n_shards;
    ix.set_blocks(static_cast<unsigned>(nb_local));
    ix.nsamp_local = static_cast<unsigned>(nsamp_local);
    return launch_header<int>(stamp, ix, n_shards, L2, primary, rows, n, max_steps, target, stamps,
                              pos, done, s);
  }
  if (i64) {
    FlatIndex<long long> ix;
    ix.occ_cp = static_cast<const LL4*>(occ_cp);
    ix.bwt4 = static_cast<const uint4*>(bwt4);
    ix.sa_samples = static_cast<const long long*>(sa_samples);
    return launch_header<long long>(stamp, ix, 0, L2, primary, rows, n, max_steps, target, stamps,
                                    pos, done, s);
  }
  FlatIndex<int> ix;
  ix.occ_cp = static_cast<const int4*>(occ_cp);
  ix.bwt4 = static_cast<const uint4*>(bwt4);
  ix.sa_samples = static_cast<const int*>(sa_samples);
  return launch_header<int>(stamp, ix, 0, L2, primary, rows, n, max_steps, target, stamps, pos,
                            done, s);
}
