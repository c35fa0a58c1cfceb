// Gathered-pair two-locus EM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ngsld_tpu/kernels/pallas_em.py::_em_kernel
// (pallas_em.py:57) together with its input prep (_prep/_layout): the same
// math as ngsld_tpu/ops/em.py, computed straight from the device-resident
// site table. Inputs: gn (S, I, 3) normal-space GLs, sidx (2, P) int32 site
// indices (row 0 anchors, row 1 partners), maf (S,). Outputs: f (P, 4),
// n_iter (P,) int32, n_used (P,) int32. The caller guarantees every index
// lies in [0, S).
//
// Arithmetic: the tables and f come in the table dtype (float or double),
// but the EM itself always runs in double (em_core.cuh). A float EM decides
// the stop iteration on float-rounded frequencies; where eps lands within
// that rounding of EPSILON (9.997e-6 in a real fixture) it stops one
// iteration away from the f64 reference, and on pairs with a small D'
// denominator that moves D' past the engine's f32 output contract.
//
// What bounds it on this card: each (pair, individual, iteration) costs
// 40 double-precision flops, one of them an IEEE division, so the work is
// operations: at I = 100 the fp64 pipe (29 instructions a term, 64 lanes a
// clock an SM) is the floor. A pair's rows are 24 I bytes of floats, read
// once from device memory.
//
// Design (what held the warp-per-pair kernel back, and the answer):
//  - Lane groups. G lanes take one pair (G a power of two picked from I by
//    the wrapper, kernels/pair_em.py::gather_group), so a warp runs 32 / G
//    pairs and at I = 100 no longer leaves a quarter of its lanes idle; the
//    four sums reduce over log2 G shuffle levels, and the fixed cost of an
//    iteration (the reductions, four IEEE divisions of em_update) is paid
//    for 32 / G pairs at once.
//  - A pair queue. The grid is persistent (blocks an SM from the occupancy
//    API, fewer when the pairs do not fill them); when a group's pair
//    stops, the group writes its outputs and takes the next pair index from
//    a global atomicAdd counter that the wrapper zeroes for each launch. A
//    group holds one pair at a time, so a launch with fewer pairs than
//    twice the resident groups spreads them over all groups (a pair fetched
//    one ahead left about a third of the groups idle at 16,384 pairs;
//    PERF.md has both versions' times). No lane waits for another pair's
//    convergence; only the launch's last pairs leave a tail. The
//    iteration body runs in uniform control flow across the warp; the
//    switch of a group to its next pair is one short divergent section,
//    closed by __syncwarp().
//  - The rows on chip once a pair. A group stages its pair's two rows into
//    its own slot of shared memory when it takes the pair (counting n_used
//    in the same pass), in the table's type, so the iteration loop reads
//    shared memory only (slots widened to doubles lost at every G: half
//    the resident warps cost more than the six F2F a term they save).
//    Lane q owns individuals q, q + G, ...: it stages and reads only its
//    own, so no barrier sits between staging and use, and plain loads
//    serve (the n_used count needs the values in registers anyway; no
//    cp.async). The slot stride (from the wrapper) is congruent to 3 G
//    words modulo the banks, so the 32 lanes of a warp hit 32 distinct
//    banks.
// Which group runs a pair changes from launch to launch; a pair's sums do
// not depend on it (lane q of any group adds the same individuals in the
// same order), so two launches on the same inputs give the same bits.
//
// Options (ngsld_pair_em_opts_f32/_f64; the TPU kernel's iter_cap, f0 and
// epsl_out/epsp_out, pallas_em.py:57-135): an iteration cap, a warm start
// f0 (P, 4) in double, and the export of each pair's last two update
// magnitudes, eps (P, 2) double [eps_last, eps_prev]. They run in a second
// instantiation of the kernel (kOpts); the entry points without them
// launch the first, whose code is the kernel's without options. On the
// option path f comes out in double whatever the table dtype: the EM's
// state is double, and a capped launch resumed warm from a rounded f would
// part from the one-phase run. eps_last and eps_prev start at 1 and change
// only while the pair runs (the iteration at which it stops writes them);
// n_iter is the stop iteration or iter_cap.
//
// Semantics kept exactly (ngsld_tpu/ops/em.py:34-107): f0 from the MAFs;
// n_used counts individuals that pass the miss test |g0-g1| < EPSILON &&
// |g1-g2| < EPSILON at both sites, only under ignore_miss_data; 1/x with
// x = 0 is inf, the update goes NaN and the NaN-ignoring fold
// `eps = d > eps ? d : eps` from 0 freezes the pair at n_iter 0 with NaN
// f; n_iter is the 0-based iteration at which eps first drops below
// EPSILON, ITER_MAX (100) when it never does. Divisions are IEEE (build
// without --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "em_core.cuh"

namespace {

using ngsld::em_term;
using ngsld::em_update;
using ngsld::is_miss;
using ngsld::kEpsilon;

constexpr int kIterMax = 100;      // ITER_MAX (gen_func.hpp:18)
constexpr int kThreads = 64;       // two warps a block (GATHER_THREADS)
constexpr unsigned kFullMask = 0xffffffffu;

// The sum of v over the G lanes of a group, in each of them (a butterfly:
// both lanes of a pair add the same two values, so all hold the same bits).
// `mask` names the lanes that take part: whole groups.
template <typename V>
__device__ __forceinline__ V group_sum(V v, int G, unsigned mask) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// The option path's inputs (kOpts): the cap, the warm start or null (f
// from the MAFs), the eps output or null.
struct EmOpts {
  int iter_cap;
  const double* f0;   // (P, 4)
  double* eps;        // (P, 2): eps_last, eps_prev
};

template <typename T, bool kIgnoreMiss, bool kOpts>
__global__ void __launch_bounds__(kThreads)
pair_em_kernel(const T* __restrict__ gn, const int32_t* __restrict__ sidx,
               const T* __restrict__ maf, int64_t P, int I, int G, int slot,
               unsigned long long* __restrict__ next,
               std::conditional_t<kOpts, double, T>* __restrict__ f_out,
               int32_t* __restrict__ n_iter_out,
               int32_t* __restrict__ n_used_out, EmOpts opts) {
  const int cap = kOpts ? opts.iter_cap : kIterMax;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int q = lane & (G - 1);       // this lane's place in its group
  const int lead = lane - q;          // the group's first lane
  T* __restrict__ r1 =
      reinterpret_cast<T*>(smem_raw) + (int64_t)(threadIdx.x / G) * slot;
  T* __restrict__ r2 = r1 + 3 * I;   // (I, 3) of site 1, then of site 2

  // the next pair index from the queue, in every lane of the group
  auto fetch = [&](unsigned mask) -> int64_t {
    unsigned long long v = 0;
    if (q == 0) v = atomicAdd(next, 1ull);
    return (int64_t)__shfl_sync(mask, v, lead);
  };

  int64_t p = fetch(kFullMask);
  double f0 = 0, f1 = 0, f2 = 0, f3 = 0, inv_x = 0;
  double e_last = 1.0, e_prev = 1.0;   // kOpts: the last two eps
  int cnt = 0, it = 0;

  // stage pair p's rows into the slot (this lane's individuals), count
  // n_used, start f from the MAFs (or from the warm start)
  auto take = [&](unsigned mask) {
    it = 0;
    cnt = 0;
    if (kOpts) e_last = e_prev = 1.0;
    if (p < P) {
      const int64_t s1 = sidx[p], s2 = sidx[P + p];
      const T* __restrict__ g1 = gn + s1 * I * 3;
      const T* __restrict__ g2 = gn + s2 * I * 3;
      for (int i = q; i < I; i += G) {
        const T x0 = g1[3 * i], x1 = g1[3 * i + 1], x2 = g1[3 * i + 2];
        const T y0 = g2[3 * i], y1 = g2[3 * i + 1], y2 = g2[3 * i + 2];
        if (kIgnoreMiss) {
          cnt += !(is_miss(x0, x1, x2) || is_miss(y0, y1, y2));
        } else {
          cnt += 1;
        }
        r1[3 * i] = x0;
        r1[3 * i + 1] = x1;
        r1[3 * i + 2] = x2;
        r2[3 * i] = y0;
        r2[3 * i + 1] = y1;
        r2[3 * i + 2] = y2;
      }
      if (kOpts && opts.f0) {
        f0 = opts.f0[4 * p];
        f1 = opts.f0[4 * p + 1];
        f2 = opts.f0[4 * p + 2];
        f3 = opts.f0[4 * p + 3];
      } else {
        const double m1 = maf[s1], m2 = maf[s2];
        f0 = (1.0 - m1) * (1.0 - m2);
        f1 = (1.0 - m1) * m2;
        f2 = m1 * (1.0 - m2);
        f3 = m1 * m2;
      }
    }
    cnt = group_sum(cnt, G, mask);
    inv_x = 1.0 / (double)cnt;
  };

  take(kFullMask);
  while (__any_sync(kFullMask, p < P)) {
    // one EM iteration of every group's pair, in uniform control flow
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    if (p < P) {
#pragma unroll 2
      for (int i = q; i < I; i += G) {
        const double x0 = r1[3 * i], x1 = r1[3 * i + 1], x2 = r1[3 * i + 2];
        const double y0 = r2[3 * i], y1 = r2[3 * i + 1], y2 = r2[3 * i + 2];
        em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                             a1, a2, a3);
      }
    }
    a0 = group_sum(a0, G, kFullMask);
    a1 = group_sum(a1, G, kFullMask);
    a2 = group_sum(a2, G, kFullMask);
    a3 = group_sum(a3, G, kFullMask);
    // every lane of a group holds the same sums, hence the same decision
    const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
    bool done = false;
    int n_iter = 0;
    if (p < P) {
      if (kOpts) {
        e_prev = e_last;
        e_last = eps;
      }
      if (eps < kEpsilon) {
        done = true;
        n_iter = it;
      } else if (++it == cap) {
        done = true;
        n_iter = cap;
      }
    }
    // the switch: the groups whose pair stopped write it and take the next
    const unsigned dmask = __ballot_sync(kFullMask, done);
    if (done) {
      if (q == 0) {
        using F = std::conditional_t<kOpts, double, T>;
        f_out[4 * p + 0] = (F)f0;
        f_out[4 * p + 1] = (F)f1;
        f_out[4 * p + 2] = (F)f2;
        f_out[4 * p + 3] = (F)f3;
        n_iter_out[p] = n_iter;
        n_used_out[p] = cnt;
        if (kOpts && opts.eps) {
          opts.eps[2 * p] = e_last;
          opts.eps[2 * p + 1] = e_prev;
        }
      }
      p = fetch(dmask);
      take(dmask);
    }
    __syncwarp();
  }
}

template <typename T, bool kIgnoreMiss, bool kOpts>
int launch_one(const T* g, const int32_t* ix, const T* m, int64_t P, int I,
               int G, int slot, unsigned long long* next, void* fo,
               int32_t* it, int32_t* nu, const EmOpts& opts, cudaStream_t st) {
  auto kern = pair_em_kernel<T, kIgnoreMiss, kOpts>;
  const size_t smem = (size_t)(kThreads / G) * slot * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // persistent: as many blocks as the card holds at once, fewer when the
  // pairs do not fill them
  const int64_t groups = kThreads / G;
  const int64_t blocks =
      std::min<int64_t>((int64_t)per_sm * sms, (P + groups - 1) / groups);
  using F = std::conditional_t<kOpts, double, T>;
  kern<<<(unsigned)blocks, kThreads, smem, st>>>(
      g, ix, m, P, I, G, slot, next, static_cast<F*>(fo), it, nu, opts);
  return (int)cudaGetLastError();
}

template <typename T, bool kOpts>
int launch(const void* gn, const void* sidx, const void* maf, int64_t P,
           int I, int G, int slot, int ignore_miss, const EmOpts& opts,
           void* next, void* f, void* n_iter, void* n_used, void* stream) {
  if (P <= 0) return 0;
  if (I <= 0 || G < 1 || G > 32 || (G & (G - 1)) || slot < 6 * I ||
      (kOpts && opts.iter_cap < 1))
    return (int)cudaErrorInvalidValue;
  const T* g = static_cast<const T*>(gn);
  const int32_t* ix = static_cast<const int32_t*>(sidx);
  const T* m = static_cast<const T*>(maf);
  unsigned long long* nx = static_cast<unsigned long long*>(next);
  int32_t* it = static_cast<int32_t*>(n_iter);
  int32_t* nu = static_cast<int32_t*>(n_used);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ignore_miss
             ? launch_one<T, true, kOpts>(g, ix, m, P, I, G, slot, nx, f, it,
                                          nu, opts, st)
             : launch_one<T, false, kOpts>(g, ix, m, P, I, G, slot, nx, f,
                                           it, nu, opts, st);
}

}  // namespace

extern "C" {

// slot: a group's shared-memory stride in table values; next: one zeroed
// 64-bit counter, the pair queue's head. f (P, 4) in the table dtype.
int ngsld_pair_em_f32(const void* gn, const void* sidx, const void* maf,
                      int64_t P, int I, int G, int slot, int ignore_miss,
                      void* next, void* f, void* n_iter, void* n_used,
                      void* stream) {
  return launch<float, false>(gn, sidx, maf, P, I, G, slot, ignore_miss,
                              EmOpts{kIterMax, nullptr, nullptr}, next, f,
                              n_iter, n_used, stream);
}

int ngsld_pair_em_f64(const void* gn, const void* sidx, const void* maf,
                      int64_t P, int I, int G, int slot, int ignore_miss,
                      void* next, void* f, void* n_iter, void* n_used,
                      void* stream) {
  return launch<double, false>(gn, sidx, maf, P, I, G, slot, ignore_miss,
                               EmOpts{kIterMax, nullptr, nullptr}, next, f,
                               n_iter, n_used, stream);
}

// The option path: iter_cap >= 1; f0 (P, 4) double or null (from the
// MAFs); eps (P, 2) double or null. f (P, 4) is double here.
int ngsld_pair_em_opts_f32(const void* gn, const void* sidx, const void* maf,
                           int64_t P, int I, int G, int slot, int ignore_miss,
                           int iter_cap, const void* f0, void* eps, void* next,
                           void* f, void* n_iter, void* n_used, void* stream) {
  return launch<float, true>(
      gn, sidx, maf, P, I, G, slot, ignore_miss,
      EmOpts{iter_cap, static_cast<const double*>(f0),
             static_cast<double*>(eps)},
      next, f, n_iter, n_used, stream);
}

int ngsld_pair_em_opts_f64(const void* gn, const void* sidx, const void* maf,
                           int64_t P, int I, int G, int slot, int ignore_miss,
                           int iter_cap, const void* f0, void* eps, void* next,
                           void* f, void* n_iter, void* n_used, void* stream) {
  return launch<double, true>(
      gn, sidx, maf, P, I, G, slot, ignore_miss,
      EmOpts{iter_cap, static_cast<const double*>(f0),
             static_cast<double*>(eps)},
      next, f, n_iter, n_used, stream);
}

}  // extern "C"
