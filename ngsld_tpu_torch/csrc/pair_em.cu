// Gathered-pair two-locus EM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ngsld_tpu/kernels/pallas_em.py::_em_kernel
// together with its input prep (_prep/_layout): the same math as
// ngsld_tpu/ops/em.py, computed straight from the device-resident site
// table. Inputs: gn (S, I, 3) normal-space GLs, sidx (2, P) int32 site
// indices (row 0 anchors, row 1 partners), maf (S,). Outputs: f (P, 4),
// n_iter (P,) int32, n_used (P,) int32. The caller guarantees every index
// lies in [0, S).
//
// Arithmetic: the tables and f come in the table dtype (float or double),
// but the EM itself always runs in double. A float EM decides the stop
// iteration on float-rounded frequencies; where eps lands within that
// rounding of EPSILON (9.997e-6 in a real fixture) it stops one iteration
// away from the f64 reference, and on pairs with a small D' denominator
// that moves D' past the engine's f32 output contract. This card's double
// rate makes the exact stop point cheap.
//
// What bounds it on this card: each (pair, individual, iteration) costs
// 40 double-precision flops, one of them an IEEE division (counted in
// em_core.cuh), and reads 24 bytes of GLs (48 from a double table). A
// pair's two GL rows are 6*I
// contiguous values (2.4 KB at I = 100 in float), re-read every
// iteration; they stay in L1/L2, so the loop is bound by arithmetic and by
// the per-iteration warp reductions rather than by device memory.
//
// Design: one warp per pair. Lanes stride over individuals, so the loads
// of a row coalesce; each lane accumulates its share of S_k =
// sum_i include_i * D_k[i] / s[i], and a butterfly shuffle gives every
// lane the four sums. Each warp iterates to its own convergence, so the
// per-pair freeze is exact and costs nothing, with no sorting of pairs
// by difficulty. The gather happens in the kernel: there is no (P, I, 3)
// copy and no relayout.
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

#include "em_core.cuh"

namespace {

using ngsld::em_term;
using ngsld::em_update;
using ngsld::is_miss;
using ngsld::kEpsilon;
using ngsld::warp_sum;

constexpr int kIterMax = 100;      // ITER_MAX (gen_func.hpp:18)
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T, bool kIgnoreMiss>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pair_em_kernel(const T* __restrict__ gn, const int32_t* __restrict__ sidx,
               const T* __restrict__ maf, int64_t P, int I,
               T* __restrict__ f_out, int32_t* __restrict__ n_iter_out,
               int32_t* __restrict__ n_used_out) {
  const int lane = threadIdx.x & 31;
  const int64_t p =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp leaves together

  const int64_t s1 = sidx[p], s2 = sidx[P + p];
  const T* __restrict__ g1 = gn + s1 * I * 3;
  const T* __restrict__ g2 = gn + s2 * I * 3;

  const double m1 = maf[s1], m2 = maf[s2];
  double f0 = (1.0 - m1) * (1.0 - m2), f1 = (1.0 - m1) * m2;
  double f2 = m1 * (1.0 - m2), f3 = m1 * m2;

  int cnt = 0;
  for (int i = lane; i < I; i += 32) {
    if (kIgnoreMiss) {
      const T* a = g1 + 3 * i;
      const T* b = g2 + 3 * i;
      cnt += !(is_miss(a[0], a[1], a[2]) || is_miss(b[0], b[1], b[2]));
    } else {
      cnt += 1;
    }
  }
  cnt = warp_sum(cnt);
  const double inv_x = 1.0 / (double)cnt;

  int n_iter = kIterMax;
  for (int it = 0; it < kIterMax; ++it) {
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int i = lane; i < I; i += 32) {
      const double x0 = g1[3 * i], x1 = g1[3 * i + 1], x2 = g1[3 * i + 2];
      const double y0 = g2[3 * i], y1 = g2[3 * i + 1], y2 = g2[3 * i + 2];
      em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                           a1, a2, a3);
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    a3 = warp_sum(a3);
    const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
    // every lane holds the same sums; take lane 0's decision so the warp
    // can never split at the break
    if (__shfl_sync(kFullMask, (int)(eps < kEpsilon), 0)) {
      n_iter = it;
      break;
    }
  }

  if (lane == 0) {
    f_out[4 * p + 0] = (T)f0;
    f_out[4 * p + 1] = (T)f1;
    f_out[4 * p + 2] = (T)f2;
    f_out[4 * p + 3] = (T)f3;
    n_iter_out[p] = n_iter;
    n_used_out[p] = cnt;
  }
}

template <typename T>
int launch(const void* gn, const void* sidx, const void* maf, int64_t P,
           int I, int ignore_miss, void* f, void* n_iter, void* n_used,
           void* stream) {
  if (P <= 0) return 0;
  const int threads = kWarpsPerBlock * 32;
  const int64_t blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gn);
  const int32_t* ix = static_cast<const int32_t*>(sidx);
  const T* m = static_cast<const T*>(maf);
  T* fo = static_cast<T*>(f);
  int32_t* it = static_cast<int32_t*>(n_iter);
  int32_t* nu = static_cast<int32_t*>(n_used);
  if (ignore_miss) {
    pair_em_kernel<T, true><<<(unsigned)blocks, threads, 0, st>>>(
        g, ix, m, P, I, fo, it, nu);
  } else {
    pair_em_kernel<T, false><<<(unsigned)blocks, threads, 0, st>>>(
        g, ix, m, P, I, fo, it, nu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ngsld_pair_em_f32(const void* gn, const void* sidx, const void* maf,
                      int64_t P, int I, int ignore_miss, void* f,
                      void* n_iter, void* n_used, void* stream) {
  return launch<float>(gn, sidx, maf, P, I, ignore_miss, f, n_iter, n_used,
                       stream);
}

int ngsld_pair_em_f64(const void* gn, const void* sidx, const void* maf,
                      int64_t P, int I, int ignore_miss, void* f,
                      void* n_iter, void* n_used, void* stream) {
  return launch<double>(gn, sidx, maf, P, I, ignore_miss, f, n_iter, n_used,
                        stream);
}

}  // extern "C"
