// Gathered-pair two-locus EM with the pair's rows resident in shared
// memory, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ngsld_tpu/kernels/pallas_em.py::_em_kernel_rows
// (with pair_em_rows / pair_em_rows_from_gl around it): the gather rung for
// cohorts whose two GL rows no longer fit a lane group's slot but still fit
// one block's shared memory. What makes that kernel what it is carries
// over: a pair's rows are loaded ONCE and stay on chip for every EM
// iteration. Inputs and outputs are those of pair_em.cu: gn (S, I, 3)
// normal-space GLs, sidx (2, P) int32, maf (S,) -> f (P, 4), n_iter (P,),
// n_used (P,). The gather happens here, through sidx: there is no
// (P, 3*Ip) gathered copy and no inclusion, f0 or 1/x tensor (the JAX
// wrapper materialises those only because Pallas blocks need them).
//
// Arithmetic, as in pair_em.cu: tables and f in the table dtype, the EM in
// double with IEEE division, the NaN-ignoring fold `eps = d > eps ? d : eps`
// from 0, x = 0 pairs frozen at n_iter 0 with NaN f. Build without
// --use_fast_math.
//
// What bounds it on this card: per (pair, individual, iteration) 40
// double-precision flops (counted in em_core.cuh) against 24 bytes of
// float GLs that are read from device memory once per pair and from shared
// memory afterwards: operations.
//
// Design: one thread block per pair, `threads` wide: the wrapper picks the
// narrowest power of two whose blocks, as many as an SM's shared memory
// holds, leave 16 warps an SM (kernels/pair_em.py::rows_threads). Dynamic
// shared memory holds two slots of the warps' sums (64 bytes a warp), then
// both rows (6 I values, 96 KB at I = 4,000 in float; the card's opt-in
// limit is the rung's ceiling, ngsld_smem_limits reports it). The rows are
// copied in once with cp.async, 16 bytes a copy where the rows allow it, so
// every copy of the block is in flight at once; n_used is then counted from
// shared memory. All warps stride over the individuals, four terms a trip;
// a row keeps the table's (I, 3) order, so a warp reads words 3 apart, free
// of bank conflicts. What an iteration pays besides its terms is cut to one
// block barrier and a few instructions a warp, none of them serial over
// the warps:
//  - a warp folds its four sums into one a group of 8 lanes (two shuffle
//    levels that halve the values a lane holds, then a 3-level butterfly),
//    6 shuffles in place of 20, and lane 8k writes sum k to slot it & 1;
//  - one __syncthreads; every warp then reads the block's W partials of
//    sum k in lanes 8k..8k+7 and adds them in a 3-level butterfly;
//  - the update runs lane-parallel: the lanes of group k form frequency k's
//    product and quotient, so the four IEEE divisions of em_update run at
//    once in one instruction stream; the new frequencies and the fold of
//    eps come back by shuffle. The operations are em_update's, in its
//    order, so the bits are its bits.
// Every warp adds the same values in the same order, so every thread holds
// the same frequencies and takes the same stop decision: no broadcast. Two
// slots make one barrier an iteration enough: a warp writes slot s again
// only after the next barrier, which every reader of s has passed.
//
// The cap (ngsld_pair_em_rows_cap_f32/_f64; the TPU kernel's iter_cap): a
// second instantiation of the kernel (kCap) stops the pairs still running
// at iter_cap with n_iter == iter_cap; the entry points without it keep
// ITER_MAX as a constant, and their code.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "em_core.cuh"

namespace {

using ngsld::em_term;
using ngsld::is_miss;
using ngsld::kEpsilon;
using ngsld::warp_sum;

constexpr int kIterMax = 100;      // ITER_MAX (gen_func.hpp:18)
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// n contiguous values, device memory -> shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, bool vec16,
                                      int tid, int nthr) {
  if (vec16) {
    constexpr int kPer = 16 / sizeof(T);
    for (int j = tid; j < n / kPer; j += nthr)
      __pipeline_memcpy_async(dst + j * kPer, src + j * kPer, 16);
  } else {
    for (int j = tid; j < n; j += nthr)
      __pipeline_memcpy_async(dst + j, src + j, sizeof(T));
  }
}

// The warp's four sums, one to each group of 8 lanes: lanes 8k..8k+7
// return sum k over the warp's 32 lanes, all with the same bits.
__device__ __forceinline__ double warp_sums4(double a0, double a1, double a2,
                                             double a3, int lane) {
  // xor 16: the low half keeps sums 0 and 1, the high half sums 2 and 3
  const bool hi = lane & 16;
  double k0 = hi ? a2 : a0, k1 = hi ? a3 : a1;
  k0 += __shfl_xor_sync(kFull, hi ? a0 : a2, 16);
  k1 += __shfl_xor_sync(kFull, hi ? a1 : a3, 16);
  // xor 8: lanes with bit 3 clear keep the first, set the second
  const bool b3 = lane & 8;
  double v = b3 ? k1 : k0;
  v += __shfl_xor_sync(kFull, b3 ? k0 : k1, 8);
  // a butterfly over the group: both lanes of a pair add the same values
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

// em_update (em_core.cuh) with frequency k in lanes 8k..8k+7, which hold
// sum k in v: the same operations in the same order, so the same bits,
// with the four divisions side by side. Every lane ends with all four new
// frequencies and returns the fold of the four |df|.
__device__ __forceinline__ double lane_update(double& f0, double& f1,
                                              double& f2, double& f3,
                                              double v, double inv_x,
                                              int lane) {
  const int k = lane >> 3;
  const double fk = k == 0 ? f0 : k == 1 ? f1 : k == 2 ? f2 : f3;
  const double n = fk * v * inv_x;
  const double norm = ((__shfl_sync(kFull, n, 0) + __shfl_sync(kFull, n, 8)) +
                       __shfl_sync(kFull, n, 16)) +
                      __shfl_sync(kFull, n, 24);
  const double q = n / norm;
  // the fold from 0 ignores NaN; the max of the rest does not depend on
  // the order
  const double d = fabs(q - fk);
  double eps = d > 0.0 ? d : 0.0, o;
  o = __shfl_xor_sync(kFull, eps, 8);
  eps = o > eps ? o : eps;
  o = __shfl_xor_sync(kFull, eps, 16);
  eps = o > eps ? o : eps;
  f0 = __shfl_sync(kFull, q, 0);
  f1 = __shfl_sync(kFull, q, 8);
  f2 = __shfl_sync(kFull, q, 16);
  f3 = __shfl_sync(kFull, q, 24);
  return eps;
}

template <typename T, bool kIgnoreMiss, bool kCap>
__global__ void __launch_bounds__(kMaxThreads)
pair_em_rows_kernel(const T* __restrict__ gn, const int32_t* __restrict__ sidx,
                    const T* __restrict__ maf, int64_t P, int I, int vec16,
                    T* __restrict__ f_out, int32_t* __restrict__ n_iter_out,
                    int32_t* __restrict__ n_used_out, int iter_cap) {
  const int cap = kCap ? iter_cap : kIterMax;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  // the warps' sums, slot it & 1: sum k of warp w at part[(4 slot + k) W
  // + w] (64 bytes a warp); then both rows, each (I, 3)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* __restrict__ part = reinterpret_cast<double*>(smem_raw);
  T* __restrict__ r1 = reinterpret_cast<T*>(part + 8 * nwarps);
  T* __restrict__ r2 = r1 + 3 * (int64_t)I;
  const int64_t p = blockIdx.x;
  const int64_t s1 = sidx[p], s2 = sidx[P + p];
  const T* __restrict__ g1 = gn + s1 * I * 3;
  const T* __restrict__ g2 = gn + s2 * I * 3;

  // the only read of device memory: both rows, once, every copy in flight
  stage(r1, g1, 3 * I, vec16, tid, nthr);
  stage(r2, g2, 3 * I, vec16, tid, nthr);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  int cnt = 0;
  for (int i = tid; i < I; i += nthr) {
    if (kIgnoreMiss) {
      const T* a = r1 + 3 * i;
      const T* b = r2 + 3 * i;
      cnt += !(is_miss(a[0], a[1], a[2]) || is_miss(b[0], b[1], b[2]));
    } else {
      cnt += 1;
    }
  }
  cnt = warp_sum(cnt);
  // slot 1 is free until iteration 1, which starts after every thread has
  // passed iteration 0's barrier, and so has read these
  int* cnt_w = reinterpret_cast<int*>(part + 4 * nwarps);
  if (lane == 0) cnt_w[warp] = cnt;
  __syncthreads();
  cnt = 0;
  for (int w = 0; w < nwarps; ++w) cnt += cnt_w[w];
  const double inv_x = 1.0 / (double)cnt;

  const double m1 = maf[s1], m2 = maf[s2];
  double f0 = (1.0 - m1) * (1.0 - m2), f1 = (1.0 - m1) * m2;
  double f2 = m1 * (1.0 - m2), f3 = m1 * m2;

  const int k = lane >> 3, j = lane & 7;
  int n_iter = cap;
  for (int it = 0; it < cap; ++it) {
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll 4
    for (int i = tid; i < I; i += nthr) {
      const double x0 = r1[3 * i], x1 = r1[3 * i + 1], x2 = r1[3 * i + 2];
      const double y0 = r2[3 * i], y1 = r2[3 * i + 1], y2 = r2[3 * i + 2];
      em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                           a1, a2, a3);
    }
    const double v = warp_sums4(a0, a1, a2, a3, lane);
    const int slot = it & 1;
    double* __restrict__ sums = part + (4 * slot + k) * nwarps;
    if (j == 0) sums[warp] = v;
    __syncthreads();
    // the block's sum k in lanes 8k..8k+7, added in the same order in
    // every warp
    double s = 0;
    for (int w = j; w < nwarps; w += 8) s += sums[w];
    s += __shfl_xor_sync(kFull, s, 4);
    s += __shfl_xor_sync(kFull, s, 2);
    s += __shfl_xor_sync(kFull, s, 1);
    if (lane_update(f0, f1, f2, f3, s, inv_x, lane) < kEpsilon) {
      n_iter = it;
      break;
    }
  }

  if (tid == 0) {
    f_out[4 * p + 0] = (T)f0;
    f_out[4 * p + 1] = (T)f1;
    f_out[4 * p + 2] = (T)f2;
    f_out[4 * p + 3] = (T)f3;
    n_iter_out[p] = n_iter;
    n_used_out[p] = cnt;
  }
}

template <typename T, bool kIgnoreMiss, bool kCap>
int launch_one(const T* g, const int32_t* ix, const T* m, int64_t P, int I,
               int threads, T* fo, int32_t* it, int32_t* nu, int iter_cap,
               cudaStream_t st) {
  auto kern = pair_em_rows_kernel<T, kIgnoreMiss, kCap>;
  const size_t smem = 2 * 3 * (size_t)I * sizeof(T) + 64 * (threads / 32);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every row (3 I values) and the table itself on
  // 16-byte boundaries
  constexpr int kPer = 16 / sizeof(T);
  const int vec16 = (3 * (int64_t)I) % kPer == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  kern<<<(unsigned)P, threads, smem, st>>>(g, ix, m, P, I, vec16, fo, it, nu,
                                            iter_cap);
  return (int)cudaGetLastError();
}

// iter_cap < 0: the instance without the cap (ITER_MAX, a constant)
template <typename T>
int launch(const void* gn, const void* sidx, const void* maf, int64_t P,
           int I, int threads, int ignore_miss, int iter_cap, void* f,
           void* n_iter, void* n_used, void* stream) {
  if (P <= 0) return 0;
  if (P > 0x7fffffff || I <= 0 || threads < 64 || threads > kMaxThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gn);
  const int32_t* ix = static_cast<const int32_t*>(sidx);
  const T* m = static_cast<const T*>(maf);
  T* fo = static_cast<T*>(f);
  int32_t* it = static_cast<int32_t*>(n_iter);
  int32_t* nu = static_cast<int32_t*>(n_used);
  if (iter_cap > 0)
    return ignore_miss ? launch_one<T, true, true>(g, ix, m, P, I, threads, fo,
                                                   it, nu, iter_cap, st)
                       : launch_one<T, false, true>(g, ix, m, P, I, threads,
                                                    fo, it, nu, iter_cap, st);
  return ignore_miss ? launch_one<T, true, false>(g, ix, m, P, I, threads, fo,
                                                  it, nu, kIterMax, st)
                     : launch_one<T, false, false>(g, ix, m, P, I, threads, fo,
                                                   it, nu, kIterMax, st);
}

}  // namespace

extern "C" {

// threads: the block's width, a multiple of 32 from 64 to 512
int ngsld_pair_em_rows_f32(const void* gn, const void* sidx, const void* maf,
                           int64_t P, int I, int threads, int ignore_miss,
                           void* f, void* n_iter, void* n_used,
                           void* stream) {
  return launch<float>(gn, sidx, maf, P, I, threads, ignore_miss, -1, f,
                       n_iter, n_used, stream);
}

int ngsld_pair_em_rows_f64(const void* gn, const void* sidx, const void* maf,
                           int64_t P, int I, int threads, int ignore_miss,
                           void* f, void* n_iter, void* n_used,
                           void* stream) {
  return launch<double>(gn, sidx, maf, P, I, threads, ignore_miss, -1, f,
                        n_iter, n_used, stream);
}

// The capped instance: iter_cap >= 1
int ngsld_pair_em_rows_cap_f32(const void* gn, const void* sidx,
                               const void* maf, int64_t P, int I, int threads,
                               int ignore_miss, int iter_cap, void* f,
                               void* n_iter, void* n_used, void* stream) {
  if (iter_cap < 1) return (int)cudaErrorInvalidValue;
  return launch<float>(gn, sidx, maf, P, I, threads, ignore_miss, iter_cap, f,
                       n_iter, n_used, stream);
}

int ngsld_pair_em_rows_cap_f64(const void* gn, const void* sidx,
                               const void* maf, int64_t P, int I, int threads,
                               int ignore_miss, int iter_cap, void* f,
                               void* n_iter, void* n_used, void* stream) {
  if (iter_cap < 1) return (int)cudaErrorInvalidValue;
  return launch<double>(gn, sidx, maf, P, I, threads, ignore_miss, iter_cap,
                        f, n_iter, n_used, stream);
}

// The current device's shared memory a block may use: without opting in
// (out[0]) and with cudaFuncAttributeMaxDynamicSharedMemorySize (out[1]).
// The gather ladder takes its two thresholds from these.
int ngsld_smem_limits(void* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  err = cudaDeviceGetAttribute(&o[0], cudaDevAttrMaxSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      &o[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // extern "C"
