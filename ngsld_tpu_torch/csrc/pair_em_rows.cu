// Gathered-pair two-locus EM with the pair's rows resident in shared
// memory, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ngsld_tpu/kernels/pallas_em.py::_em_kernel_rows
// (with pair_em_rows / pair_em_rows_from_gl around it): the gather rung for
// cohorts whose two GL rows no longer sit in L1 under a warp but still fit
// on chip. What makes that kernel what it is carries over: a pair's rows
// are loaded ONCE and stay on chip for every EM iteration. Inputs and
// outputs are those of pair_em.cu: gn (S, I, 3) normal-space GLs, sidx
// (2, P) int32, maf (S,) -> f (P, 4), n_iter (P,), n_used (P,). The gather
// happens here, through sidx: there is no (P, 3*Ip) gathered copy and no
// inclusion, f0 or 1/x tensor (the JAX wrapper materialises those only
// because Pallas blocks need them).
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
// Design: one thread block per pair. The two rows (2 * 3 * I values, 96 KB
// at I = 4,000 in float) are staged once into dynamic shared memory (above
// 48 KB through cudaFuncAttributeMaxDynamicSharedMemorySize; the card's
// opt-in limit is the rung's ceiling, ngsld_smem_limits reports it). All
// warps stride over individuals; a row keeps the table's (I, 3) order, so
// a warp reads words 3 apart, which is free of bank conflicts. Per
// iteration the four sums go through a warp shuffle tree and one shared
// array; every thread adds the warps' partial sums in the same order and so
// holds the same new frequencies. The stop decision is thread 0's,
// broadcast by __syncthreads_or, so a block can never split at the break.

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
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
template <typename T, bool kIgnoreMiss>
__global__ void __launch_bounds__(kMaxThreads)
pair_em_rows_kernel(const T* __restrict__ gn, const int32_t* __restrict__ sidx,
                    const T* __restrict__ maf, int64_t P, int I,
                    T* __restrict__ f_out, int32_t* __restrict__ n_iter_out,
                    int32_t* __restrict__ n_used_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* __restrict__ r1 = reinterpret_cast<T*>(smem_raw);   // (I, 3) of site 1
  T* __restrict__ r2 = r1 + 3 * (int64_t)I;              // (I, 3) of site 2
  __shared__ double red[4][kMaxWarps];
  __shared__ int red_cnt[kMaxWarps];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int64_t p = blockIdx.x;
  const int64_t s1 = sidx[p], s2 = sidx[P + p];
  const T* __restrict__ g1 = gn + s1 * I * 3;
  const T* __restrict__ g2 = gn + s2 * I * 3;

  // the only read of device memory: both rows, coalesced, once
  for (int j = tid; j < 3 * I; j += nthr) {
    r1[j] = g1[j];
    r2[j] = g2[j];
  }
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
  if (lane == 0) red_cnt[warp] = cnt;
  __syncthreads();
  cnt = 0;
  for (int w = 0; w < nwarps; ++w) cnt += red_cnt[w];
  const double inv_x = 1.0 / (double)cnt;

  const double m1 = maf[s1], m2 = maf[s2];
  double f0 = (1.0 - m1) * (1.0 - m2), f1 = (1.0 - m1) * m2;
  double f2 = m1 * (1.0 - m2), f3 = m1 * m2;

  int n_iter = kIterMax;
  for (int it = 0; it < kIterMax; ++it) {
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int i = tid; i < I; i += nthr) {
      const double x0 = r1[3 * i], x1 = r1[3 * i + 1], x2 = r1[3 * i + 2];
      const double y0 = r2[3 * i], y1 = r2[3 * i + 1], y2 = r2[3 * i + 2];
      em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                           a1, a2, a3);
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    a3 = warp_sum(a3);
    if (lane == 0) {
      red[0][warp] = a0;
      red[1][warp] = a1;
      red[2][warp] = a2;
      red[3][warp] = a3;
    }
    __syncthreads();
    a0 = a1 = a2 = a3 = 0;
    for (int w = 0; w < nwarps; ++w) {
      a0 += red[0][w];
      a1 += red[1][w];
      a2 += red[2][w];
      a3 += red[3][w];
    }
    const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
    // thread 0 decides for the block; the barrier also frees `red` for the
    // next iteration
    if (__syncthreads_or(tid == 0 && eps < kEpsilon)) {
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

template <typename T, bool kIgnoreMiss>
int launch_one(const T* g, const int32_t* ix, const T* m, int64_t P, int I,
               T* fo, int32_t* it, int32_t* nu, cudaStream_t st) {
  const size_t smem = 2 * 3 * (size_t)I * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      pair_em_rows_kernel<T, kIgnoreMiss>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // about 8 individuals a thread and iteration, between 2 and 16 warps
  int threads = 64;
  while (threads < kMaxThreads && threads * 8 < I) threads <<= 1;
  pair_em_rows_kernel<T, kIgnoreMiss><<<(unsigned)P, threads, smem, st>>>(
      g, ix, m, P, I, fo, it, nu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* gn, const void* sidx, const void* maf, int64_t P,
           int I, int ignore_miss, void* f, void* n_iter, void* n_used,
           void* stream) {
  if (P <= 0) return 0;
  if (P > 0x7fffffff || I <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gn);
  const int32_t* ix = static_cast<const int32_t*>(sidx);
  const T* m = static_cast<const T*>(maf);
  T* fo = static_cast<T*>(f);
  int32_t* it = static_cast<int32_t*>(n_iter);
  int32_t* nu = static_cast<int32_t*>(n_used);
  return ignore_miss ? launch_one<T, true>(g, ix, m, P, I, fo, it, nu, st)
                     : launch_one<T, false>(g, ix, m, P, I, fo, it, nu, st);
}

}  // namespace

extern "C" {

int ngsld_pair_em_rows_f32(const void* gn, const void* sidx, const void* maf,
                           int64_t P, int I, int ignore_miss, void* f,
                           void* n_iter, void* n_used, void* stream) {
  return launch<float>(gn, sidx, maf, P, I, ignore_miss, f, n_iter, n_used,
                       stream);
}

int ngsld_pair_em_rows_f64(const void* gn, const void* sidx, const void* maf,
                           int64_t P, int I, int ignore_miss, void* f,
                           void* n_iter, void* n_used, void* stream) {
  return launch<double>(gn, sidx, maf, P, I, ignore_miss, f, n_iter, n_used,
                        stream);
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
