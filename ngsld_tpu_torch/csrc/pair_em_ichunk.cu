// Gathered-pair two-locus EM for cohorts past the rows kernel, for Hopper
// (sm_90a), plain C interface: a pair's rows held across a thread-block
// cluster, and past the cluster's capacity streamed through shared memory.
//
// Replaces the TPU kernel ngsld_tpu/kernels/pallas_em.py::_em_kernel_ichunk
// (pallas_em.py:558, with pair_em_ichunk and make_site_table_chunked around
// it): the gather rung for cohorts of any size. Inputs and outputs are those
// of pair_em.cu: gn (S, I, 3), sidx (2, P) int32, maf (S,) -> f (P, 4),
// n_iter, n_used.
//
// Arithmetic, as in pair_em.cu: tables and f in the table dtype, the EM in
// double with IEEE division, the NaN-ignoring fold `eps = d > eps ? d : eps`
// from 0, x = 0 pairs frozen at n_iter 0 with NaN f. Build without
// --use_fast_math.
//
// What bounds it on this card: 40 double-precision flops per (pair,
// individual, iteration) (counted in em_core.cuh) against 24 bytes of
// float GLs: 1.7 flops a byte if the rows are read again every iteration,
// under the card's 10 double flops a byte. A kernel that re-reads them is
// bound by the bytes it re-reads (one block a pair streaming both rows every
// iteration runs at about 78% of that re-read floor at 2,048 pairs x
// 20,000); read once, the work is operations.
//
// Design, the cluster body (pair_em_cluster_kernel): one pair to a cluster
// of C blocks (C <= 8, portable). Each block stages its contiguous slice of
// both rows into its own shared memory once (cp.async, 16 bytes wide when
// aligned) and counts its share of n_used there; the rows are then read
// from shared memory for the whole EM. Per iteration each block reduces its
// slice's four sums (a warp shuffle tree, then thread 0 over the warps) and
// writes them to slot it & 1 of its shared memory; one cluster barrier; then
// every thread of every block reads the C blocks' sums through distributed
// shared memory (cluster.map_shared_rank) and adds them in rank order, so
// every thread holds the same bits and takes the same stop decision. With
// two slots one barrier an iteration is enough: a block writes slot s again
// only after the next barrier, which every reader of s has passed. A last
// barrier keeps a block's shared memory alive until no other block reads
// it. The wrapper picks C (kernels/pair_em.py::ichunk_cluster) and asks the
// card whether it holds such a cluster (ngsld_pair_em_cluster_occupancy)
// before it launches; a launch that fails raises. What is left bounding
// it: an iteration pays a fixed exchange besides its terms (the block's
// reduction, the cluster barrier, the DSMEM reads, the update's four
// dependent IEEE divisions; 1.3-3 us on an H100, measured by the probe
// probes/cluster_exchange.cu), so C is the smallest that fits two blocks
// an SM: the larger a block's slice, the more terms share that cost, and
// a second block on the SM computes while the first waits.
//
// Design, the streamed body (pair_em_ichunk_kernel), for cohorts past the
// largest cluster's shared memory: one thread block per pair. cp.async
// copies chunk g+1 of the stream (iteration-major, chunk-minor; after a
// pair's last chunk comes chunk 0 of its next iteration) into one buffer
// while the block computes on chunk g in the other; one __syncthreads per
// chunk both publishes the landed chunk and retires the buffer about to be
// overwritten. A row of the (S, I, 3) table is contiguous, so a chunk of
// individuals is one run of 3 IC values (no chunk-major copy of the table).
// Per iteration the four sums go through a warp shuffle tree and one shared
// array, every thread adds the warps' partial sums in the same order, and
// the stop decision is thread 0's, broadcast by __syncthreads_or. A block
// that stops waits for its last prefetch before it leaves. The chunk size
// is a launch argument.
//
// The cap (ngsld_pair_em_cluster_cap_* and ngsld_pair_em_ichunk_cap_*; the
// TPU kernel's iter_cap): a second instantiation of each body (kCap) stops
// the pairs still running at iter_cap with n_iter == iter_cap. Every block
// of a cluster computes the same eps from the same sums, and the cap is the
// same for all, so they leave the loop at the same iteration and reach the
// same cluster barriers. The entry points without the cap keep ITER_MAX as
// a constant, and their code.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "em_core.cuh"

namespace {

namespace cg = cooperative_groups;
using ngsld::em_term;
using ngsld::em_update;
using ngsld::is_miss;
using ngsld::kEpsilon;
using ngsld::warp_sum;

constexpr int kIterMax = 100;      // ITER_MAX (gen_func.hpp:18)
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
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

template <typename T, bool kIgnoreMiss, bool kCap>
__global__ void __launch_bounds__(kMaxThreads)
pair_em_ichunk_kernel(const T* __restrict__ gn,
                      const int32_t* __restrict__ sidx,
                      const T* __restrict__ maf, int64_t P, int I, int IC,
                      int vec16, T* __restrict__ f_out,
                      int32_t* __restrict__ n_iter_out,
                      int32_t* __restrict__ n_used_out, int iter_cap) {
  const int cap = kCap ? iter_cap : kIterMax;
  // two buffers x two sites x (IC, 3)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* __restrict__ bufs = reinterpret_cast<T*>(smem_raw);
  __shared__ double red[4][kMaxWarps];
  __shared__ int red_cnt[kMaxWarps];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int64_t p = blockIdx.x;
  const int64_t s1 = sidx[p], s2 = sidx[P + p];
  const T* __restrict__ g1 = gn + s1 * I * 3;
  const T* __restrict__ g2 = gn + s2 * I * 3;
  const int n_chunks = (I + IC - 1) / IC;

  auto prefetch = [&](int c, int b) {
    const int n = 3 * min(IC, I - c * IC);
    T* d = bufs + (int64_t)b * 2 * 3 * IC;
    stage(d, g1 + (int64_t)3 * c * IC, n, vec16, tid, nthr);
    stage(d + 3 * IC, g2 + (int64_t)3 * c * IC, n, vec16, tid, nthr);
    __pipeline_commit();
  };
  prefetch(0, 0);   // in flight under the n_used pass

  int cnt = 0;
  for (int i = tid; i < I; i += nthr) {
    if (kIgnoreMiss) {
      const T* a = g1 + 3 * i;
      const T* b = g2 + 3 * i;
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

  int n_iter = cap;
  int b = 0;   // the buffer that holds (or is receiving) the current chunk
  for (int it = 0; it < cap; ++it) {
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int c = 0; c < n_chunks; ++c) {
      __pipeline_wait_prior(0);
      // the chunk has landed for every thread, and every thread is done
      // with the other buffer
      __syncthreads();
      const int cn = c + 1 < n_chunks ? c + 1 : 0;
      if (cn != 0 || it + 1 < cap) prefetch(cn, b ^ 1);
      const T* __restrict__ r1 = bufs + (int64_t)b * 2 * 3 * IC;
      const T* __restrict__ r2 = r1 + 3 * IC;
      const int n_i = min(IC, I - c * IC);
      for (int i = tid; i < n_i; i += nthr) {
        const double x0 = r1[3 * i], x1 = r1[3 * i + 1], x2 = r1[3 * i + 2];
        const double y0 = r2[3 * i], y1 = r2[3 * i + 1], y2 = r2[3 * i + 2];
        em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                             a1, a2, a3);
      }
      b ^= 1;
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
    // thread 0 decides for the block; the barrier also frees `red`
    if (__syncthreads_or(tid == 0 && eps < kEpsilon)) {
      n_iter = it;
      break;
    }
  }
  // no copy may still be writing this block's shared memory when it leaves
  __pipeline_wait_prior(0);

  if (tid == 0) {
    f_out[4 * p + 0] = (T)f0;
    f_out[4 * p + 1] = (T)f1;
    f_out[4 * p + 2] = (T)f2;
    f_out[4 * p + 3] = (T)f3;
    n_iter_out[p] = n_iter;
    n_used_out[p] = cnt;
  }
}

constexpr int kClusterThreads = 512;   // at most, a block of the cluster body
constexpr int kClusterWarps = kClusterThreads / 32;

template <typename T, bool kIgnoreMiss, bool kCap>
__global__ void __launch_bounds__(kClusterThreads)
pair_em_cluster_kernel(const T* __restrict__ gn,
                       const int32_t* __restrict__ sidx,
                       const T* __restrict__ maf, int64_t P, int I, int slice,
                       int vec16, T* __restrict__ f_out,
                       int32_t* __restrict__ n_iter_out,
                       int32_t* __restrict__ n_used_out, int iter_cap) {
  const int cap = kCap ? iter_cap : kIterMax;
  // this block's slice of both rows: (slice, 3) of site 1, then of site 2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* __restrict__ r1 = reinterpret_cast<T*>(smem_raw);
  T* __restrict__ r2 = r1 + 3 * slice;
  __shared__ double red[4][kClusterWarps];
  __shared__ int red_cnt[kClusterWarps];
  __shared__ double sums[2][4];   // slot it & 1: this block's four sums
  __shared__ int cnt_block;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int64_t p = blockIdx.x / C;
  const int64_t s1 = sidx[p], s2 = sidx[P + p];
  const int i0 = rank * slice;
  const int n = max(0, min(slice, I - i0));   // individuals in this slice

  // the only read of device memory: this block's slice of both rows, once
  stage(r1, gn + (s1 * I + i0) * 3, 3 * n, vec16, tid, nthr);
  stage(r2, gn + (s2 * I + i0) * 3, 3 * n, vec16, tid, nthr);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  int cnt = 0;
  for (int i = tid; i < n; i += nthr) {
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
  if (tid == 0) {
    int c = 0;
    for (int w = 0; w < nwarps; ++w) c += red_cnt[w];
    cnt_block = c;
  }
  cluster.sync();
  cnt = 0;
  for (int r = 0; r < C; ++r) cnt += *cluster.map_shared_rank(&cnt_block, r);
  const double inv_x = 1.0 / (double)cnt;

  const double m1 = maf[s1], m2 = maf[s2];
  double f0 = (1.0 - m1) * (1.0 - m2), f1 = (1.0 - m1) * m2;
  double f2 = m1 * (1.0 - m2), f3 = m1 * m2;

  int n_iter = cap;
  for (int it = 0; it < cap; ++it) {
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int i = tid; i < n; i += nthr) {
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
    const int slot = it & 1;
    if (tid == 0) {
      double b0 = 0, b1 = 0, b2 = 0, b3 = 0;
      for (int w = 0; w < nwarps; ++w) {
        b0 += red[0][w];
        b1 += red[1][w];
        b2 += red[2][w];
        b3 += red[3][w];
      }
      sums[slot][0] = b0;
      sums[slot][1] = b1;
      sums[slot][2] = b2;
      sums[slot][3] = b3;
    }
    cluster.sync();
    // the cluster's sums, added in rank order: the same bits everywhere
    a0 = a1 = a2 = a3 = 0;
    for (int r = 0; r < C; ++r) {
      const double* o = cluster.map_shared_rank(&sums[slot][0], r);
      a0 += o[0];
      a1 += o[1];
      a2 += o[2];
      a3 += o[3];
    }
    const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
    if (eps < kEpsilon) {
      n_iter = it;
      break;
    }
  }
  // no block may leave while another can still read its sums
  cluster.sync();

  if (rank == 0 && tid == 0) {
    f_out[4 * p + 0] = (T)f0;
    f_out[4 * p + 1] = (T)f1;
    f_out[4 * p + 2] = (T)f2;
    f_out[4 * p + 3] = (T)f3;
    n_iter_out[p] = n_iter;
    n_used_out[p] = cnt;
  }
}

// The launch of the cluster body: P clusters of C blocks, each with `slice`
// individuals of both rows in its dynamic shared memory. With occupancy
// set, only asks the card how many such clusters it holds at once.
template <typename T, bool kIgnoreMiss, bool kCap>
int cluster_one(const T* g, const int32_t* ix, const T* m, int64_t P, int I,
                int C, int threads, T* fo, int32_t* it, int32_t* nu,
                int iter_cap, cudaStream_t st, int* occupancy) {
  auto kern = pair_em_cluster_kernel<T, kIgnoreMiss, kCap>;
  constexpr int kPer = 16 / sizeof(T);
  // slices on whole 16-byte runs of the row
  const int slice = ((I + C - 1) / C + kPer - 1) / kPer * kPer;
  const size_t smem = 2 * 3 * (size_t)slice * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * C), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occupancy) {
    return (int)cudaOccupancyMaxActiveClusters(occupancy, (void*)kern, &cfg);
  }
  const int vec16 = (3 * (int64_t)I) % kPer == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, kern, g, ix, m, P, I, slice, vec16, fo, it,
                           nu, iter_cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// iter_cap < 0: the instance without the cap (ITER_MAX, a constant)
template <typename T>
int cluster_launch(const void* gn, const void* sidx, const void* maf,
                   int64_t P, int I, int C, int threads, int ignore_miss,
                   int iter_cap, void* f, void* n_iter, void* n_used,
                   void* stream, int* occupancy) {
  if (P <= 0 && !occupancy) return 0;
  if (P > 0x7fffffff / 8 || I <= 0 || C < 1 || C > 8 || threads < 32 ||
      threads > kClusterThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const T* g = static_cast<const T*>(gn);
  const int32_t* ix = static_cast<const int32_t*>(sidx);
  const T* m = static_cast<const T*>(maf);
  T* fo = static_cast<T*>(f);
  int32_t* it = static_cast<int32_t*>(n_iter);
  int32_t* nu = static_cast<int32_t*>(n_used);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 0) P = 1;   // an occupancy question only
  if (iter_cap > 0)
    return ignore_miss
               ? cluster_one<T, true, true>(g, ix, m, P, I, C, threads, fo, it,
                                            nu, iter_cap, st, occupancy)
               : cluster_one<T, false, true>(g, ix, m, P, I, C, threads, fo,
                                             it, nu, iter_cap, st, occupancy);
  return ignore_miss
             ? cluster_one<T, true, false>(g, ix, m, P, I, C, threads, fo, it,
                                           nu, kIterMax, st, occupancy)
             : cluster_one<T, false, false>(g, ix, m, P, I, C, threads, fo, it,
                                            nu, kIterMax, st, occupancy);
}

template <typename T, bool kIgnoreMiss, bool kCap>
int launch_one(const T* g, const int32_t* ix, const T* m, int64_t P, int I,
               int IC, T* fo, int32_t* it, int32_t* nu, int iter_cap,
               cudaStream_t st) {
  const size_t smem = 2 * 2 * 3 * (size_t)IC * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      pair_em_ichunk_kernel<T, kIgnoreMiss, kCap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every row, every chunk and the table itself on
  // 16-byte boundaries
  constexpr int kPer = 16 / sizeof(T);
  const int vec16 = (3 * (int64_t)I) % kPer == 0 && (3 * IC) % kPer == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  int threads = 64;
  while (threads < kMaxThreads && threads * 4 < IC) threads <<= 1;
  pair_em_ichunk_kernel<T, kIgnoreMiss, kCap>
      <<<(unsigned)P, threads, smem, st>>>(g, ix, m, P, I, IC, vec16, fo, it,
                                           nu, iter_cap);
  return (int)cudaGetLastError();
}

// iter_cap < 0: the instance without the cap (ITER_MAX, a constant)
template <typename T>
int launch(const void* gn, const void* sidx, const void* maf, int64_t P,
           int I, int IC, int ignore_miss, int iter_cap, void* f,
           void* n_iter, void* n_used, void* stream) {
  if (P <= 0) return 0;
  if (P > 0x7fffffff || I <= 0 || IC <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gn);
  const int32_t* ix = static_cast<const int32_t*>(sidx);
  const T* m = static_cast<const T*>(maf);
  T* fo = static_cast<T*>(f);
  int32_t* it = static_cast<int32_t*>(n_iter);
  int32_t* nu = static_cast<int32_t*>(n_used);
  if (iter_cap > 0)
    return ignore_miss ? launch_one<T, true, true>(g, ix, m, P, I, IC, fo, it,
                                                   nu, iter_cap, st)
                       : launch_one<T, false, true>(g, ix, m, P, I, IC, fo, it,
                                                    nu, iter_cap, st);
  return ignore_miss ? launch_one<T, true, false>(g, ix, m, P, I, IC, fo, it,
                                                  nu, kIterMax, st)
                     : launch_one<T, false, false>(g, ix, m, P, I, IC, fo, it,
                                                   nu, kIterMax, st);
}

}  // namespace

extern "C" {

int ngsld_pair_em_ichunk_f32(const void* gn, const void* sidx,
                             const void* maf, int64_t P, int I, int i_chunk,
                             int ignore_miss, void* f, void* n_iter,
                             void* n_used, void* stream) {
  return launch<float>(gn, sidx, maf, P, I, i_chunk, ignore_miss, -1, f,
                       n_iter, n_used, stream);
}

int ngsld_pair_em_ichunk_f64(const void* gn, const void* sidx,
                             const void* maf, int64_t P, int I, int i_chunk,
                             int ignore_miss, void* f, void* n_iter,
                             void* n_used, void* stream) {
  return launch<double>(gn, sidx, maf, P, I, i_chunk, ignore_miss, -1, f,
                        n_iter, n_used, stream);
}

// The cluster body: P clusters of C blocks of `threads` threads.
int ngsld_pair_em_cluster_f32(const void* gn, const void* sidx,
                              const void* maf, int64_t P, int I, int C,
                              int threads, int ignore_miss, void* f,
                              void* n_iter, void* n_used, void* stream) {
  return cluster_launch<float>(gn, sidx, maf, P, I, C, threads, ignore_miss,
                               -1, f, n_iter, n_used, stream, nullptr);
}

int ngsld_pair_em_cluster_f64(const void* gn, const void* sidx,
                              const void* maf, int64_t P, int I, int C,
                              int threads, int ignore_miss, void* f,
                              void* n_iter, void* n_used, void* stream) {
  return cluster_launch<double>(gn, sidx, maf, P, I, C, threads, ignore_miss,
                                -1, f, n_iter, n_used, stream, nullptr);
}

// How many clusters of the cluster body (C blocks of `threads` threads, I
// individuals, f64 tables or not) the current device holds at once, into
// out[0]; 0 means it cannot launch one.
int ngsld_pair_em_cluster_occupancy(int f64, int I, int C, int threads,
                                    int ignore_miss, void* out) {
  int* o = static_cast<int*>(out);
  *o = 0;
  return f64 ? cluster_launch<double>(nullptr, nullptr, nullptr, 0, I, C,
                                      threads, ignore_miss, -1, nullptr,
                                      nullptr, nullptr, nullptr, o)
             : cluster_launch<float>(nullptr, nullptr, nullptr, 0, I, C,
                                     threads, ignore_miss, -1, nullptr, nullptr,
                                     nullptr, nullptr, o);
}

// The capped instances of both bodies: iter_cap >= 1
int ngsld_pair_em_ichunk_cap_f32(const void* gn, const void* sidx,
                                 const void* maf, int64_t P, int I,
                                 int i_chunk, int ignore_miss, int iter_cap,
                                 void* f, void* n_iter, void* n_used,
                                 void* stream) {
  if (iter_cap < 1) return (int)cudaErrorInvalidValue;
  return launch<float>(gn, sidx, maf, P, I, i_chunk, ignore_miss, iter_cap, f,
                       n_iter, n_used, stream);
}

int ngsld_pair_em_ichunk_cap_f64(const void* gn, const void* sidx,
                                 const void* maf, int64_t P, int I,
                                 int i_chunk, int ignore_miss, int iter_cap,
                                 void* f, void* n_iter, void* n_used,
                                 void* stream) {
  if (iter_cap < 1) return (int)cudaErrorInvalidValue;
  return launch<double>(gn, sidx, maf, P, I, i_chunk, ignore_miss, iter_cap,
                        f, n_iter, n_used, stream);
}

int ngsld_pair_em_cluster_cap_f32(const void* gn, const void* sidx,
                                  const void* maf, int64_t P, int I, int C,
                                  int threads, int ignore_miss, int iter_cap,
                                  void* f, void* n_iter, void* n_used,
                                  void* stream) {
  if (iter_cap < 1) return (int)cudaErrorInvalidValue;
  return cluster_launch<float>(gn, sidx, maf, P, I, C, threads, ignore_miss,
                               iter_cap, f, n_iter, n_used, stream, nullptr);
}

int ngsld_pair_em_cluster_cap_f64(const void* gn, const void* sidx,
                                  const void* maf, int64_t P, int I, int C,
                                  int threads, int ignore_miss, int iter_cap,
                                  void* f, void* n_iter, void* n_used,
                                  void* stream) {
  if (iter_cap < 1) return (int)cudaErrorInvalidValue;
  return cluster_launch<double>(gn, sidx, maf, P, I, C, threads, ignore_miss,
                                iter_cap, f, n_iter, n_used, stream, nullptr);
}

}  // extern "C"
