// Strip-tile two-locus EM with the individual axis streamed through shared
// memory, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// ngsld_tpu/kernels/pallas_strip.py::_strip_ichunk_kernel: the rectangle EM
// of strip_em.cu (same tables, same tile list, same four outputs, same
// per-cell semantics: see that file's header) for cohorts whose strips no
// longer stay on chip. A tile's EM state stays resident while the
// individual axis passes by in chunks of IC individuals inside every EM
// iteration, so one partner chunk serves every anchor row of the block:
// the reuse the TPU kernel is built on. The tables' individual axis must be
// padded to a multiple of IC (strip_tables(i_align=IC)); padded individuals
// are never counted (loops stop at I; the standardized E[G] pads are 0).
// The anchor and partner tables may cover different site ranges.
//
// Arithmetic, as in strip_em.cu: tables and outputs float, the EM and the
// r2p dot in double (never a TF32 product) with IEEE division, the
// NaN-ignoring fold `eps = d > eps ? d : eps` from 0, n_used = 0 cells
// frozen at n_iter 0 with NaN f, dead cells at the f0 init with
// n_iter = iter_cap and still given r2p and n_used. A thread adds its
// cell's individuals in index order, chunk after chunk: the same order as
// strip_em.cu, so the two kernels agree bit for bit. Build without
// --use_fast_math.
//
// What bounds it on this card: 40 double-precision flops per (cell,
// individual, iteration) (counted in em_core.cuh) against 24 bytes of
// float GLs that come from shared memory, staged once per block and
// iteration: operations.
//
// Design: a block owns 8 anchors x 32 partners of a tile; each thread keeps
// its cell's four frequencies and four sums in registers (the TPU kernel's
// fs and S planes). A warp is 32 consecutive partners of one anchor: the
// anchor's values are a shared-memory broadcast, the partners' one
// conflict-free line. Per chunk the block stages the anchors' planes
// (3 x 8 x IC) and the partners' (3 x IC x 32) with cp.async into one of
// two buffers while it computes on the other; one __syncthreads per chunk
// publishes the landed chunk and retires the buffer about to be
// overwritten. The stream is iteration-major: after an iteration's last
// chunk comes chunk 0 of the next. A pre-pass over the same chunks
// accumulates r2p from the E[G] planes and, under ignore_miss, n_used from
// the GL planes. A cell that has converged (or is dead) leaves the
// arithmetic but its thread keeps staging and keeps every barrier, so
// control flow stays uniform; the block ends when __syncthreads_or finds no
// active cell, after waiting for its last prefetch. Copies are 16 bytes
// wide when the tables allow it, else 4.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "em_core.cuh"

namespace {

using ngsld::em_term;
using ngsld::em_update;
using ngsld::is_miss;
using ngsld::kEpsilon;

constexpr int kRows = 8;           // anchors per block
constexpr int kCols = 32;          // partners per block: one warp per row
constexpr int kThreads = kRows * kCols;
constexpr int kPlanes = 4;         // g0, g1, g2, standardized E[G]

struct Tables {
  const float* a[kPlanes];   // anchor planes, each (Sa, Ip)
  const float* b[kPlanes];   // partner planes, each (Ip, Sb)
};

// floats of one buffer: anchors (plane, row, i) then partners (plane, i, col)
__host__ __device__ constexpr int64_t buf_floats(int IC) {
  return (int64_t)kPlanes * (kRows + kCols) * IC;
}

template <bool kIgnoreMiss>
__global__ void __launch_bounds__(kThreads)
strip_em_stream_kernel(Tables tabs, const float* __restrict__ maf_a,
                       const float* __restrict__ maf_b,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ hi,
                       const float* __restrict__ ok_a,
                       const float* __restrict__ ok_b,
                       const int32_t* __restrict__ ta,
                       const int32_t* __restrict__ tb, int64_t Sb, int Ip,
                       int I, int IC, int vec16, int TA, int TB, int iter_cap,
                       float* __restrict__ f_out, float* __restrict__ r2p_out,
                       int32_t* __restrict__ n_iter_out,
                       int32_t* __restrict__ n_used_out) {
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int t = blockIdx.x;
  const int col_blocks = TB / kCols;
  const int arow0 = (blockIdx.y / col_blocks) * kRows;
  const int bcol0 = (blockIdx.y % col_blocks) * kCols;
  const int64_t a_blk = (int64_t)ta[t] * TA + arow0;   // first anchor site
  const int64_t b_blk = (int64_t)tb[t] * TB + bcol0;   // first partner site
  const int64_t a = a_blk + ty, b = b_blk + tx;
  const int n_chunks = Ip / IC;

  // stage planes [p0, p1) of chunk c into buffer `buf`
  auto prefetch = [&](int c, int buf, int p0, int p1) {
    float* sA = smem + buf * buf_floats(IC);
    float* sB = sA + kPlanes * kRows * IC;
    const int64_t ic0 = (int64_t)c * IC;
    const int w = vec16 ? 4 : 1;          // floats per copy
    const int qa = IC / w, qb = kCols / w;
    const int na = (p1 - p0) * kRows * qa;
    for (int e = tid; e < na; e += kThreads) {
      const int j = e % qa, r = (e / qa) % kRows, p = p0 + e / (qa * kRows);
      const float* src = tabs.a[p] + (a_blk + r) * Ip + ic0 + w * j;
      float* dst = sA + (p * kRows + r) * IC + w * j;
      if (vec16) __pipeline_memcpy_async(dst, src, 16);
      else __pipeline_memcpy_async(dst, src, 4);
    }
    const int nb = (p1 - p0) * IC * qb;
    for (int e = tid; e < nb; e += kThreads) {
      const int j = e % qb, i = (e / qb) % IC, p = p0 + e / (qb * IC);
      const float* src = tabs.b[p] + (ic0 + i) * Sb + b_blk + w * j;
      float* dst = sB + (p * IC + i) * kCols + w * j;
      if (vec16) __pipeline_memcpy_async(dst, src, 16);
      else __pipeline_memcpy_async(dst, src, 4);
    }
    __pipeline_commit();
  };

  const double ma = maf_a[a], mb = maf_b[b];
  double f0 = (1.0 - ma) * (1.0 - mb), f1 = (1.0 - ma) * mb;
  double f2 = ma * (1.0 - mb), f3 = ma * mb;
  const bool live = b >= lo[a] && b < hi[a] && ok_a[a] > 0.0f &&
                    ok_b[b] > 0.0f;
  const int block_live = __syncthreads_or(live);

  // ---- pre-pass: r2p from the E[G] planes, n_used from the GL planes
  const int pre0 = kIgnoreMiss ? 0 : 3;
  int buf = 0;
  prefetch(0, 0, pre0, kPlanes);
  double corr = 0.0;
  int cnt = kIgnoreMiss ? 0 : I;
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(0);
    // the chunk has landed for every thread, and every thread is done with
    // the other buffer
    __syncthreads();
    if (c + 1 < n_chunks) prefetch(c + 1, buf ^ 1, pre0, kPlanes);
    else if (block_live && iter_cap > 0) prefetch(0, buf ^ 1, 0, 3);
    const float* sA = smem + buf * buf_floats(IC);
    const float* sB = sA + kPlanes * kRows * IC;
    const float* ea = sA + (3 * kRows + ty) * IC;
    const float* eb = sB + 3 * IC * kCols + tx;
    for (int i = 0; i < IC; ++i)
      corr += (double)ea[i] * (double)eb[i * kCols];
    if (kIgnoreMiss) {
      const int n_i = min(IC, I - c * IC);
      for (int i = 0; i < n_i; ++i) {
        const float* xa = sA + ty * IC + i;
        const float* yb = sB + i * kCols + tx;
        cnt += !(is_miss(xa[0], xa[kRows * IC], xa[2 * kRows * IC]) ||
                 is_miss(yb[0], yb[IC * kCols], yb[2 * IC * kCols]));
      }
    }
    buf ^= 1;
  }

  // ---- EM: every iteration streams the cohort again
  int n_iter = iter_cap;
  bool active = live;
  if (block_live) {
    const double inv_x = 1.0 / (double)cnt;
    for (int it = 0; it < iter_cap; ++it) {
      double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      for (int c = 0; c < n_chunks; ++c) {
        __pipeline_wait_prior(0);
        __syncthreads();
        const int cn = c + 1 < n_chunks ? c + 1 : 0;
        if (cn != 0 || it + 1 < iter_cap) prefetch(cn, buf ^ 1, 0, 3);
        if (active) {
          const float* xa = smem + buf * buf_floats(IC) + ty * IC;
          const float* yb = smem + buf * buf_floats(IC) +
                            kPlanes * kRows * IC + tx;
          const int n_i = min(IC, I - c * IC);
          for (int i = 0; i < n_i; ++i) {
            const double x0 = xa[i], x1 = xa[kRows * IC + i],
                         x2 = xa[2 * kRows * IC + i];
            const double y0 = yb[i * kCols], y1 = yb[(IC + i) * kCols],
                         y2 = yb[(2 * IC + i) * kCols];
            em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                                 a1, a2, a3);
          }
        }
        buf ^= 1;
      }
      if (active) {
        const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
        if (eps < kEpsilon) {
          n_iter = it;
          active = false;
        }
      }
      // uniform for the whole block: frozen cells wait here with the rest
      if (!__syncthreads_or(active)) break;
    }
  }
  // no copy may still be writing this block's shared memory when it leaves
  __pipeline_wait_prior(0);

  const int64_t cells = (int64_t)TA * TB;
  const int64_t cell = (int64_t)(arow0 + ty) * TB + bcol0 + tx;
  float* fo = f_out + (int64_t)t * 4 * cells + cell;
  fo[0] = (float)f0;
  fo[cells] = (float)f1;
  fo[2 * cells] = (float)f2;
  fo[3 * cells] = (float)f3;
  const int64_t oc = (int64_t)t * cells + cell;
  r2p_out[oc] = (float)(corr * corr);
  n_iter_out[oc] = n_iter;
  n_used_out[oc] = cnt;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch with chunk size i_chunk needs.
int ngsld_strip_em_stream_smem(int i_chunk) {
  return (int)(2 * buf_floats(i_chunk) * sizeof(float));
}

int ngsld_strip_em_stream(const void* ga, const void* gb, const void* ea,
                          const void* eb, const void* maf_a,
                          const void* maf_b, const void* lo, const void* hi,
                          const void* ok_a, const void* ok_b, const void* ta,
                          const void* tb, int n_tiles, int64_t Sa, int64_t Sb,
                          int Ip, int I, int i_chunk, int TA, int TB,
                          int iter_cap, int ignore_miss, void* f, void* r2p,
                          void* n_iter, void* n_used, void* stream) {
  if (n_tiles <= 0) return 0;
  if (TA % kRows || TB % kCols || i_chunk <= 0 || Ip % i_chunk)
    return (int)cudaErrorInvalidValue;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto N = [](const void* p) { return static_cast<const int32_t*>(p); };
  Tables tabs;
  for (int p = 0; p < 3; ++p) {
    tabs.a[p] = F(ga) + (int64_t)p * Sa * Ip;
    tabs.b[p] = F(gb) + (int64_t)p * Ip * Sb;
  }
  tabs.a[3] = F(ea);
  tabs.b[3] = F(eb);
  // 16-byte copies need every staged run on a 16-byte boundary
  int vec16 = i_chunk % 4 == 0 && Ip % 4 == 0 && Sb % 4 == 0;
  for (int p = 0; p < kPlanes; ++p)
    vec16 = vec16 && reinterpret_cast<uintptr_t>(tabs.a[p]) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(tabs.b[p]) % 16 == 0;
  const size_t smem = 2 * buf_floats(i_chunk) * sizeof(float);
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)n_tiles, (unsigned)((TA / kRows) * (TB / kCols)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ignore_miss) {
    err = cudaFuncSetAttribute(strip_em_stream_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    strip_em_stream_kernel<true><<<grid, block, smem, st>>>(
        tabs, F(maf_a), F(maf_b), N(lo), N(hi), F(ok_a), F(ok_b), N(ta),
        N(tb), Sb, Ip, I, i_chunk, vec16, TA, TB, iter_cap,
        static_cast<float*>(f), static_cast<float*>(r2p),
        static_cast<int32_t*>(n_iter), static_cast<int32_t*>(n_used));
  } else {
    err = cudaFuncSetAttribute(strip_em_stream_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    strip_em_stream_kernel<false><<<grid, block, smem, st>>>(
        tabs, F(maf_a), F(maf_b), N(lo), N(hi), F(ok_a), F(ok_b), N(ta),
        N(tb), Sb, Ip, I, i_chunk, vec16, TA, TB, iter_cap,
        static_cast<float*>(f), static_cast<float*>(r2p),
        static_cast<int32_t*>(n_iter), static_cast<int32_t*>(n_used));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
