// Strip-tile two-locus EM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ngsld_tpu/kernels/pallas_strip.py::_strip_kernel:
// for a list of tiles (ta[t], tb[t]) it computes the rectangle of pairs
//   anchors [ta*TA, (ta+1)*TA) x partners [tb*TB, (tb+1)*TB)
// from contiguous slices of the strip tables, with no gathers. Inputs:
// ga (3, Sa, Ip) anchor GLs, site-major rows; gb (3, Ip, Sb) partner GLs,
// individual-major; ea (Sa, Ip) and eb (Ip, Sb) standardized E[G]; per-site
// maf, ok (> 0 = usable) for both axes, and per-anchor live-partner bounds
// [lo, hi) in partner-axis coordinates. Outputs, tile layout:
// f (n, 4, TA, TB) float, r2p (n, TA, TB) float, n_iter and n_used
// (n, TA, TB) int32. The caller guarantees that every tile lies inside the
// tables. The anchor and partner tables may cover different site ranges.
//
// Per cell (a, b):
//   * r2p = (sum_i ea[a, i] * eb[i, b])^2, accumulated in double here in
//     the kernel (never a TF32 product);
//   * n_used = individuals i < I, minus those whose record is uniform
//     within EPSILON at either site under ignore_miss;
//   * live iff lo[a] <= b < hi[a] and ok_a[a] > 0 and ok_b[b] > 0. A dead
//     cell keeps f0 = ((1-ma)(1-mb), (1-ma)mb, ma(1-mb), ma*mb) and
//     n_iter = iter_cap. A live cell runs the EM update of
//     ngsld_tpu/ops/em.py with IEEE division, the NaN-ignoring fold
//     `eps = d > eps ? d : eps` from 0, and stops at the first iteration
//     `it` with eps < EPSILON (n_iter = it), else at iter_cap. n_used = 0
//     makes 1/x inf, the update NaN, and the fold freezes the cell at
//     n_iter 0 with NaN f.
//
// Arithmetic: tables and outputs are float, the EM runs in double, as in
// pair_em.cu: a float EM decides the stop iteration on float-rounded
// frequencies and lands one iteration away from the double reference
// wherever eps falls within that rounding of EPSILON.
//
// What bounds it on this card: each (cell, individual, iteration) costs
// 40 double-precision flops, one of them an IEEE division (counted in
// em_core.cuh), against 24 bytes of float loads that almost always hit L1
// (below), so the loop is bound by double-precision arithmetic, not by
// device memory.
//
// Design: one thread per cell, its four frequencies and four sums in
// registers, so every pair freezes on its own and no cross-lane reduction
// exists. A warp is 32 consecutive partners of ONE anchor: the anchor's
// loads are a broadcast and the partners' loads (contiguous in b) one
// 128-byte line. A block is 8 anchors x 32 partners: its partner strip is
// 12 * I * 32 bytes (38 KB at I = 100) and is reused by its 8 warps and by
// every iteration out of L1. The individual loop reads global memory, so
// any cohort size runs. The TPU kernel's anchor groups, unroll and
// first-check schedule exist for its scalar convergence syncs and are not
// carried over. Build without --use_fast_math.

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

template <bool kIgnoreMiss>
__global__ void __launch_bounds__(kRows * kCols)
strip_em_kernel(const float* __restrict__ ga, const float* __restrict__ gb,
                const float* __restrict__ ea, const float* __restrict__ eb,
                const float* __restrict__ maf_a,
                const float* __restrict__ maf_b,
                const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                const float* __restrict__ ok_a, const float* __restrict__ ok_b,
                const int32_t* __restrict__ ta, const int32_t* __restrict__ tb,
                int64_t Sa, int64_t Sb, int Ip, int I, int TA, int TB,
                int iter_cap, float* __restrict__ f_out,
                float* __restrict__ r2p_out, int32_t* __restrict__ n_iter_out,
                int32_t* __restrict__ n_used_out) {
  const int t = blockIdx.x;
  const int col_blocks = TB / kCols;
  const int arow = (blockIdx.y / col_blocks) * kRows + threadIdx.y;
  const int bcol = (blockIdx.y % col_blocks) * kCols + threadIdx.x;
  const int64_t a = (int64_t)ta[t] * TA + arow;   // anchor site
  const int64_t b = (int64_t)tb[t] * TB + bcol;   // partner site

  // anchor rows: x_c[i] = ga[c][a][i]; partner columns: y_c[i] = gb[c][i][b]
  const float* __restrict__ xa0 = ga + a * Ip;
  const float* __restrict__ xa1 = xa0 + Sa * Ip;
  const float* __restrict__ xa2 = xa1 + Sa * Ip;
  const float* __restrict__ yb0 = gb + b;
  const float* __restrict__ yb1 = yb0 + (int64_t)Ip * Sb;
  const float* __restrict__ yb2 = yb1 + (int64_t)Ip * Sb;

  // Pearson r2 on the standardized tables (padded individuals hold 0) and
  // the inclusion count, one pass
  const float* __restrict__ ear = ea + a * Ip;
  const float* __restrict__ ebc = eb + b;
  double corr = 0.0;
  for (int i = 0; i < Ip; ++i)
    corr += (double)ear[i] * (double)ebc[(int64_t)i * Sb];
  int cnt = I;
  if (kIgnoreMiss) {
    cnt = 0;
    for (int i = 0; i < I; ++i) {
      const int64_t o = (int64_t)i * Sb;
      cnt += !(is_miss(xa0[i], xa1[i], xa2[i]) ||
               is_miss(yb0[o], yb1[o], yb2[o]));
    }
  }

  const double ma = maf_a[a], mb = maf_b[b];
  double f0 = (1.0 - ma) * (1.0 - mb), f1 = (1.0 - ma) * mb;
  double f2 = ma * (1.0 - mb), f3 = ma * mb;
  const bool live = b >= lo[a] && b < hi[a] && ok_a[a] > 0.0f &&
                    ok_b[b] > 0.0f;

  int n_iter = iter_cap;
  if (live) {
    const double inv_x = 1.0 / (double)cnt;
    for (int it = 0; it < iter_cap; ++it) {
      double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      for (int i = 0; i < I; ++i) {
        const int64_t o = (int64_t)i * Sb;
        const double x0 = xa0[i], x1 = xa1[i], x2 = xa2[i];
        const double y0 = yb0[o], y1 = yb1[o], y2 = yb2[o];
        em_term<kIgnoreMiss>(x0, x1, x2, y0, y1, y2, f0, f1, f2, f3, a0,
                             a1, a2, a3);
      }
      const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
      if (eps < kEpsilon) {
        n_iter = it;
        break;
      }
    }
  }

  const int64_t cells = (int64_t)TA * TB;
  const int64_t cell = (int64_t)arow * TB + bcol;
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

int ngsld_strip_em(const void* ga, const void* gb, const void* ea,
                   const void* eb, const void* maf_a, const void* maf_b,
                   const void* lo, const void* hi, const void* ok_a,
                   const void* ok_b, const void* ta, const void* tb,
                   int n_tiles, int64_t Sa, int64_t Sb, int Ip, int I, int TA,
                   int TB, int iter_cap, int ignore_miss, void* f, void* r2p,
                   void* n_iter, void* n_used, void* stream) {
  if (n_tiles <= 0) return 0;
  if (TA % kRows || TB % kCols) return (int)cudaErrorInvalidValue;
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)n_tiles, (unsigned)((TA / kRows) * (TB / kCols)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto N = [](const void* p) { return static_cast<const int32_t*>(p); };
  if (ignore_miss) {
    strip_em_kernel<true><<<grid, block, 0, st>>>(
        F(ga), F(gb), F(ea), F(eb), F(maf_a), F(maf_b), N(lo), N(hi), F(ok_a),
        F(ok_b), N(ta), N(tb), Sa, Sb, Ip, I, TA, TB, iter_cap,
        static_cast<float*>(f), static_cast<float*>(r2p),
        static_cast<int32_t*>(n_iter), static_cast<int32_t*>(n_used));
  } else {
    strip_em_kernel<false><<<grid, block, 0, st>>>(
        F(ga), F(gb), F(ea), F(eb), F(maf_a), F(maf_b), N(lo), N(hi), F(ok_a),
        F(ok_b), N(ta), N(tb), Sa, Sb, Ip, I, TA, TB, iter_cap,
        static_cast<float*>(f), static_cast<float*>(r2p),
        static_cast<int32_t*>(n_iter), static_cast<int32_t*>(n_used));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
