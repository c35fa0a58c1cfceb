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
// (n, TA, TB) int32; with the eps export (epsl and epsp not null; the TPU
// kernel's want_eps), each cell's last two update magnitudes, epsl and
// epsp (n, TA, TB) float (strip_core.cuh says when they change). The
// caller guarantees that every tile lies inside the tables. The anchor and
// partner tables may cover different site ranges.
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
// em_core.cuh), against operands that stay on the SM for the whole run:
// operations. What kept a one-thread-a-cell kernel at a tenth of that
// bound was lanes waiting for their warp's slowest cell and six
// float-to-double conversions a term.
//
// Design (the block body is strip_core.cuh, shared with
// strip_em_stream.cu): a block of 256 threads owns an 8 x 32 sub-tile. It
// stages its 8 anchor rows and 32 partner columns for the whole cohort
// once into shared memory, widened to double (968 bytes an individual, so
// the cohort is bounded by the shared memory a block may opt into:
// ngsld_strip_em_smem says how much a launch needs, and larger cohorts
// take strip_em_stream.cu). Its live cells then run in rounds of
// round_iters iterations; after a round the cells still running are
// seated again over all 256 lanes, a power-of-two group of lanes a cell
// that splits the cell's individuals, so lanes do not wait for a slowest
// cell beyond the round and the last cells of a sub-tile use the whole
// block. The inner loop is shared-memory loads and double-precision
// arithmetic only. The TPU kernel's anchor groups, unroll and first-check
// schedule exist for its scalar convergence syncs; its first_check is the
// analogue of round_iters. The eps export is a second instantiation of the
// kernel (kEps), with two more float planes of shared memory a block; the
// launch without it runs the first, whose code is the kernel's without
// the export. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strip_core.cuh"

namespace {

constexpr int kRows = 8;   // anchors of a block's sub-tile

template <bool kIgnoreMiss, bool kEps>
__global__ void __launch_bounds__(kRows * ngsld::kCols, 2)
strip_em_kernel(ngsld::StripArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  ngsld::strip_block<kIgnoreMiss, false, kRows, kEps>(g, smem);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch for n_ind individuals needs,
// with the eps export or without.
int ngsld_strip_em_smem(int n_ind, int want_eps) {
  return (int)ngsld::strip_smem_bytes(kRows, n_ind, false, want_eps != 0);
}

int ngsld_strip_em(const void* ga, const void* gb, const void* ea,
                   const void* eb, const void* maf_a, const void* maf_b,
                   const void* lo, const void* hi, const void* ok_a,
                   const void* ok_b, const void* ta, const void* tb,
                   int n_tiles, int64_t Sa, int64_t Sb, int Ip, int I, int TA,
                   int TB, int iter_cap, int ignore_miss, int round_iters,
                   void* f, void* r2p, void* n_iter, void* n_used,
                   void* epsl, void* epsp, void* stream) {
  if (n_tiles <= 0) return 0;
  const bool eps = epsl != nullptr;
  if (TA % kRows || TB % ngsld::kCols || round_iters < 1 || I < 1 ||
      eps != (epsp != nullptr))
    return (int)cudaErrorInvalidValue;
  const ngsld::StripArgs g = ngsld::strip_args(
      ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb, Sa, Sb, Ip, I,
      TA, TB, iter_cap, round_iters, f, r2p, n_iter, n_used, epsl, epsp);
  const size_t smem = (size_t)ngsld::strip_smem_bytes(kRows, I, false, eps);
  if (eps)
    return ignore_miss
               ? ngsld::strip_launch(strip_em_kernel<true, true>, kRows, g,
                                     n_tiles, smem, stream)
               : ngsld::strip_launch(strip_em_kernel<false, true>, kRows, g,
                                     n_tiles, smem, stream);
  return ignore_miss
             ? ngsld::strip_launch(strip_em_kernel<true, false>, kRows, g,
                                   n_tiles, smem, stream)
             : ngsld::strip_launch(strip_em_kernel<false, false>, kRows, g,
                                   n_tiles, smem, stream);
}

}  // extern "C"
