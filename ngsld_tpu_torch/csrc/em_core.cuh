// The two-locus EM's arithmetic, shared by every kernel of csrc/: one
// (pair, individual) term of the four sums, the warp reduction, and the
// update of the four haplotype frequencies from the sums
// (ngsld_tpu/ops/em.py:34-107, gen_func.cpp:1027-1119). All in double with
// IEEE division; build without --use_fast_math.
//
// One term costs 40 flops as written here: Q 12, D 12, s 7, the division
// 1, the four products and sums 8. (The TPU kernels count 44: their
// division is a Newton reciprocal of 5.)

#pragma once

#include <cuda_runtime.h>

namespace ngsld {

constexpr double kEpsilon = 1e-5;  // EPSILON (gen_func.hpp:16)

// miss_data (gen_func.cpp:862-868): a record uniform within EPSILON
__device__ __forceinline__ bool is_miss(double g0, double g1, double g2) {
  return fabs(g0 - g1) < kEpsilon && fabs(g1 - g2) < kEpsilon;
}

// Adds individual i's term to the four sums a_k = sum_i inc_i D_k[i] / s[i].
// x: the individual's three GLs at site 1, y: at site 2, f: the current
// frequencies.
template <bool kIgnoreMiss>
__device__ __forceinline__ void em_term(
    double x0, double x1, double x2, double y0, double y1, double y2,
    double f0, double f1, double f2, double f3, double& a0, double& a1,
    double& a2, double& a3) {
  // D_k = sum_{a,b} f[2a+b] x[a1k+a] y[a2k+b], through
  // Q[a][c] = f[2a] y[c] + f[2a+1] y[c+1]
  const double q00 = f0 * y0 + f1 * y1, q01 = f0 * y1 + f1 * y2;
  const double q10 = f2 * y0 + f3 * y1, q11 = f2 * y1 + f3 * y2;
  const double d0 = x0 * q00 + x1 * q10;
  const double d1 = x0 * q01 + x1 * q11;
  const double d2 = x1 * q00 + x2 * q10;
  const double d3 = x1 * q01 + x2 * q11;
  const double s = ((f0 * d0 + f1 * d1) + f2 * d2) + f3 * d3;
  double inc = 1.0;
  if (kIgnoreMiss) {
    inc = (is_miss(x0, x1, x2) || is_miss(y0, y1, y2)) ? 0.0 : 1.0;
  }
  // masked reciprocal: excluded individuals add 0 (or NaN at s = 0,
  // exactly as the plain version's include / s)
  const double r = inc / s;
  a0 += d0 * r;
  a1 += d1 * r;
  a2 += d2 * r;
  a3 += d3 * r;
}

// The sum of v over the warp's 32 lanes, in every lane (a butterfly: every
// lane adds the same pairs in the same order and holds the same bits).
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One EM update from the four sums: f_k <- f_k a_k / x, normalised. Returns
// the NaN-ignoring max |df_k| (`if (x > eps) eps = x` from 0, as the
// reference folds it): with x = 0, 1/x is inf, the update NaN and the
// returned 0 freezes the pair at once.
__device__ __forceinline__ double em_update(double& f0, double& f1,
                                            double& f2, double& f3, double a0,
                                            double a1, double a2, double a3,
                                            double inv_x) {
  double n0 = f0 * a0 * inv_x, n1 = f1 * a1 * inv_x;
  double n2 = f2 * a2 * inv_x, n3 = f3 * a3 * inv_x;
  const double norm = ((n0 + n1) + n2) + n3;
  n0 = n0 / norm;
  n1 = n1 / norm;
  n2 = n2 / norm;
  n3 = n3 / norm;
  double eps = 0, d;
  d = fabs(n0 - f0); eps = d > eps ? d : eps;
  d = fabs(n1 - f1); eps = d > eps ? d : eps;
  d = fabs(n2 - f2); eps = d > eps ? d : eps;
  d = fabs(n3 - f3); eps = d > eps ? d : eps;
  f0 = n0; f1 = n1; f2 = n2; f3 = n3;
  return eps;
}

}  // namespace ngsld
