"""Numeric constants shared across engines.

Values mirror the reference's compile-time constants
(ngsLD shared/gen_func.hpp:14-18) so that both the strict oracle
engine and the TPU engine reproduce the reference's output contract.
"""

N_GENO = 3          # genotypes {AA, Aa, aa}            (gen_func.hpp:14)
INF = 1e15          # reference's finite "infinity"     (gen_func.hpp:15)
EPSILON = 1e-5      # convergence / missing-data tol    (gen_func.hpp:16)
ITER_MAX = 100      # max EM iterations                 (gen_func.hpp:18)
