// Strip-tile two-locus EM with the individual axis streamed through shared
// memory, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel
// ngsld_tpu/kernels/pallas_strip.py::_strip_ichunk_kernel: the rectangle EM
// of strip_em.cu (same tables, same tile list, same four outputs, same
// per-cell semantics: see that file's header) for cohorts whose strips no
// longer stay on chip. A sub-tile's EM state stays resident while the
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
// n_iter = iter_cap and still given r2p and n_used. A lane adds its share
// of a cell's individuals in index order, chunk after chunk (all of them
// while every cell has one lane; see strip_core.cuh for the order when a
// cell has a group of lanes): n_iter and n_used equal strip_em.cu's and the
// plain version's, f agrees to its float rounding. Build without
// --use_fast_math.
//
// What bounds it on this card: 40 double-precision flops per (cell,
// individual, iteration) (counted in em_core.cuh) against 24 bytes of
// float GLs that a block stages once per chunk and iteration and reads
// from shared memory: operations, as long as most of a sub-tile's cells
// run; a sub-tile's last cells still stream the whole cohort every
// iteration, and that part is bound by the bytes a block re-reads. What
// kept a one-thread-a-cell kernel at an eighth of the bound was lanes
// waiting for their warp's slowest cell (and a block staging for all of
// them until its last cell stopped) and six float-to-double conversions a
// term.
//
// Design (the block body is strip_core.cuh, shared with strip_em.cu): a
// block of 512 threads owns a 16 x 32 sub-tile: twice the cells of the
// resident kernel's for 1.2 times the bytes streamed, and one block an SM
// leaves room for chunks of 64 individuals. After every round of
// round_iters iterations the cells still running are seated again over all
// 512 lanes, a power-of-two group of lanes a cell; at cohort sizes that
// stream, one iteration is long against a repack, so a round is one
// iteration. Per chunk, cp.async (16 bytes wide when the tables allow it,
// else 4) lands the floats of the chunk after the next, 3 planes x (16
// anchors + 32 partners) x IC, in a raw buffer while the block computes on
// one of two buffers of records; each thread widens the pieces it copied
// itself into the other buffer: 144 conversions a staged individual
// instead of 6 a term. One barrier a chunk. The stream is iteration-major:
// after an iteration's last chunk comes chunk 0 of the next. r2p and
// n_used are computed once by each cell's home thread straight from the
// tables. A block leaves when no cell runs, after waiting for its last
// copies; a block without a live cell stages nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strip_core.cuh"

namespace {

constexpr int kRows = 16;   // anchors of a block's sub-tile

template <bool kIgnoreMiss>
__global__ void __launch_bounds__(kRows * ngsld::kCols, 1)
strip_em_stream_kernel(ngsld::StripArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  ngsld::strip_block<kIgnoreMiss, true, kRows>(g, smem);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch with chunk size i_chunk needs.
int ngsld_strip_em_stream_smem(int i_chunk) {
  return (int)ngsld::strip_smem_bytes(kRows, i_chunk, true);
}

int ngsld_strip_em_stream(const void* ga, const void* gb, const void* ea,
                          const void* eb, const void* maf_a,
                          const void* maf_b, const void* lo, const void* hi,
                          const void* ok_a, const void* ok_b, const void* ta,
                          const void* tb, int n_tiles, int64_t Sa, int64_t Sb,
                          int Ip, int I, int i_chunk, int TA, int TB,
                          int iter_cap, int ignore_miss, int round_iters,
                          void* f, void* r2p, void* n_iter, void* n_used,
                          void* stream) {
  if (n_tiles <= 0) return 0;
  if (TA % kRows || TB % ngsld::kCols || i_chunk <= 0 || Ip % i_chunk ||
      round_iters < 1 || I < 1)
    return (int)cudaErrorInvalidValue;
  ngsld::StripArgs g = ngsld::strip_args(
      ga, gb, ea, eb, maf_a, maf_b, lo, hi, ok_a, ok_b, ta, tb, Sa, Sb, Ip, I,
      TA, TB, iter_cap, round_iters, f, r2p, n_iter, n_used);
  g.IC = i_chunk;
  // 16-byte copies need every staged run on a 16-byte boundary: the three
  // planes of a table lie Sa * Ip (Ip * Sb) floats apart
  g.vec16 = i_chunk % 4 == 0 && Ip % 4 == 0 && Sb % 4 == 0 &&
            reinterpret_cast<uintptr_t>(ga) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(gb) % 16 == 0;
  const size_t smem = (size_t)ngsld::strip_smem_bytes(kRows, i_chunk, true);
  return ignore_miss
             ? ngsld::strip_launch(strip_em_stream_kernel<true>, kRows, g,
                                   n_tiles, smem, stream)
             : ngsld::strip_launch(strip_em_stream_kernel<false>, kRows, g,
                                   n_tiles, smem, stream);
}

}  // extern "C"
