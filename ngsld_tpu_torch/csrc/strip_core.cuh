// The block body of the two strip-tile EM kernels (strip_em.cu,
// strip_em_stream.cu): what a tile's cells compute is stated in
// strip_em.cu's header; this file is how one block computes a sub-tile of
// R anchors x 32 partners (R = 8 resident, 16 streamed) with 32 R threads
// on a Hopper SM.
//
// What bounds the work on this card: 40 double-precision flops for every
// (cell, individual, iteration), one of them an IEEE division, against 48
// bytes of operands. Cells of one sub-tile stop anywhere between 1 and
// iter_cap iterations (mean 19, 99th percentile 68 at 100 individuals), so
// with one thread fixed to one cell most lanes of a warp wait for its
// slowest cell (and most warps of a block for its slowest warp), and
// widening six floats for every term keeps the conversion pipe about as
// busy as the term's arithmetic keeps the double-precision pipe.
//
// Design:
//   * Repacked lanes. A thread is a seat, not a cell. Dead cells never
//     enter. The block advances in rounds of round_iters iterations; a cell
//     decides its stop after every iteration (n_iter is exact) and writes
//     its outputs the moment it stops. After a round in which a cell
//     stopped, the block counts its running cells (__ballot_sync + __popc
//     in a warp, a prefix over the warps' counts in shared memory) and
//     seats them again over all its lanes, in stable order: with n cells
//     left, each gets a group of G lanes, G the largest power of two (at
//     most 32) with n G <= threads. Cell ids move through a list, the four
//     frequencies through a plane indexed by cell. Lane q of a group adds
//     the individuals q, q + G, ... in order, a butterfly over the group
//     adds the G partial sums, and every lane of the group makes the same
//     update. So while at least 8 (16) cells run, every warp has work, and
//     a sub-tile's last cells finish G times sooner.
//   * Strips in shared memory as doubles, widened once. An individual's
//     record is [plane][anchor row] then [plane][partner column], and one
//     double of padding: 3 (R + 32) + 1 doubles. Any lane reads its six
//     operands with shared-memory loads only, no conversion and no global
//     address in the inner loop; the odd record length keeps lanes that
//     read consecutive individuals on distinct banks.
//   * One body. The resident kernel stages the whole cohort once (plain
//     loads, widen, store) and runs a round without a block barrier; the
//     streamed kernel passes the cohort through a chunk of IC individuals
//     in every iteration: cp.async lands the floats of the chunk after the
//     next in a raw buffer while the block computes on one buffer of
//     records; each thread then widens the pieces it copied itself into
//     the other buffer (so it waits for its own copies only) and starts
//     its next copies: one barrier a chunk. The stream is
//     iteration-major: after an iteration's last chunk comes chunk 0.
// With G = 1 a cell's sums are added by one thread in individual order,
// as the plain versions add them; with G > 1 the order is the group's, so
// f may differ from a one-thread sum in its last bits (the contract: n_iter
// and n_used exact, f within 1e-6 after rounding to float). The order
// depends only on the sub-tile's cells and round_iters, not on the kernel:
// with equal round_iters and equal R the two kernels agree bit for bit.
//
// The eps export (kEps, resident kernel only; the TPU kernel's want_eps,
// pallas_strip.py:79): each cell's last two update magnitudes, epsl and
// epsp (n, TA, TB) float, start at 1, change only while the cell runs (the
// iteration at which it stops writes them) and move with the cell at a
// repack in two float planes of shared memory; dead cells keep 1. The
// stop decision stays on the double eps, so f, r2p, n_iter and n_used are
// those of the kernel without the export. Build without --use_fast_math.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "em_core.cuh"

namespace ngsld {

constexpr int kCols = 32;     // partners of a block's sub-tile: the home
                              // cell of thread t is (t / 32, t % 32)
constexpr int kUnroll = 4;    // terms of the inner loops unrolled a trip

// doubles of one individual's record for a sub-tile of `rows` anchors
__host__ __device__ constexpr int strip_rec(int rows) {
  return 3 * (rows + kCols) + 1;
}

// floats of the streamed kernel's raw buffer: anchors (plane, row, i), then
// partners (plane, i, col)
__host__ __device__ constexpr int64_t strip_raw_floats(int rows, int ic) {
  return (int64_t)3 * ic * (rows + kCols);
}

// Dynamic shared memory of a block, bytes: the frequency plane, the staged
// records (streamed: two buffers of a chunk, and the raw floats of a
// third), the cells' n_used, the work list, the warps' counts (two sets,
// used in turn), the warps' masks of rows and columns in use (streamed)
// and the two eps planes (eps).
__host__ __device__ constexpr int64_t strip_smem_bytes(int rows, int ic,
                                                       bool streamed,
                                                       bool eps = false) {
  return (int64_t)4 * rows * kCols * 8 +
         (int64_t)(streamed ? 2 : 1) * ic * strip_rec(rows) * 8 +
         (streamed ? strip_raw_floats(rows, ic) * 4 : 0) + rows * kCols * 4 +
         rows * kCols * 2 + (streamed ? 3 : 2) * rows * 4 +
         (eps ? 2 * rows * kCols * 4 : 0);
}

struct StripArgs {
  const float *ga, *gb, *ea, *eb, *maf_a, *maf_b;
  const int32_t *lo, *hi;
  const float *ok_a, *ok_b;
  const int32_t *ta, *tb;
  int64_t Sa, Sb;
  int Ip, I;
  int IC;            // individuals a records buffer holds (resident: I)
  int vec16;         // streamed: 16-byte cp.async copies are aligned
  int TA, TB, iter_cap, round_iters;
  float *f, *r2p;
  int32_t *n_iter, *n_used;
  float *epsl, *epsp;   // the eps export's outputs (kEps)
};

template <bool kIgnoreMiss, bool kStreamed, int kRows, bool kEps = false>
__device__ __forceinline__ void strip_block(const StripArgs& g,
                                            unsigned char* smem) {
  static_assert(!(kEps && kStreamed), "the eps export: resident body only");
  constexpr int kCells = kRows * kCols;
  constexpr int kThreads = kCells;          // one seat a cell
  constexpr int kWarps = kThreads / 32;     // = kRows
  constexpr int kRec = strip_rec(kRows);
  static_assert(kCols == 32 && kRows <= 16, "home cells, ids and masks");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int IC = g.IC;
  double* sF = reinterpret_cast<double*>(smem);  // [4][kCells]
  double* sD = sF + 4 * kCells;                  // [IC][kRec], streamed x 2
  float* sRaw =
      reinterpret_cast<float*>(sD + (int64_t)(kStreamed ? 2 : 1) * IC * kRec);
  int32_t* sCnt = reinterpret_cast<int32_t*>(
      sRaw + (kStreamed ? strip_raw_floats(kRows, IC) : 0));   // [kCells]
  uint16_t* sList = reinterpret_cast<uint16_t*>(sCnt + kCells);
  int32_t* sWc = reinterpret_cast<int32_t*>(sList + kCells);  // [2][kWarps]
  uint32_t* sWm = reinterpret_cast<uint32_t*>(sWc + 2 * kWarps);  // [kWarps]
  float* sE = reinterpret_cast<float*>(sWc + (kStreamed ? 3 : 2) * kWarps);
                                                 // kEps: [2][kCells]

  const int t = blockIdx.x;
  const int col_blocks = g.TB / kCols;
  const int arow0 = (blockIdx.y / col_blocks) * kRows;
  const int bcol0 = (blockIdx.y % col_blocks) * kCols;
  const int64_t a_blk = (int64_t)g.ta[t] * g.TA + arow0;  // first anchor site
  const int64_t b_blk = (int64_t)g.tb[t] * g.TB + bcol0;  // first partner
  const int64_t cells = (int64_t)g.TA * g.TB;
  float* f_tile = g.f + (int64_t)t * 4 * cells;
  int32_t* it_tile = g.n_iter + (int64_t)t * cells;

  // a stopped cell's frequencies and stop iteration, to its place in the
  // tile
  auto write_out = [&](int cell, double f0, double f1, double f2, double f3,
                       int n_iter) {
    const int64_t o =
        (int64_t)(arow0 + cell / kCols) * g.TB + bcol0 + cell % kCols;
    f_tile[o] = (float)f0;
    f_tile[cells + o] = (float)f1;
    f_tile[2 * cells + o] = (float)f2;
    f_tile[3 * cells + o] = (float)f3;
    it_tile[o] = n_iter;
  };
  // kEps: a stopped cell's last two eps, to its place in the tile
  auto write_eps = [&](int cell, float e_last, float e_prev) {
    const int64_t o = (int64_t)t * cells +
                      (int64_t)(arow0 + cell / kCols) * g.TB + bcol0 +
                      cell % kCols;
    g.epsl[o] = e_last;
    g.epsp[o] = e_prev;
  };

  // ---- every cell, by its home thread (row = warp, col = lane): r2p on
  // the standardized tables (padded individuals hold 0), the inclusion
  // count, the init, and whether it runs at all
  const int64_t a = a_blk + warp, b = b_blk + lane;
  double corr = 0.0;
  {
    const float* __restrict__ ear = g.ea + a * g.Ip;
    const float* __restrict__ ebc = g.eb + b;
    for (int i = 0; i < g.Ip; ++i)
      corr += (double)ear[i] * (double)ebc[(int64_t)i * g.Sb];
  }
  int cnt = g.I;
  if (kIgnoreMiss) {
    const float* __restrict__ xa0 = g.ga + a * g.Ip;
    const float* __restrict__ xa1 = xa0 + g.Sa * g.Ip;
    const float* __restrict__ xa2 = xa1 + g.Sa * g.Ip;
    const float* __restrict__ yb0 = g.gb + b;
    const float* __restrict__ yb1 = yb0 + (int64_t)g.Ip * g.Sb;
    const float* __restrict__ yb2 = yb1 + (int64_t)g.Ip * g.Sb;
    cnt = 0;
    for (int i = 0; i < g.I; ++i) {
      const int64_t o = (int64_t)i * g.Sb;
      cnt += !(is_miss(xa0[i], xa1[i], xa2[i]) ||
               is_miss(yb0[o], yb1[o], yb2[o]));
    }
  }
  {
    const int64_t oc = (int64_t)t * cells + (int64_t)(arow0 + warp) * g.TB +
                       bcol0 + lane;
    g.r2p[oc] = (float)(corr * corr);
    g.n_used[oc] = cnt;
  }
  sCnt[tid] = cnt;
  const double ma = g.maf_a[a], mb = g.maf_b[b];
  double f0 = (1.0 - ma) * (1.0 - mb), f1 = (1.0 - ma) * mb;
  double f2 = ma * (1.0 - mb), f3 = ma * mb;
  const bool live = b >= g.lo[a] && b < g.hi[a] && g.ok_a[a] > 0.0f &&
                    g.ok_b[b] > 0.0f;
  int cell = tid;
  bool running = live && g.iter_cap > 0;
  float e_last = 1.0f, e_prev = 1.0f;   // kEps: the cell's last two eps
  // a dead cell keeps the init and n_iter = iter_cap (and eps 1)
  if (!running) {
    write_out(cell, f0, f1, f2, f3, g.iter_cap);
    if (kEps) write_eps(cell, e_last, e_prev);
  }
  double inv_x = 1.0 / (double)cnt;

  // ---- staging
  const int n_chunks = (g.I + IC - 1) / IC;
  float* rawA = sRaw;
  float* rawB = sRaw + 3 * kRows * IC;
  // streamed: the thread's own pieces of chunk c. copy: start their
  // cp.async into the raw buffer; else widen them from there into the
  // records at dst. A thread widens what it copied itself, so it waits for
  // its own copies only and may reuse its raw slots at once. Anchors: warp
  // w takes row w of each plane, its lanes the individuals; partners: a
  // warp takes an individual's 32 columns. Rows and groups of 4 columns
  // that no running cell reads (in_use, from the last repack) are left
  // out: a sub-tile's last cells stream little more than their own sites.
  uint32_t in_use = 0xffffffffu;   // bit r: anchor row r; bit 16 + k:
                                   // partner columns 4k .. 4k + 3
  auto own_pieces = [&](int c, bool copy, double* dst) {
    const int64_t ic0 = (int64_t)c * IC;
    const bool row_used = in_use >> warp & 1u;
    if (g.vec16) {   // pieces of 4 floats
      const int c4 = 4 * (tid & 7);
      const bool cols_used = in_use >> (16 + (tid & 7)) & 1u;
      for (int p = 0; p < 3; ++p) {
        const float* src_a =
            g.ga + ((int64_t)p * g.Sa + a_blk + warp) * g.Ip + ic0;
        for (int j = 4 * lane; row_used && j < IC; j += 128) {
          float* raw = rawA + (p * kRows + warp) * IC + j;
          if (copy) {
            __pipeline_memcpy_async(raw, src_a + j, 16);
          } else {
            const float4 v = *reinterpret_cast<const float4*>(raw);
            double* d = dst + j * kRec + p * kRows + warp;
            d[0] = v.x; d[kRec] = v.y; d[2 * kRec] = v.z; d[3 * kRec] = v.w;
          }
        }
        for (int i = tid >> 3; cols_used && i < IC; i += kThreads / 8) {
          float* raw = rawB + (p * IC + i) * kCols + c4;
          if (copy) {
            __pipeline_memcpy_async(
                raw, g.gb + ((int64_t)p * g.Ip + ic0 + i) * g.Sb + b_blk + c4,
                16);
          } else {
            const float4 v = *reinterpret_cast<const float4*>(raw);
            double* d = dst + i * kRec + 3 * kRows + p * kCols + c4;
            d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
          }
        }
      }
    } else {         // single floats
      const bool cols_used = in_use >> (16 + lane / 4) & 1u;
      for (int p = 0; p < 3; ++p) {
        const float* src_a =
            g.ga + ((int64_t)p * g.Sa + a_blk + warp) * g.Ip + ic0;
        for (int j = lane; row_used && j < IC; j += 32) {
          float* raw = rawA + (p * kRows + warp) * IC + j;
          if (copy) __pipeline_memcpy_async(raw, src_a + j, 4);
          else dst[j * kRec + p * kRows + warp] = (double)*raw;
        }
        for (int i = warp; cols_used && i < IC; i += kWarps) {
          float* raw = rawB + (p * IC + i) * kCols + lane;
          if (copy)
            __pipeline_memcpy_async(
                raw, g.gb + ((int64_t)p * g.Ip + ic0 + i) * g.Sb + b_blk + lane,
                4);
          else
            dst[i * kRec + 3 * kRows + p * kCols + lane] = (double)*raw;
        }
      }
    }
    if (copy) __pipeline_commit();
  };
  // streamed: the records of the current chunk are in buffer `buf`, the
  // floats of the chunk after it on their way into the raw buffer. The
  // chunks come round for ever: after an iteration's last chunk, chunk 0.
  int buf = 0;
  auto next_of = [&](int c) { return c + 1 < n_chunks ? c + 1 : 0; };
  auto stream_start = [&]() {
    own_pieces(0, true, nullptr);
    __pipeline_wait_prior(0);
    own_pieces(0, false, sD);
    own_pieces(next_of(0), true, nullptr);
    __syncthreads();
  };
  // done with chunk c: widen the chunk after it into the other buffer,
  // start the copies of the one after that, and publish. One barrier: it
  // both completes the new records and retires the old ones.
  auto stream_advance = [&](int c) {
    __pipeline_wait_prior(0);
    own_pieces(next_of(c), false, sD + (int64_t)(buf ^ 1) * IC * kRec);
    own_pieces(next_of(next_of(c)), true, nullptr);
    __syncthreads();
    buf ^= 1;
  };
  // resident: the whole cohort from the tables, widened, into the records
  auto stage_all = [&]() {
    for (int p = 0; p < 3; ++p) {
      const float* src_a = g.ga + ((int64_t)p * g.Sa + a_blk + warp) * g.Ip;
      for (int i = lane; i < g.I; i += 32)
        sD[i * kRec + p * kRows + warp] = (double)src_a[i];
      for (int i = warp; i < g.I; i += kWarps)
        sD[i * kRec + 3 * kRows + p * kCols + lane] =
            (double)g.gb[((int64_t)p * g.Ip + i) * g.Sb + b_blk + lane];
    }
  };

  // ---- rounds
  int G = 1, q = 0;        // lanes of this seat's group, this lane's place
  int last_run = -1;       // running cells when the block last repacked
  bool staged = false;
  int par = 0;
  for (int it0 = 0;; it0 += g.round_iters) {
    // count the running cells (lane 0 of a group votes for its cell); leave
    // when none is left
    const unsigned ballot = __ballot_sync(0xffffffffu, running && q == 0);
    if (lane == 0) sWc[par * kWarps + warp] = __popc(ballot);
    __syncthreads();
    int off = 0, n_run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = sWc[par * kWarps + w];
      off += w < warp ? c : 0;
      n_run += c;
    }
    par ^= 1;
    if (n_run == 0) break;
    if (n_run != last_run) {
      // ---- repack: the running cells, in stable order, over all the
      // lanes again, G lanes a cell
      if (running && q == 0) {
        sList[off + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)cell;
        sF[cell] = f0;
        sF[kCells + cell] = f1;
        sF[2 * kCells + cell] = f2;
        sF[3 * kCells + cell] = f3;
        if (kEps) {
          sE[cell] = e_last;
          sE[kCells + cell] = e_prev;
        }
      }
      if (kStreamed) {   // the rows and column groups still read
        const uint32_t mine =
            running ? 1u << (cell / kCols) | 1u << (16 + cell % kCols / 4)
                    : 0u;
        const uint32_t warps = __reduce_or_sync(0xffffffffu, mine);
        if (lane == 0) sWm[warp] = warps;
      }
      __syncthreads();
      if (kStreamed) {
        in_use = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) in_use |= sWm[w];
      }
      G = 32;
      while (G > 1 && n_run * G > kThreads) G >>= 1;
      q = lane % G;
      const int j = warp * (32 / G) + lane / G;
      running = j < n_run;
      if (running) {
        cell = sList[j];
        f0 = sF[cell];
        f1 = sF[kCells + cell];
        f2 = sF[2 * kCells + cell];
        f3 = sF[3 * kCells + cell];
        if (kEps) {
          e_last = sE[cell];
          e_prev = sE[kCells + cell];
        }
        inv_x = 1.0 / (double)sCnt[cell];
      }
      last_run = n_run;
    }
    if (!staged) {   // only a block with a running cell stages anything
      if (kStreamed) {
        stream_start();
      } else {
        stage_all();
        __syncthreads();
      }
      staged = true;
    }

    // one EM iteration of this lane's cell from the partial sums of its
    // group: the butterfly over the group's lanes (every lane of the warp
    // takes part: G is the block's), the update, the stop
    auto finish_iteration = [&](double a0, double a1, double a2, double a3,
                                int it) {
      for (int o = G >> 1; o > 0; o >>= 1) {
        a0 += __shfl_xor_sync(0xffffffffu, a0, o);
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
        a2 += __shfl_xor_sync(0xffffffffu, a2, o);
        a3 += __shfl_xor_sync(0xffffffffu, a3, o);
      }
      if constexpr (kEps) {
        if (running) {
          const double eps = em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x);
          e_prev = e_last;
          e_last = (float)eps;
          if (eps < kEpsilon) {
            if (q == 0) {
              write_out(cell, f0, f1, f2, f3, it);
              write_eps(cell, e_last, e_prev);
            }
            running = false;
          }
        }
      } else {
        if (running &&
            em_update(f0, f1, f2, f3, a0, a1, a2, a3, inv_x) < kEpsilon) {
          if (q == 0) write_out(cell, f0, f1, f2, f3, it);
          running = false;
        }
      }
    };

    if (!kStreamed) {
      // no barrier inside a round: a warp runs on its own
      for (int k = 0; k < g.round_iters; ++k) {
        const int it = it0 + k;
        if (it >= g.iter_cap || !__any_sync(0xffffffffu, running)) break;
        double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        if (running) {
          const double* x = sD + cell / kCols;
          const double* y = sD + 3 * kRows + cell % kCols;
#pragma unroll kUnroll
          for (int i = q; i < g.I; i += G)
            em_term<kIgnoreMiss>(x[i * kRec], x[i * kRec + kRows],
                                 x[i * kRec + 2 * kRows], y[i * kRec],
                                 y[i * kRec + kCols], y[i * kRec + 2 * kCols],
                                 f0, f1, f2, f3, a0, a1, a2, a3);
        }
        finish_iteration(a0, a1, a2, a3, it);
      }
    } else {
      // every iteration streams the cohort again; all threads stage and
      // keep every barrier, the lanes that run a cell add its terms
      for (int k = 0; k < g.round_iters; ++k) {
        const int it = it0 + k;
        if (it >= g.iter_cap) break;
        if (k > 0 && !__syncthreads_or(running)) break;
        double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        for (int c = 0; c < n_chunks; ++c) {
          if (running) {
            const double* x = sD + (int64_t)buf * IC * kRec + cell / kCols;
            const double* y = x - cell / kCols + 3 * kRows + cell % kCols;
            const int n_i = min(IC, g.I - c * IC);
            // lane q adds the individuals q, q + G, ... of the cohort
            const int first = (q + G - (c * IC) % G) % G;
#pragma unroll kUnroll
            for (int i = first; i < n_i; i += G)
              em_term<kIgnoreMiss>(x[i * kRec], x[i * kRec + kRows],
                                   x[i * kRec + 2 * kRows], y[i * kRec],
                                   y[i * kRec + kCols],
                                   y[i * kRec + 2 * kCols], f0, f1, f2, f3,
                                   a0, a1, a2, a3);
          }
          stream_advance(c);
        }
        finish_iteration(a0, a1, a2, a3, it);
      }
    }
    // a cell that reaches the cap stops there
    if (running && it0 + g.round_iters >= g.iter_cap) {
      if (q == 0) {
        write_out(cell, f0, f1, f2, f3, g.iter_cap);
        if (kEps) write_eps(cell, e_last, e_prev);
      }
      running = false;
    }
  }
  // no copy may still be writing this block's shared memory when it leaves
  if (kStreamed) __pipeline_wait_prior(0);
}

// The arguments every entry point takes, into the kernel's argument block.
inline StripArgs strip_args(const void* ga, const void* gb, const void* ea,
                            const void* eb, const void* maf_a,
                            const void* maf_b, const void* lo, const void* hi,
                            const void* ok_a, const void* ok_b, const void* ta,
                            const void* tb, int64_t Sa, int64_t Sb, int Ip,
                            int I, int TA, int TB, int iter_cap,
                            int round_iters, void* f, void* r2p, void* n_iter,
                            void* n_used, void* epsl = nullptr,
                            void* epsp = nullptr) {
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto N = [](const void* p) { return static_cast<const int32_t*>(p); };
  StripArgs g;
  g.ga = F(ga); g.gb = F(gb); g.ea = F(ea); g.eb = F(eb);
  g.maf_a = F(maf_a); g.maf_b = F(maf_b);
  g.lo = N(lo); g.hi = N(hi);
  g.ok_a = F(ok_a); g.ok_b = F(ok_b);
  g.ta = N(ta); g.tb = N(tb);
  g.Sa = Sa; g.Sb = Sb; g.Ip = Ip; g.I = I;
  g.IC = I; g.vec16 = 0;
  g.TA = TA; g.TB = TB; g.iter_cap = iter_cap; g.round_iters = round_iters;
  g.f = static_cast<float*>(f); g.r2p = static_cast<float*>(r2p);
  g.n_iter = static_cast<int32_t*>(n_iter);
  g.n_used = static_cast<int32_t*>(n_used);
  g.epsl = static_cast<float*>(epsl);
  g.epsp = static_cast<float*>(epsp);
  return g;
}

// Launch `kernel` (sub-tiles of `rows` anchors, 32 rows threads a block)
// over n_tiles tiles with `smem` bytes of dynamic shared memory (opted in);
// returns the cudaError of the launch.
template <typename Kernel>
inline int strip_launch(Kernel kernel, int rows, const StripArgs& g,
                        int n_tiles, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_tiles,
                  (unsigned)((g.TA / rows) * (g.TB / kCols)));
  kernel<<<grid, rows * kCols, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace ngsld
