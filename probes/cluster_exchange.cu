// Probe (not a kernel of the port): the cost of one iteration of the
// cluster body's exchange in pair_em_ichunk.cu, with no terms to add, on
// the card it runs on. Five loops, each timed over 2,000 iterations on as
// many clusters as the card holds at once:
//   cluster.sync             the cluster barrier alone
//   __syncthreads            the block barrier alone
//   exchange, cluster.sync   the cluster body's step: four warp sums, the
//                            block's sum by thread 0, the barrier, the C
//                            blocks' sums read over DSMEM, the update's
//                            four IEEE divisions
//   exchange, mbarrier push  the same, with thread 0 storing its sums into
//                            every block's shared memory and arriving on
//                            their mbarriers instead of the barrier
//   update divisions         the update's divisions alone
// for C = 1, 2, 5, 8 blocks a cluster, 64 / 256 / 512 threads and one or
// two blocks an SM. Build and run from the root of the repo on a machine
// with the card (the binary goes to probes/.build/, which git ignores):
//   mkdir -p probes/.build && nvcc -gencode arch=compute_90a,code=sm_90a \
//        -std=c++17 -O3 -o probes/.build/cluster_exchange \
//        probes/cluster_exchange.cu && probes/.build/cluster_exchange
// It is not part of the package; kernels/build.py does not build it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ uint32_t su32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// the address of the same shared variable in block `r` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t r) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(o) : "r"(a), "r"(r));
  return o;
}
__device__ __forceinline__ void st_remote(uint32_t a, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(a), "d"(v)
               : "memory");
}
__device__ __forceinline__ void arrive_remote(uint32_t a) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(a)
      : "memory");
}
__device__ __forceinline__ bool try_wait(uint32_t a, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
      ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
      : "=r"(ok) : "r"(a), "r"(parity) : "memory");
  return ok;
}

// mode 0: cluster.sync; 1: __syncthreads; 2: the exchange with
// cluster.sync; 3: the exchange with mbarrier pushes; 4: the update's
// divisions
__global__ void probe(int mode, int iters, double* out) {
  __shared__ double red[4][32];
  __shared__ double sums[2][4];
  __shared__ double recv[2][8][4];
  __shared__ __align__(8) uint64_t mbar[2];
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), rank = cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  double f0 = 0.25 + tid * 1e-9, f1 = 0.25, f2 = 0.25, f3 = 0.25;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       su32(&mbar[s])),
                   "r"(C));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  for (int it = 0; it < iters; ++it) {
    double a0 = f0, a1 = f1, a2 = f2, a3 = f3;
    if (mode == 0) {
      cl.sync();
      continue;
    }
    if (mode == 1) {
      __syncthreads();
      continue;
    }
    if (mode == 4) {
      const double n = a0 + a1 + a2 + a3;
      f0 = a0 / n;
      f1 = a1 / n;
      f2 = a2 / n;
      f3 = a3 / n;
      continue;
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
    double b0 = 0, b1 = 0, b2 = 0, b3 = 0;
    if (tid == 0) {
      for (int w = 0; w < nw; ++w) {
        b0 += red[0][w];
        b1 += red[1][w];
        b2 += red[2][w];
        b3 += red[3][w];
      }
    }
    if (mode == 2) {
      if (tid == 0) {
        sums[slot][0] = b0;
        sums[slot][1] = b1;
        sums[slot][2] = b2;
        sums[slot][3] = b3;
      }
      cl.sync();
      a0 = a1 = a2 = a3 = 0;
      for (int r = 0; r < C; ++r) {
        const double* o = cl.map_shared_rank(&sums[slot][0], r);
        a0 += o[0];
        a1 += o[1];
        a2 += o[2];
        a3 += o[3];
      }
    } else {
      if (tid == 0) {
        for (int r = 0; r < C; ++r) {
          const uint32_t base = mapa(su32(&recv[slot][rank][0]), r);
          st_remote(base, b0);
          st_remote(base + 8, b1);
          st_remote(base + 16, b2);
          st_remote(base + 24, b3);
          arrive_remote(mapa(su32(&mbar[slot]), r));
        }
      }
      // a bounded spin, so that a fault cannot hold the card
      const uint32_t mb = su32(&mbar[slot]), parity = (it >> 1) & 1;
      for (int k = 0; !try_wait(mb, parity) && k < (1 << 22); ++k) {
      }
      a0 = a1 = a2 = a3 = 0;
      for (int r = 0; r < C; ++r) {
        a0 += recv[slot][r][0];
        a1 += recv[slot][r][1];
        a2 += recv[slot][r][2];
        a3 += recv[slot][r][3];
      }
    }
    const double n = a0 + a1 + a2 + a3;
    f0 = a0 / n;
    f1 = a1 / n;
    f2 = a2 / n;
    f3 = a3 / n;
  }
  cl.sync();
  if (tid == 0) out[blockIdx.x] = f0 + f1 + f2 + f3;
}

int main() {
  setvbuf(stdout, NULL, _IONBF, 0);
  double* out;
  cudaMalloc(&out, 1 << 20);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 2000;
  const char* names[] = {"cluster.sync", "__syncthreads",
                         "exchange, cluster.sync", "exchange, mbarrier push",
                         "update divisions"};
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200000);
  for (int mode = 0; mode < 5; ++mode) {
    for (int C : {1, 2, 5, 8}) {
      for (int threads : {64, 256, 512}) {
        for (int per_sm : {1, 2}) {
          cudaLaunchAttribute attr[1];
          attr[0].id = cudaLaunchAttributeClusterDimension;
          attr[0].val.clusterDim.x = C;
          attr[0].val.clusterDim.y = 1;
          attr[0].val.clusterDim.z = 1;
          cudaLaunchConfig_t cfg = {};
          cfg.gridDim = dim3(C, 1, 1);
          cfg.blockDim = dim3(threads);
          cfg.attrs = attr;
          cfg.numAttrs = 1;
          // dynamic shared memory only to hold one or two blocks an SM
          cfg.dynamicSmemBytes = per_sm == 1 ? 200000 : 100000;
          int n_cl = 0;
          cudaOccupancyMaxActiveClusters(&n_cl, (void*)probe, &cfg);
          cfg.gridDim = dim3(C * n_cl, 1, 1);
          cudaLaunchKernelEx(&cfg, probe, mode, 10, out);
          cudaEventRecord(e0);
          cudaLaunchKernelEx(&cfg, probe, mode, iters, out);
          cudaEventRecord(e1);
          const cudaError_t err = cudaEventSynchronize(e1);
          float ms = 0;
          cudaEventElapsedTime(&ms, e0, e1);
          printf("%-26s C=%d threads=%3d blocks/SM=%d clusters=%4d: %.3f us "
                 "an iteration (%s)\n",
                 names[mode], C, threads, per_sm, n_cl, ms * 1e3 / iters,
                 cudaGetErrorString(err));
        }
      }
    }
  }
  return 0;
}
