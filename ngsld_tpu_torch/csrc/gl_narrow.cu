// Narrowing and checking of the binary GL loader's slabs, for Hopper
// (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package narrows each slab of the binary
// GENO file to float32 and checks it on the host, with numpy
// (ngsld_tpu/loaders.py::_StreamedGLLoader._read). On the card that host
// pass was the pace of a cohort's job: four numpy scans and a copy into
// pinned memory behind every read. Here the loader's reader thread only
// reads, the raw doubles cross to the device, and this kernel does the
// rest in one pass over the slab on the consumer's stream.
//
// Contract, per record of 3 doubles:
//  - the f32 instance writes the record in float32 with __double2float_rn:
//    round to nearest even, as numpy's astype(np.float32) on the host;
//    subnormals kept (built without -ftz and --use_fast_math), finite
//    values past FLT_MAX to +-inf, a NaN to a NaN (the card's canonical
//    one; such a record is refused below in any case);
//  - *flag |= 1 when the NARROWED record holds a NaN or a +inf, or in log
//    scale is three -infs, or in linear scale holds a negative: the
//    records the reference's post_prob turns into a NaN, whose error it
//    raises (read_data.cpp:42-45). Linear zeros and a single -inf are
//    fine. The loader raises "NaN found!" once it reads the flag;
//  - the f64 instance (--precision f64 tables) checks the records as
//    they are and writes nothing but the flag.
//
// Bound: bytes. A record is 24 bytes read and 12 written (24 and 0 for
// the check), with a few comparisons: a 256 MB slab of doubles is 0.12 ms
// at 3.35 TB/s.
//
// Design: a grid-stride loop of two records a thread a trip, no shared
// memory. Two records are 48 bytes, three 16-byte loads (a pair p starts
// at byte 48 p); their floats are 24 bytes at byte 24 p, 16-byte aligned
// for an even p, so an even pair stores 4 then 2 floats and an odd pair 2
// then 4: one 16-byte and one 8-byte store. An odd last record is thread
// 0's of block 0. A thread ORs its verdicts in a register; at the end a
// warp votes, and only a warp that saw a bad record issues one atomicOr.
// The grid is 8 blocks of 256 threads an SM (a full SM), fewer for a
// small slab. Inputs and outputs must be 16-byte aligned (the wrapper's
// tensors are).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename T>
__device__ __forceinline__ T inf();
template <>
__device__ __forceinline__ float inf<float>() {
  return __int_as_float(0x7f800000);
}
template <>
__device__ __forceinline__ double inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <bool kLog, typename T>
__device__ __forceinline__ bool bad_record(T a, T b, T c) {
  // NaN (x != x) or +inf anywhere
  const bool nan_inf = (a != a) | (b != b) | (c != c) | (a == inf<T>()) |
                       (b == inf<T>()) | (c == inf<T>());
  if (kLog)
    return nan_inf | ((a == -inf<T>()) & (b == -inf<T>()) & (c == -inf<T>()));
  return nan_inf | (a < T(0)) | (b < T(0)) | (c < T(0));
}

template <bool kStore, bool kLog>
__global__ void __launch_bounds__(kThreads)
    gl_narrow_kernel(const double* __restrict__ in, float* __restrict__ out,
                     int64_t n_rec, int* __restrict__ flag) {
  const int64_t n_pair = n_rec >> 1;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const double2* src = reinterpret_cast<const double2*>(in);
  bool bad = false;
  for (int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x; p < n_pair;
       p += stride) {
    const double2 x = src[3 * p], y = src[3 * p + 1], z = src[3 * p + 2];
    if (kStore) {
      const float v0 = __double2float_rn(x.x), v1 = __double2float_rn(x.y),
                  v2 = __double2float_rn(y.x), v3 = __double2float_rn(y.y),
                  v4 = __double2float_rn(z.x), v5 = __double2float_rn(z.y);
      bad |= bad_record<kLog>(v0, v1, v2) | bad_record<kLog>(v3, v4, v5);
      float* d = out + 6 * p;
      if (p & 1) {
        *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        *reinterpret_cast<float4*>(d + 2) = make_float4(v2, v3, v4, v5);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(v0, v1, v2, v3);
        *reinterpret_cast<float2*>(d + 4) = make_float2(v4, v5);
      }
    } else {
      bad |= bad_record<kLog>(x.x, x.y, y.x) | bad_record<kLog>(y.y, z.x, z.y);
    }
  }
  if ((n_rec & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    const int64_t r = 3 * (n_rec - 1);
    if (kStore) {
      const float a = __double2float_rn(in[r]), b = __double2float_rn(in[r + 1]),
                  c = __double2float_rn(in[r + 2]);
      out[r] = a;
      out[r + 1] = b;
      out[r + 2] = c;
      bad |= bad_record<kLog>(a, b, c);
    } else {
      bad |= bad_record<kLog>(in[r], in[r + 1], in[r + 2]);
    }
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0)
    atomicOr(flag, 1);
}

template <bool kStore>
int launch(const void* in, void* out, int64_t n_rec, int log_scale,
           void* flag, void* stream) {
  if (n_rec <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(in) % 16 ||
      (kStore && reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = ((n_rec >> 1) + kThreads - 1) / kThreads;
  const unsigned grid =
      (unsigned)(need < 1 ? 1 : need < (int64_t)sms * kBlocksPerSm
                                    ? need
                                    : (int64_t)sms * kBlocksPerSm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* i = static_cast<const double*>(in);
  float* o = static_cast<float*>(out);
  int* f = static_cast<int*>(flag);
  if (log_scale)
    gl_narrow_kernel<kStore, true><<<grid, kThreads, 0, st>>>(i, o, n_rec, f);
  else
    gl_narrow_kernel<kStore, false><<<grid, kThreads, 0, st>>>(i, o, n_rec, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in (n_rec, 3) float64 -> out (n_rec, 3) float32; *flag (int32) |= 1 when
// a narrowed record is bad (log_scale picks the scale's condition)
int ngsld_gl_narrow_f32(const void* in, void* out, int64_t n_rec,
                        int log_scale, void* flag, void* stream) {
  return launch<true>(in, out, n_rec, log_scale, flag, stream);
}

// The check alone, on the float64 records as they are
int ngsld_gl_check_f64(const void* in, int64_t n_rec, int log_scale,
                       void* flag, void* stream) {
  return launch<false>(in, nullptr, n_rec, log_scale, flag, stream);
}

}  // extern "C"
