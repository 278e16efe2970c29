// FedAvg reduce kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `aggregate_kernel` (body `_agg_body`) in
// src/repro/kernels/aggregate/kernel.py:29: theta[n] = sum_m w[m] * x[m, n],
// accumulated in fp32, for a row-major (M, N) cohort of fp32 or bf16
// parameter vectors and (M,) fp32 weights.
//
// What bounds it on this card: it reads every cohort byte once and does
// 2 flops per element, so it is bound by bytes: 5.0 ms for stablelm's
// (10, 380,789,760) fp32 cohort at 3.35 TB/s.  A thread that makes one
// 2- or 4-byte load a row, waiting on each before the next row's, keeps
// too few bytes in flight to reach that rate; at the classification
// (10, 199,210) and bf16 (64, 199,210) shapes the cohort sits in the
// 50 MB L2 between calls and the launch is a large share of the time.
//
// Design: each thread owns VEC consecutive columns and reads them as one
// VEC * sizeof(T)-byte load a row.  The wrapper picks VEC (`load_width`
// in kernels/aggregate/ops.py): the widest of 16, 8 or 4 bytes that
// divides both the cohort's address and its row pitch N * sizeof(T), so
// every row's vectors are aligned and N is a multiple of VEC (there is no
// tail), as long as the grid keeps two 256-thread blocks an SM; else one
// column.  On the port's paths that is 16 bytes for stablelm's and
// hymba's fp32 cohorts, 8 for the classification one and 4 (2 x bf16) for
// a (64, 199,210) bf16 cohort, whose rows are only 4-byte aligned.  The
// wider loads are the whole of the design: a thread reads its rows in
// order, each load feeding its add.  Issuing a batch of rows' loads
// before their adds, predicated so that the paths' m = 10 is one batch,
// was timed no faster there, and slower with the cohort in L2.  The
// cohort is read through the read-only path (ld.global.nc); a read-once
// hint (ld.global.cs) was slower at stablelm's size.  The sum runs over m in index order with separately
// rounded multiply and add (__fmul_rn / __fadd_rn, no contraction into
// FMA), so the result is bit-identical to the plain PyTorch version in
// kernels/aggregate/ref.py whatever VEC is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// The register type of one BYTES-wide load.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc[j] += w * x[j] for the VEC elements packed in `raw`.
template <typename T, int VEC, typename R>
__device__ __forceinline__ void accumulate(float (&acc)[VEC], float w, const R& raw) {
  T v[VEC];
  memcpy(v, &raw, sizeof(R));
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(w, to_float(v[j])));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fedavg_reduce_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int m, int64_t n) {
  using R = typename Raw<VEC * (int)sizeof(T)>::type;
  const int64_t pitch = n / VEC;  // in vectors
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= pitch) return;
  const R* p = reinterpret_cast<const R*>(x) + g;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int i = 0; i < m; ++i)
    accumulate<T, VEC>(acc, __ldg(w + i), __ldg(p + (int64_t)i * pitch));

  // VEC fp32 outputs: one 16-, 8- or 4-byte store each 4 of them (out is
  // the wrapper's own allocation, so 16-byte aligned).
  float* o = out + g * VEC;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(o + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    o[0] = acc[0];
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const float* w, float* out, int m, int64_t n,
                       cudaStream_t stream) {
  const int64_t blocks = (n / VEC + kThreads - 1) / kThreads;
  fedavg_reduce_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(x, w, out, m, n);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* w, float* out, int m, int64_t n, int vec, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (vec < 1 || n % vec != 0 || (uintptr_t)x % (vec * sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kElt = (int)sizeof(T);
  if (vec == 1) return (int)launch_vec<T, 1>(x, w, out, m, n, stream);
  switch (vec * kElt) {
    case 16: return (int)launch_vec<T, 16 / kElt>(x, w, out, m, n, stream);
    case 8: return (int)launch_vec<T, 8 / kElt>(x, w, out, m, n, stream);
    case 4: return (int)launch_vec<T, 4 / kElt>(x, w, out, m, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device addresses on
// `device`; `vec` is the columns a thread (the wrapper's choice; N and the
// address of x must be multiples of it, in elements and in vec * element
// bytes); the launch goes on `stream` and is not synchronised.  Each
// returns the cudaError_t of the launch (0 on success).
extern "C" int fedavg_reduce_f32(const float* x, const float* w, float* out,
                                 int m, int64_t n, int vec, int device, cudaStream_t stream) {
  return launch(x, w, out, m, n, vec, device, stream);
}

extern "C" int fedavg_reduce_bf16(const __nv_bfloat16* x, const float* w, float* out,
                                  int m, int64_t n, int vec, int device, cudaStream_t stream) {
  return launch(x, w, out, m, n, vec, device, stream);
}
