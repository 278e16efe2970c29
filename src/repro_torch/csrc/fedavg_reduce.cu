// FedAvg reduce kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `aggregate_kernel` (body `_agg_body`) in
// src/repro/kernels/aggregate/kernel.py: theta[n] = sum_m w[m] * x[m, n],
// accumulated in fp32, for a row-major (M, N) cohort of fp32 or bf16
// parameter vectors and (M,) fp32 weights.
//
// What bounds it on this card: it reads every cohort byte once and does
// 2 flops per element, so it is bound by bytes.  On the main path
// (M = 10 clients, N = P = 199,210 MLP parameters, fp32) it moves ~8.8 MB,
// ~2.6 us at 3.35 TB/s, which is about the cost of a launch: launch
// overhead, not bandwidth, dominates there.
//
// Design: one thread per output column, a loop over M, so every warp reads
// 32 consecutive elements of a row (coalesced) and writes 32 consecutive
// outputs.  The TPU wrapper padded N to a multiple of 512 for its (8, 128)
// tiling; here the ragged edge is masked instead.  Rows of an odd-length
// cohort are not 16-byte aligned, so there are no vector loads.  The sum
// runs over m in index order with separately rounded multiply and add
// (__fmul_rn / __fadd_rn, no contraction into FMA), which makes the result
// bit-identical to the plain PyTorch version in kernels/aggregate/ref.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(256)
fedavg_reduce_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int m, int64_t n) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float acc = 0.0f;
  for (int i = 0; i < m; ++i) {
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + i), to_float(x[(int64_t)i * n + col])));
  }
  out[col] = acc;
}

template <typename T>
int launch(const T* x, const float* w, float* out, int m, int64_t n, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  fedavg_reduce_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(x, w, out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Pointers are device addresses on
// `device`; the launch goes on `stream` and is not synchronised.  Each
// returns the cudaError_t of the launch (0 on success).
extern "C" int fedavg_reduce_f32(const float* x, const float* w, float* out,
                                 int m, int64_t n, int device, cudaStream_t stream) {
  return launch(x, w, out, m, n, device, stream);
}

extern "C" int fedavg_reduce_bf16(const __nv_bfloat16* x, const float* w, float* out,
                                  int m, int64_t n, int device, cudaStream_t stream) {
  return launch(x, w, out, m, n, device, stream);
}
