// Hellinger-distance strip kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `hellinger_strip_kernel` (tile body
// `_hellinger_tile`) in src/repro/kernels/hellinger/kernel.py.
//
// Computes out[i, j] = sqrt(clip(1 - sum_c rb[i, c] * r[j, c], 0, 1)) for
// (B, C) and (K, C) row-major fp32 panels of sqrt-histograms, writing the
// (B, K) fp32 strip row-major.
//
// What bounds it on this card: C is the class count (10 on the main path),
// so each output costs 2C flops against 4 bytes written.  At the
// hellinger_blocked strip (B = 4096, K = 16384, C = 10) the 268 MB output
// write takes ~80 us at 3.35 TB/s while the 1.3 GFLOP of fp32 FMA-free
// arithmetic takes ~20 us at 67 TFLOP/s: the kernel is bound by the bytes
// it writes.  C is far too thin for wgmma (a 16-deep bf16 / 8-deep tf32
// k-step would be mostly padding) and the distances must stay full fp32.
//
// Design: one 256-thread block per 32 x 32 output tile.  The two (32, CT)
// panel slices are staged in shared memory (the j panel padded by one
// column so the per-thread reads hit distinct banks; the i panel is read
// as a warp-wide broadcast).  Each thread owns one output column j and
// four rows, so every warp stores 32 consecutive floats: the only traffic
// that matters is written once, coalesced.  The inner product runs over c
// in index order with separately rounded multiply and add (__fmul_rn /
// __fadd_rn keep nvcc from contracting them into an FMA), so the result is
// bit-identical to the plain PyTorch version in kernels/hellinger/ref.py.
// No TF32 and no reduced-precision dot anywhere: sqrt(1 - bc) magnifies a
// rounding difference near bc = 1, and OPTICS ranks those small distances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;         // output tile is kTile x kTile
constexpr int kRowsPerThread = 4; // blockDim = (32, kTile / kRowsPerThread)
constexpr int kChunk = 32;        // classes staged in shared memory per pass

__global__ void __launch_bounds__(256)
hellinger_strip_kernel(const float* __restrict__ rb, const float* __restrict__ r,
                       float* __restrict__ out, int b, int k, int c) {
  __shared__ float si[kTile][kChunk];
  __shared__ float sj[kTile][kChunk + 1];

  const int tx = threadIdx.x;                  // output column within the tile
  const int ty = threadIdx.y;                  // 0 .. 7
  const int tid = ty * blockDim.x + tx;
  const int nthreads = blockDim.x * blockDim.y;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.0f;

  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int cn = min(kChunk, c - c0);
    for (int e = tid; e < kTile * kChunk; e += nthreads) {
      const int row = e / kChunk;
      const int col = e % kChunk;
      const bool in_c = col < cn;
      const int gi = i0 + row;
      const int gj = j0 + row;
      si[row][col] = (in_c && gi < b) ? rb[(int64_t)gi * c + c0 + col] : 0.0f;
      sj[row][col] = (in_c && gj < k) ? r[(int64_t)gj * c + c0 + col] : 0.0f;
    }
    __syncthreads();
    for (int cc = 0; cc < cn; ++cc) {
      const float vj = sj[tx][cc];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        acc[q] = __fadd_rn(acc[q], __fmul_rn(si[ty + q * (kTile / kRowsPerThread)][cc], vj));
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= k) return;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = i0 + ty + q * (kTile / kRowsPerThread);
    if (i < b) {
      const float d = fminf(fmaxf(__fsub_rn(1.0f, acc[q]), 0.0f), 1.0f);
      out[(int64_t)i * k + j] = sqrtf(d);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device addresses on
// `device`; the launch goes on `stream` and is not synchronised.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int hellinger_strip_f32(const float* rb, const float* r, float* out,
                                   int b, int k, int c, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || k <= 0) return 0;
  dim3 block(kTile, kTile / kRowsPerThread);
  dim3 grid((k + kTile - 1) / kTile, (b + kTile - 1) / kTile);
  hellinger_strip_kernel<<<grid, block, 0, stream>>>(rb, r, out, b, k, c);
  return (int)cudaGetLastError();
}
