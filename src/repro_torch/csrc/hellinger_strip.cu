// Hellinger-distance strip kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `hellinger_strip_kernel` (tile body
// `_hellinger_tile`) in src/repro/kernels/hellinger/kernel.py:38.
//
// Computes out[i, j] = sqrt(clip(1 - sum_c rb[i, c] * r[j, c], 0, 1)) for
// (B, C) and (K, C) row-major fp32 panels of sqrt-histograms, writing the
// (B, K) fp32 strip row-major.
//
// What bounds it on this card: C is the class count (10 on the main path),
// so each output costs 2C flops against 4 bytes written.  At the
// hellinger_blocked strip (B = 4096, K = 16384, C = 10) the 268 MB output
// write takes ~80 us at 3.35 TB/s while the 1.3 GFLOP of fp32 FMA-free
// arithmetic takes ~20 us at 67 TFLOP/s: the function is bound by the
// bytes it writes.  The instructions a thread issues for an output (2C
// for the separate multiply and add, the clip, IEEE sqrt's sequence) come
// to about two thirds of that write time, so a kernel also has to overlap
// them with its stores.  C is far too thin for wgmma (a 16-deep bf16 /
// 8-deep tf32 k-step would be mostly padding) and the distances must stay
// full fp32.  A small tile a block pays a per-block fixed cost (staging,
// barriers) that, not the write stream, then sets the time.
//
// Design: one 256-thread block owns a kTileRows x 128 output tile, each
// thread 4 columns of ROWS rows (kTileRows = 8 * ROWS).  The tile's slices
// of both panels are staged in shared memory transposed, with only the
// real classes (chunks of up to kMaxChunk, loaded as contiguous runs: the
// (rows, C) slice of a row-major panel is one run when C fits a chunk),
// rows padded by 4 floats so the staging stores spread over the banks.
// Lane l of warp w owns output columns 4l .. 4l + 3 of the tile's rows
// w * ROWS .. + ROWS - 1: each class step reads the lane's four r values
// as one float4 (a warp reads 512 contiguous bytes) and the warp's rb
// values as float4 broadcasts, and each tile row leaves as one 16-byte
// evict-first store a lane (st.global.cs; the strip is larger than L2 and
// no kernel reads it again), a warp writing 512 contiguous bytes.  Strips
// whose rows are not 16-byte aligned (K % 4 != 0) take the same kernel
// with four masked 4-byte stores a row instead.  ROWS is 8 (64 x 128
// tiles) on strips of at least one such tile an SM, and 4 (32 x 128) on
// smaller ones, such as the (100, 100) strip the paths build at
// setup, where more, smaller tiles spread over more SMs.  The wrapper
// chooses the store path and ROWS (`tile_choice` in
// kernels/hellinger/ops.py).  The inner product runs over c in index
// order with separately rounded multiply and add (__fmul_rn / __fadd_rn
// keep nvcc from contracting them into an FMA), then __fsub_rn(1, acc),
// the clip and IEEE sqrtf, so the result is bit-identical to the plain
// PyTorch version on the card in kernels/hellinger/ref.py.  No TF32 and
// no reduced-precision dot anywhere: sqrt(1 - bc) magnifies a rounding
// difference near bc = 1, and OPTICS ranks those small distances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32 * 4;                // a lane's 4 columns
constexpr int kMaxChunk = 32;                    // classes staged a pass
constexpr int kPadJ = kTileCols + 4;             // shared row pitch, a 16-byte multiple

// Stages classes c0 .. c0 + cn of rows row0 .. row0 + kRows - 1 of a
// row-major (*, c) panel into dst[cc * kPitch + row], transposed, with 0
// past its `valid` rows.  Consecutive threads take consecutive classes of a
// row: one contiguous run of global memory when cn == c.
template <int kRows, int kPitch>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0,
                                      int valid, int c, int c0, int cn) {
  for (int e = threadIdx.x; e < kRows * cn; e += kThreads) {
    const int row = e / cn;
    const int cc = e - row * cn;
    dst[cc * kPitch + row] = row < valid ? src[(int64_t)(row0 + row) * c + c0 + cc] : 0.0f;
  }
}

// The shared row pitch of the staged rb slice, a 16-byte multiple.
template <int ROWS> __host__ __device__ constexpr int pad_i() { return kWarps * ROWS + 4; }

template <int ROWS, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
hellinger_strip_kernel(const float* __restrict__ rb, const float* __restrict__ r,
                       float* __restrict__ out, int b, int k, int c) {
  static_assert(ROWS % 4 == 0, "rows a thread come in float4 broadcasts");
  constexpr int kRowsPerThread = ROWS;
  constexpr int kTileRows = kWarps * ROWS;
  constexpr int kPadI = pad_i<ROWS>();
  extern __shared__ float4 smem4[];
  const int chunk = min(c, kMaxChunk);
  float* si = reinterpret_cast<float*>(smem4);   // [chunk][kPadI]: rb, transposed
  float* sj = si + chunk * kPadI;                // [chunk][kPadJ]: r, transposed

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.y * kTileRows;
  const int j0 = blockIdx.x * kTileCols;
  const int rows_i = min(kTileRows, b - i0);
  const int rows_j = min(kTileCols, k - j0);

  float acc[kRowsPerThread][4];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;

  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int cn = min(chunk, c - c0);
    if (c0 > 0) __syncthreads();  // every read of the previous chunk is done
    stage<kTileRows, kPadI>(si, rb, i0, rows_i, c, c0, cn);
    stage<kTileCols, kPadJ>(sj, r, j0, rows_j, c, c0, cn);
    __syncthreads();
    for (int cc = 0; cc < cn; ++cc) {
      const float4 vj = *reinterpret_cast<const float4*>(sj + cc * kPadJ + 4 * lane);
      float vi[kRowsPerThread];
#pragma unroll
      for (int t = 0; t < kRowsPerThread; t += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            si + cc * kPadI + warp * kRowsPerThread + t);
        vi[t] = v.x; vi[t + 1] = v.y; vi[t + 2] = v.z; vi[t + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < kRowsPerThread; ++t) {
        acc[t][0] = __fadd_rn(acc[t][0], __fmul_rn(vi[t], vj.x));
        acc[t][1] = __fadd_rn(acc[t][1], __fmul_rn(vi[t], vj.y));
        acc[t][2] = __fadd_rn(acc[t][2], __fmul_rn(vi[t], vj.z));
        acc[t][3] = __fadd_rn(acc[t][3], __fmul_rn(vi[t], vj.w));
      }
    }
  }

  const int j = j0 + 4 * lane;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int i = i0 + warp * kRowsPerThread + t;
    if (i >= b) break;
    float h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h[q] = sqrtf(fminf(fmaxf(__fsub_rn(1.0f, acc[t][q]), 0.0f), 1.0f));
    float* o = out + (int64_t)i * k + j;
    if constexpr (kVecStore) {
      if (j < k) __stcs(reinterpret_cast<float4*>(o), make_float4(h[0], h[1], h[2], h[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < k) __stcs(o + q, h[q]);
    }
  }
}

template <int ROWS>
cudaError_t launch(const float* rb, const float* r, float* out, int b, int k, int c,
                   bool vec_store, cudaStream_t stream) {
  const dim3 grid((k + kTileCols - 1) / kTileCols, (b + kWarps * ROWS - 1) / (kWarps * ROWS));
  const size_t smem = (size_t)(c < kMaxChunk ? c : kMaxChunk) * (pad_i<ROWS>() + kPadJ) *
                      sizeof(float);
  if (vec_store) {
    hellinger_strip_kernel<ROWS, true><<<grid, kThreads, smem, stream>>>(rb, r, out, b, k, c);
  } else {
    hellinger_strip_kernel<ROWS, false><<<grid, kThreads, smem, stream>>>(rb, r, out, b, k, c);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Pointers are device addresses on
// `device`; `vec_store` and `rows` are the wrapper's choices: `vec_store`
// writes each tile row in 16-byte stores and needs K % 4 == 0 and a
// 16-byte aligned `out`; `rows` (4 or 8) is the tile rows a thread.  The
// launch goes on `stream` and is not synchronised.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int hellinger_strip_f32(const float* rb, const float* r, float* out,
                                   int b, int k, int c, int vec_store, int rows, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || k <= 0) return 0;
  if (vec_store && (k % 4 != 0 || (uintptr_t)out % 16 != 0)) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 4: return (int)launch<4>(rb, r, out, b, k, c, vec_store != 0, stream);
    case 8: return (int)launch<8>(rb, r, out, b, k, c, vec_store != 0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
