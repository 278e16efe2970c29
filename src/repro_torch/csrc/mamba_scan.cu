// Mamba S6 selective scan, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `mamba_scan_kernel` (body `_scan_body`) in
// src/repro/kernels/mamba_scan/kernel.py:69.  For x, dt (B, S, D), Bm, Cm
// (B, S, N), a_log (G, D, N) and d_skip (G, D), with row b reading the
// weights of group g = b / (B / G) (G = 1: shared weights; G = m: one set
// per client of a local-SGD cohort of m x B/m sequences):
//
//   A     = -exp(a_log[g]),             abar_t = exp(dt_t A)           (D, N)
//   h_t   = abar_t * h_{t-1} + (dt_t x_t) Bm_t,    h_{-1} = 0         (D, N)
//   y_t   = h_t . Cm_t + d_skip[g] x_t                                (D,)
//
// Inputs x, dt, Bm, Cm are fp32 or bf16; a_log and d_skip are fp32; the state
// and all arithmetic are fp32 and y is written in x's type.  Discretisation
// happens inside the time loop, so the (B, S, D, N) coefficients of the JAX
// model's `_ssm_coeffs` never exist, which is what the TPU kernel is for.
//
// The TPU kernel is forward-only (the JAX package never differentiates it);
// here the gradient is a kernel too.  With dh_t the gradient of the state:
//
//   dh_t    = dy_t Cm_t + abar_{t+1} * dh_{t+1}
//   dCm_t   = sum_d dy_t h_t                dBm_t = sum_d dh_t dt_t x_t
//   dx_t    = sum_n dh_t dt_t Bm_t + d_skip dy_t
//   ddt_t   = sum_n dh_t (h_{t-1} A abar_t + x_t Bm_t)
//   da_log  = sum_{b in g, t} dh_t h_{t-1} abar_t dt_t A
//   dd_skip = sum_{b in g, t} dy_t x_t
//
// Kernels:
//   scan_fwd_kernel   one thread per (row b, channel d), 128 channels a block,
//                     N <= 16 states in registers; the loop over S replaces
//                     the TPU's sequential time grid axis.  x, dt and y move
//                     coalesced along D; Bm and Cm, the same for every channel
//                     of a row, are staged 64 steps at a time in shared memory.
//                     A ragged D is masked and S is never padded.  When a
//                     gradient is wanted it also writes the state before every
//                     kChunk-th step, ckpt (B, ceil(S / kChunk), D, N) fp32
//                     (twice the bytes of x in fp32 at N = 16 and kChunk = 8),
//                     never the full (B, S, D, N) state.
//   scan_bwd_kernel   the same threads walk the chunks from the last: recompute
//                     the chunk's states from its checkpoint into shared memory,
//                     then run the reverse-time recurrence over them.  dx and
//                     ddt are per thread.  dBm and dCm sum over channels: per
//                     step a warp reduce-scatters its 32 values (16 of each) in
//                     31 shuffles, the block's warps are summed in shared memory
//                     in warp order, and every channel block writes its partial
//                     (ceil(D / 128), B, S, 32).  da_log and dd_skip sum over t
//                     in registers and are written per row, (B, D, N) and (B, D).
//   reduce_bc_kernel, reduce_params_kernel
//                     the second pass: sum the partials over channel blocks, and
//                     over the rows of each group, in index order.  No atomics,
//                     so the gradient is the same from run to run.
//
// What bounds it on this card: per (row, t, channel) the forward reads x and dt
// and writes y (12 bytes in fp32) and takes N = 16 exps; at the SFU's 16 a clock
// per SM (~4.2e12 a second on 132 SMs) the exps cost about as much as the bytes
// (~0.03 ms each at the local-SGD shape (80, 64, 1600, 16)).  The time loop is
// serial per thread, so the card fills only when B x D is large: at B = 4 and
// D = 1600 just 6,400 threads run, below one thread per core (a later design may
// split S with a chunked scan).  The backward does twice the exps and keeps the
// chunk's states in 64 KB of shared memory a block (3 blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kN = 16;                  // the most states; a smaller N is zero-padded
constexpr int kStage = 64;              // forward: steps of Bm, Cm staged at once
constexpr int kChunk = 8;               // steps between checkpoints

struct Dims {
  int b, s, d, n, groups, rows_per_group, n_chunks;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Bm and Cm of steps [t0, t0 + len) of one row as fp32 [step][kN], zero
// past len and past N.
template <typename T, int STEPS>
__device__ __forceinline__ void stage_bc(float* sb, float* sc, const T* bm, const T* cm,
                                         int64_t row0, int t0, int len, int n) {
  for (int e = threadIdx.x; e < STEPS * kN; e += kThreads) {
    const int j = e / kN, k = e % kN;
    const bool ok = j < len && k < n;
    const int64_t at = (row0 + t0 + j) * n + k;
    sb[e] = ok ? to_f(bm[at]) : 0.0f;
    sc[e] = ok ? to_f(cm[at]) : 0.0f;
  }
}

// A = -exp(a_log) of this thread's channel; 0 for a masked channel or state.
__device__ __forceinline__ void load_a(float (&a)[kN], const float* a_log, int g, int d,
                                       const Dims& p, bool live) {
#pragma unroll
  for (int k = 0; k < kN; ++k)
    a[k] = (live && k < p.n) ? -expf(a_log[((int64_t)g * p.d + d) * p.n + k]) : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a_log,
                const float* __restrict__ d_skip, T* __restrict__ y, float* __restrict__ ckpt,
                Dims p) {
  __shared__ float sb[kStage * kN], sc[kStage * kN];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int g = b / p.rows_per_group;
  const bool live = d < p.d;
  float a[kN], h[kN];
  load_a(a, a_log, g, d, p, live);
#pragma unroll
  for (int k = 0; k < kN; ++k) h[k] = 0.0f;
  const float dsk = live ? d_skip[(int64_t)g * p.d + d] : 0.0f;
  const int64_t row0 = (int64_t)b * p.s;

  for (int t0 = 0; t0 < p.s; t0 += kStage) {
    const int len = min(kStage, p.s - t0);
    __syncthreads();  // the previous tile is consumed
    stage_bc<T, kStage>(sb, sc, bm, cm, row0, t0, len, p.n);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < len; ++j) {
      const int t = t0 + j;
      if (ckpt != nullptr && t % kChunk == 0) {
        float* c = ckpt + (((int64_t)b * p.n_chunks + t / kChunk) * p.d + d) * p.n;
#pragma unroll
        for (int k = 0; k < kN; ++k)
          if (k < p.n) c[k] = h[k];
      }
      const int64_t at = (row0 + t) * p.d + d;
      const float xt = to_f(x[at]), dtt = to_f(dt[at]);
      const float drive = dtt * xt;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        h[k] = expf(dtt * a[k]) * h[k] + drive * sb[j * kN + k];
        acc += h[k] * sc[j * kN + k];
      }
      y[at] = from_f<T>(acc + dsk * xt);
    }
  }
}

// One butterfly level of a warp reduce-scatter: lanes l and l ^ W swap the
// halves of v[0, 2W) that the other keeps, and add.
template <int W>
__device__ __forceinline__ void scatter_level(float (&v)[32], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = up ? v[k] : v[k + W];
    const float keep = up ? v[k + W] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Sum of v[lane] over the warp's 32 lanes, for every lane at once.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  scatter_level<16>(v, lane);
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  return v[0];
}

constexpr size_t bwd_smem() {
  return sizeof(float) * (kChunk * kN * kThreads + 2 * kChunk * kN + kWarps * kChunk * 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a_log,
                const float* __restrict__ d_skip, const float* __restrict__ ckpt,
                const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ ddt,
                float* __restrict__ part_bc, float* __restrict__ part_a,
                float* __restrict__ part_d, Dims p) {
  extern __shared__ float smem[];
  float* sh = smem;                              // [kChunk][kN][kThreads]: h_{t-1}
  float* sb = sh + kChunk * kN * kThreads;       // [kChunk][kN]
  float* sc = sb + kChunk * kN;
  float* sred = sc + kChunk * kN;                // [kWarps][kChunk][32]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const int g = b / p.rows_per_group;
  const bool live = d < p.d;
  float a[kN], carry[kN], da[kN];
  load_a(a, a_log, g, d, p, live);
#pragma unroll
  for (int k = 0; k < kN; ++k) carry[k] = da[k] = 0.0f;
  const float dsk = live ? d_skip[(int64_t)g * p.d + d] : 0.0f;
  float dd = 0.0f;
  const int64_t row0 = (int64_t)b * p.s;

  for (int c = p.n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, p.s - t0);
    __syncthreads();  // the previous chunk's shared memory is consumed
    stage_bc<T, kChunk>(sb, sc, bm, cm, row0, t0, len, p.n);
    __syncthreads();

    // Recompute the chunk's states from its checkpoint.
    float h[kN];
    const float* ck = ckpt + (((int64_t)b * p.n_chunks + c) * p.d + d) * p.n;
#pragma unroll
    for (int k = 0; k < kN; ++k) h[k] = (live && k < p.n) ? ck[k] : 0.0f;
    for (int j = 0; j < len; ++j) {
#pragma unroll
      for (int k = 0; k < kN; ++k) sh[(j * kN + k) * kThreads + tid] = h[k];
      if (live) {
        const int64_t at = (row0 + t0 + j) * p.d + d;
        const float dtt = to_f(dt[at]), drive = dtt * to_f(x[at]);
#pragma unroll
        for (int k = 0; k < kN; ++k) h[k] = expf(dtt * a[k]) * h[k] + drive * sb[j * kN + k];
      }
    }

    // Reverse time: h holds h_t, sh[j] holds h_{t-1}.
    for (int j = len - 1; j >= 0; --j) {
      const int64_t at = (row0 + t0 + j) * p.d + d;
      float xt = 0.0f, dtt = 0.0f, dyt = 0.0f;
      if (live) {
        xt = to_f(x[at]);
        dtt = to_f(dt[at]);
        dyt = to_f(dy[at]);
      }
      float v[32];  // v[k]: dBm contribution, v[16 + k]: dCm contribution
      float dxs = 0.0f, ddts = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float hp = sh[(j * kN + k) * kThreads + tid];
        const float bk = sb[j * kN + k];
        const float ab = expf(dtt * a[k]);
        const float dh = dyt * sc[j * kN + k] + carry[k];
        const float ha = hp * ab * a[k];
        v[k] = dh * dtt * xt;
        v[kN + k] = dyt * h[k];
        dxs += dh * bk;
        ddts += dh * (ha + xt * bk);
        da[k] += dh * ha * dtt;
        carry[k] = ab * dh;
        h[k] = hp;
      }
      if (live) {
        dx[at] = from_f<T>(dxs * dtt + dsk * dyt);
        ddt[at] = from_f<T>(ddts);
        dd += dyt * xt;
      }
      sred[(warp * kChunk + j) * 32 + lane] = reduce_scatter32(v);
    }
    __syncthreads();
    for (int e = tid; e < len * 32; e += kThreads) {
      const int j = e / 32, i = e % 32;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sred[(w * kChunk + j) * 32 + i];
      part_bc[(((int64_t)blockIdx.x * p.b + b) * p.s + t0 + j) * 32 + i] = s;
    }
  }
  if (live) {
    float* pa = part_a + ((int64_t)b * p.d + d) * p.n;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (k < p.n) pa[k] = da[k];
    part_d[(int64_t)b * p.d + d] = dd;
  }
}

// dBm, dCm (B, S, N) = the channel blocks' partials summed in block order.
template <typename T>
__global__ void __launch_bounds__(256)
reduce_bc_kernel(const float* __restrict__ part, T* __restrict__ dbm, T* __restrict__ dcm,
                 int n_parts, int64_t rows, int n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * 32) return;
  const int i = (int)(e % 32);
  const int64_t r = e / 32;
  if ((i % kN) >= n) return;
  float s = 0.0f;
  for (int k = 0; k < n_parts; ++k) s += part[(int64_t)k * rows * 32 + e];
  if (i < kN)
    dbm[r * n + i] = from_f<T>(s);
  else
    dcm[r * n + i - kN] = from_f<T>(s);
}

// da_log (G, D, N) and dd_skip (G, D) = the rows' partials of each group
// summed in row order.
__global__ void __launch_bounds__(256)
reduce_params_kernel(const float* __restrict__ part_a, const float* __restrict__ part_d,
                     float* __restrict__ da_log, float* __restrict__ dd_skip, Dims p) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t na = (int64_t)p.groups * p.d * p.n, nd = (int64_t)p.groups * p.d;
  if (e < na) {
    const int64_t per = (int64_t)p.d * p.n, g = e / per, at = e % per;
    float s = 0.0f;
    for (int r = 0; r < p.rows_per_group; ++r)
      s += part_a[((int64_t)g * p.rows_per_group + r) * per + at];
    da_log[e] = s;
  } else if (e < na + nd) {
    const int64_t f = e - na, g = f / p.d, at = f % p.d;
    float s = 0.0f;
    for (int r = 0; r < p.rows_per_group; ++r)
      s += part_d[((int64_t)g * p.rows_per_group + r) * p.d + at];
    dd_skip[f] = s;
  }
}

bool make_dims(const int64_t* dims, Dims* p) {
  p->b = (int)dims[0];
  p->s = (int)dims[1];
  p->d = (int)dims[2];
  p->n = (int)dims[3];
  p->groups = (int)dims[4];
  if (p->b <= 0 || p->s <= 0 || p->d <= 0 || p->n <= 0 || p->n > kN || p->groups <= 0 ||
      p->b % p->groups != 0 || p->b > 65535)
    return false;
  p->rows_per_group = p->b / p->groups;
  p->n_chunks = (p->s + kChunk - 1) / kChunk;
  return true;
}

dim3 scan_grid(const Dims& p) { return dim3((p.d + kThreads - 1) / kThreads, p.b); }

template <typename T>
cudaError_t forward(const Dims& p, const void* x, const void* dt, const void* bm, const void* cm,
                    const float* a_log, const float* d_skip, void* y, float* ckpt,
                    cudaStream_t st) {
  scan_fwd_kernel<T><<<scan_grid(p), kThreads, 0, st>>>(
      (const T*)x, (const T*)dt, (const T*)bm, (const T*)cm, a_log, d_skip, (T*)y, ckpt, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const Dims& p, const void* x, const void* dt, const void* bm,
                     const void* cm, const float* a_log, const float* d_skip, const float* ckpt,
                     const void* dy, void* dx, void* ddt, void* dbm, void* dcm, float* da_log,
                     float* dd_skip, float* part_bc, float* part_a, float* part_d,
                     cudaStream_t st) {
  constexpr size_t smem = bwd_smem();
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = scan_grid(p);
  scan_bwd_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)x, (const T*)dt, (const T*)bm, (const T*)cm, a_log, d_skip, ckpt, (const T*)dy,
      (T*)dx, (T*)ddt, part_bc, part_a, part_d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)p.b * p.s;
  reduce_bc_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, st>>>(
      part_bc, (T*)dbm, (T*)dcm, (int)grid.x, rows, p.n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)p.groups * p.d * (p.n + 1);
  reduce_params_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part_a, part_d, da_log,
                                                                       dd_skip, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  `dtype` is 0 for fp32 and 1 for bf16 (x,
// dt, Bm, Cm, y and their gradients); a_log, d_skip, the checkpoints, the
// partials and the weight gradients are fp32.  `dims` holds (B, S, D, N, G)
// in host memory.  Every tensor is contiguous: x, dt, y (B, S, D); Bm, Cm
// (B, S, N); a_log (G, D, N); d_skip (G, D); ckpt (B, ceil(S / chunk), D, N);
// part_bc (ceil(D / block), B, S, 32); part_a (B, D, N); part_d (B, D).
// Pointers are device addresses on `device`; launches go on `stream` and are
// not synchronised.  Each returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for a shape the kernels do not take).

// The layout constants the caller sizes the checkpoints and partials by.
extern "C" int mamba_scan_chunk() { return kChunk; }
extern "C" int mamba_scan_block() { return kThreads; }

// y = scan(x, dt, Bm, Cm, a_log, d_skip); ckpt may be null (no gradient).
extern "C" int mamba_scan_fwd(int dtype, const void* x, const void* dt, const void* bm,
                              const void* cm, const float* a_log, const float* d_skip, void* y,
                              float* ckpt, const int64_t* dims, int device,
                              cudaStream_t stream) {
  Dims p;
  if (!make_dims(dims, &p) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0
                   ? forward<float>(p, x, dt, bm, cm, a_log, d_skip, y, ckpt, stream)
                   : forward<__nv_bfloat16>(p, x, dt, bm, cm, a_log, d_skip, y, ckpt, stream));
}

// (dx, ddt, dBm, dCm, da_log, dd_skip) from dy and the forward's checkpoints.
extern "C" int mamba_scan_bwd(int dtype, const void* x, const void* dt, const void* bm,
                              const void* cm, const float* a_log, const float* d_skip,
                              const float* ckpt, const void* dy, void* dx, void* ddt, void* dbm,
                              void* dcm, float* da_log, float* dd_skip, float* part_bc,
                              float* part_a, float* part_d, const int64_t* dims, int device,
                              cudaStream_t stream) {
  Dims p;
  if (!make_dims(dims, &p) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0 ? backward<float>(p, x, dt, bm, cm, a_log, d_skip, ckpt, dy, dx, ddt,
                                            dbm, dcm, da_log, dd_skip, part_bc, part_a, part_d,
                                            stream)
                          : backward<__nv_bfloat16>(p, x, dt, bm, cm, a_log, d_skip, ckpt, dy,
                                                    dx, ddt, dbm, dcm, da_log, dd_skip, part_bc,
                                                    part_a, part_d, stream));
}
