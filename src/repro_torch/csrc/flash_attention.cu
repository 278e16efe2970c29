// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_kernel` (body `_flash_body`) in
// src/repro/kernels/flash_attention/kernel.py, and computes what
// `flash_attention` in src/repro/models/attention.py computes: for q
// (B, S, H, D) and k, v (B, S, KV, D) in the model layout, with H = KV * G
// and query head h reading kv head h / G,
//
//   O[b, i, h] = sum_j softmax_j(scale * q_i . k_j + mask_ij) v_j,
//   mask_ij    = 0 if j <= i and (is_global or window <= 0 or i - j < window)
//                else -inf,                                   scale = 1/sqrt(D).
//
// The TPU kernel is forward-only (the JAX package differentiates the pure-JAX
// chunked attention); here the gradient is a kernel too, FA2-style with the
// softmax recomputed from the row log-sum-exp L = m + log(l) that the forward
// writes as (B, H, S) fp32:
//
//   dq_kernel    one block per (batch, head, q-tile): delta_i = dO_i . O_i
//                (written out for dkdv_kernel), then over the k-tiles
//                P = exp(scale S - L), dP = dO V^T, dS = P (dP - delta),
//                dQ += scale dS K.
//   dkdv_kernel  one block per (batch, kv head, k-tile): over the G query heads
//                of the group and the q-tiles at or below the diagonal,
//                dV += P^T dO, dK += scale dS^T Q.  A block owns its rows of dK
//                and dV outright, so there are no atomics.
//
// q, k and v are read in place through their element strides (no transpose,
// no GQA repeat); O, dO, dQ, dK and dV are contiguous in the model layout.
// Inputs are fp32 or bf16; every product and the running max, denominator
// and accumulators are fp32 on the CUDA cores (no TF32: the fp32 path must
// match the JAX package, which multiplies in full fp32).  O and the
// gradients are written in the input type.
//
// What bounds it on this card: attention over S keys costs ~4 S D flops a
// query row forward (half of that is masked away by causality) against
// 4 D bytes of q, k, v and O each, so at the S of the main path (64) and
// above it is bound by operations, here the 67 TFLOP/s of fp32 outside the
// tensor cores.  Design for now: a simple tiled kernel that is right first.
// 256 threads as a 16 x 16 grid; a thread owns rows ty + 16 i and columns
// tx + 16 j of every tile, so row reductions are 16-lane shuffles.  Tiles
// are staged in shared memory as fp32 with rows padded by one float (the
// column-strided reads hit distinct banks).  The k-tile loop of a q-tile
// stops at the diagonal and, for a windowed layer, starts at the first tile
// the window reaches; ragged S is masked, not padded.  D is a run-time value
// up to 256; the register tiles are sized by templates over DMAX in
// {64, 96, 128, 256}.  A wgmma/TMA design in bf16 is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16

struct Params {
  int b, s, h, kv, d;
  int64_t q[4], k[4], v[4];  // element strides over (batch, seq, head, dim)
  int window;                // > 0 with is_global == 0: sliding window
  int is_global;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// Tile sizes by DMAX: 64 x 64 tiles up to DMAX 128, 32 x 32 at 256, so every
// kernel's shared memory stays under the 227 KB a block may use.
template <int DMAX> struct Tiles { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

// Rows [s0, s0 + R) of one head, as fp32 in shared memory with row stride
// DMAX + 1; zero outside [0, S) x [0, D).
template <typename T, int R, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t ss, int64_t sd,
                                          int s0, int S, int D) {
  constexpr int LD = DMAX + 1;
  for (int e = threadIdx.x; e < R * DMAX; e += kThreads) {
    const int r = e / DMAX, d = e % DMAX;
    float val = 0.0f;
    if (s0 + r < S && d < D) val = to_f(base[(int64_t)(s0 + r) * ss + (int64_t)d * sd]);
    dst[r * LD + d] = val;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, const Params& p, bool windowed) {
  return kpos <= qpos && qpos < p.s && (!windowed || qpos - kpos < p.window);
}

// First and last k-tile that query rows [q0, q0 + BQ) see.
template <int BQ, int BK>
__device__ __forceinline__ void k_range(int q0, const Params& p, bool windowed, int* lo, int* hi) {
  *hi = (min(q0 + BQ, p.s) - 1) / BK;
  *lo = windowed ? max(0, q0 - p.window + 1) / BK : 0;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Params p) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  constexpr int LD = DMAX + 1, LP = BK + 1;
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = DMAX / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * LD;
  float* sv = sk + BK * LD;
  float* sp = sv + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.kv);
  const bool windowed = p.window > 0 && !p.is_global;
  const T* kb = k + b * p.k[0] + hk * p.k[2];
  const T* vb = v + b * p.v[0] + hk * p.v[2];
  load_tile<T, BQ, DMAX>(sq, q + b * p.q[0] + h * p.q[2], p.q[1], p.q[3], q0, p.s, p.d);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int kt_lo, kt_hi;
  k_range<BQ, BK>(q0, p, windowed, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BK, DMAX>(sk, kb, p.k[1], p.k[3], k0, p.s, p.d);
    load_tile<T, BK, DMAX>(sv, vb, p.v[1], p.v[3], k0, p.s, p.d);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < p.d; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = visible(qpos, k0 + tx + 16 * j, p, windowed) ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // a row with nothing visible yet
      const float corr = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pv = expf(s[i][j] - m_use);
        sp[(ty + 16 * i) * LP + tx + 16 * j] = pv;
        sum += pv;
      }
      l[i] = l[i] * corr + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sp[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sv[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.s) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * p.s + qpos) * p.h + h) * p.d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.d) orow[d] = from_f<T>(acc[i][j] * inv);
    }
    if (tx == 0) lse[((int64_t)b * p.h + h) * p.s + qpos] = m[i] + logf(l[i]);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, Params p) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  static_assert(BQ == BK, "the O tile is staged in the K buffer");
  constexpr int LD = DMAX + 1, LP = BK + 1;
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = DMAX / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * LD;
  float* sk = sdo + BQ * LD;
  float* sv = sk + BK * LD;
  float* sds = sv + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.kv);
  const bool windowed = p.window > 0 && !p.is_global;
  const int64_t row = (int64_t)p.h * p.d;  // seq stride of O, dO, dQ
  const int64_t head0 = (int64_t)b * p.s * row + (int64_t)h * p.d;
  const T* kb = k + b * p.k[0] + hk * p.k[2];
  const T* vb = v + b * p.v[0] + hk * p.v[2];
  load_tile<T, BQ, DMAX>(sq, q + b * p.q[0] + h * p.q[2], p.q[1], p.q[3], q0, p.s, p.d);
  load_tile<T, BQ, DMAX>(sdo, dout + head0, row, 1, q0, p.s, p.d);
  load_tile<T, BQ, DMAX>(sk, o + head0, row, 1, q0, p.s, p.d);
  __syncthreads();

  float dl[RI], L[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) part = fmaf(sdo[r * LD + tx + 16 * j], sk[r * LD + tx + 16 * j], part);
    dl[i] = group16_sum(part);
    L[i] = 0.0f;
    if (qpos < p.s) {
      const int64_t at = ((int64_t)b * p.h + h) * p.s + qpos;
      L[i] = lse[at];
      if (tx == 0) delta[at] = dl[i];
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int kt_lo, kt_hi;
  k_range<BQ, BK>(q0, p, windowed, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, DMAX>(sk, kb, p.k[1], p.k[3], k0, p.s, p.d);
    load_tile<T, BK, DMAX>(sv, vb, p.v[1], p.v[3], k0, p.s, p.d);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < p.d; ++d) {
      float qv[RI], gv[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = sq[(ty + 16 * i) * LD + d];
        gv[i] = sdo[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = sk[(tx + 16 * j) * LD + d];
        vv[j] = sv[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pr = visible(qpos, k0 + tx + 16 * j, p, windowed)
                             ? expf(s[i][j] * p.scale - L[i]) : 0.0f;
        sds[(ty + 16 * i) * LP + tx + 16 * j] = pr * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = sds[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sk[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.s) continue;
    T* grow = dq + head0 + (int64_t)qpos * row;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.d) grow[d] = from_f<T>(acc[i][j] * p.scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  constexpr int LD = DMAX + 1, LP = BK + 1;
  constexpr int RI = BQ / 16, CJ = BK / 16, CI = BK / 16, DJ = DMAX / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BK * LD;
  float* sq = sv + BK * LD;
  float* sdo = sq + BQ * LD;
  float* sp = sdo + BQ * LD;
  float* sds = sp + BQ * LP;
  float* sl = sds + BQ * LP;
  float* sdl = sl + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.kv;
  const bool windowed = p.window > 0 && !p.is_global;
  const int64_t row = (int64_t)p.h * p.d;  // seq stride of dO
  load_tile<T, BK, DMAX>(sk, k + b * p.k[0] + hk * p.k[2], p.k[1], p.k[3], k0, p.s, p.d);
  load_tile<T, BK, DMAX>(sv, v + b * p.v[0] + hk * p.v[2], p.v[1], p.v[3], k0, p.s, p.d);

  float gk[CI][DJ], gv[CI][DJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gk[i][j] = gv[i][j] = 0.0f;

  // q-tiles that see keys [k0, k0 + BK): from the diagonal down to the end,
  // or to the window's reach.
  const int qt_lo = k0 / BQ;
  int qt_hi = (p.s - 1) / BQ;
  if (windowed) qt_hi = min(qt_hi, (min(k0 + BK, p.s) - 1 + p.window - 1) / BQ);

  for (int hq = hk * g; hq < (hk + 1) * g; ++hq) {
    const T* qb = q + b * p.q[0] + hq * p.q[2];
    const T* gb = dout + (int64_t)b * p.s * row + (int64_t)hq * p.d;
    const int64_t stat0 = ((int64_t)b * p.h + hq) * p.s;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<T, BQ, DMAX>(sq, qb, p.q[1], p.q[3], q0, p.s, p.d);
      load_tile<T, BQ, DMAX>(sdo, gb, row, 1, q0, p.s, p.d);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < p.s;
        sl[r] = in ? lse[stat0 + q0 + r] : 0.0f;
        sdl[r] = in ? delta[stat0 + q0 + r] : 0.0f;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.0f;
      for (int d = 0; d < p.d; ++d) {
        float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = sq[(ty + 16 * i) * LD + d];
          ov[i] = sdo[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kv[j] = sk[(tx + 16 * j) * LD + d];
          vv[j] = sv[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + 16 * j;
          const float pr = visible(q0 + r, k0 + c, p, windowed)
                               ? expf(s[i][j] * p.scale - sl[r]) : 0.0f;
          sp[r * LP + c] = pr;
          sds[r * LP + c] = pr * (dp[i][j] - sdl[r]);
        }
      }
      __syncthreads();

      for (int r = 0; r < BQ; ++r) {
        float pc[CI], dc[CI];
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          pc[i] = sp[r * LP + ty + 16 * i];
          dc[i] = sds[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float go = sdo[r * LD + tx + 16 * j];
          const float qq = sq[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < CI; ++i) {
            gv[i][j] = fmaf(pc[i], go, gv[i][j]);
            gk[i][j] = fmaf(dc[i], qq, gk[i][j]);
          }
        }
      }
    }
  }

  const int64_t krow = (int64_t)p.kv * p.d;  // seq stride of dK, dV
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= p.s) continue;
    const int64_t at = (int64_t)b * p.s * krow + (int64_t)kpos * krow + (int64_t)hk * p.d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.d) {
        dk[at + d] = from_f<T>(gk[i][j] * p.scale);
        dv[at + d] = from_f<T>(gv[i][j]);
      }
    }
  }
}

template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((Tiles<DMAX>::BQ + 2 * Tiles<DMAX>::BK) * (DMAX + 1) +
                          Tiles<DMAX>::BQ * (Tiles<DMAX>::BK + 1));
}
template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * Tiles<DMAX>::BQ + 2 * Tiles<DMAX>::BK) * (DMAX + 1) +
                          Tiles<DMAX>::BQ * (Tiles<DMAX>::BK + 1));
}
template <int DMAX>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((2 * Tiles<DMAX>::BQ + 2 * Tiles<DMAX>::BK) * (DMAX + 1) +
                          2 * Tiles<DMAX>::BQ * (Tiles<DMAX>::BK + 1) + 2 * Tiles<DMAX>::BQ);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DMAX>
cudaError_t forward(const Params& p, const T* q, const T* k, const T* v, T* o, float* lse,
                    cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<DMAX>();
  cudaError_t err = prepare(fwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + Tiles<DMAX>::BQ - 1) / Tiles<DMAX>::BQ, p.h, p.b);
  fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t backward(const Params& p, const T* q, const T* k, const T* v, const T* o,
                     const T* dout, const float* lse, float* delta, T* dq, T* dk, T* dv,
                     cudaStream_t stream) {
  constexpr size_t smem_q = dq_smem<DMAX>(), smem_kv = dkdv_smem<DMAX>();
  cudaError_t err = prepare(dq_kernel<T, DMAX>, smem_q);
  if (err != cudaSuccess) return err;
  err = prepare(dkdv_kernel<T, DMAX>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.s + Tiles<DMAX>::BQ - 1) / Tiles<DMAX>::BQ, p.h, p.b);
  dq_kernel<T, DMAX><<<grid_q, kThreads, smem_q, stream>>>(q, k, v, o, dout, lse, delta, dq, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.s + Tiles<DMAX>::BK - 1) / Tiles<DMAX>::BK, p.kv, p.b);
  dkdv_kernel<T, DMAX><<<grid_kv, kThreads, smem_kv, stream>>>(q, k, v, dout, lse, delta, dk,
                                                               dv, p);
  return cudaGetLastError();
}

bool make_params(const int64_t* dims, const int64_t* strides, int window, int is_global,
                 Params* p) {
  p->b = (int)dims[0];
  p->s = (int)dims[1];
  p->h = (int)dims[2];
  p->kv = (int)dims[3];
  p->d = (int)dims[4];
  for (int i = 0; i < 4; ++i) {
    p->q[i] = strides[i];
    p->k[i] = strides[4 + i];
    p->v[i] = strides[8 + i];
  }
  p->window = window;
  p->is_global = is_global;
  p->scale = 1.0f / sqrtf((float)p->d);
  return p->b > 0 && p->s > 0 && p->kv > 0 && p->h % p->kv == 0 && p->d > 0 && p->d <= 256 &&
         p->b <= 65535 && p->h <= 65535;
}

template <typename T>
cudaError_t forward_any(const Params& p, const void* q, const void* k, const void* v, void* o,
                        float* lse, cudaStream_t st) {
  auto args = [&](auto dmax) {
    constexpr int D = decltype(dmax)::value;
    return forward<T, D>(p, (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, st);
  };
  if (p.d <= 64) return args(std::integral_constant<int, 64>());
  if (p.d <= 96) return args(std::integral_constant<int, 96>());
  if (p.d <= 128) return args(std::integral_constant<int, 128>());
  return args(std::integral_constant<int, 256>());
}

template <typename T>
cudaError_t backward_any(const Params& p, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse, float* delta,
                         void* dq, void* dk, void* dv, cudaStream_t st) {
  auto args = [&](auto dmax) {
    constexpr int D = decltype(dmax)::value;
    return backward<T, D>(p, (const T*)q, (const T*)k, (const T*)v, (const T*)o,
                          (const T*)dout, lse, delta, (T*)dq, (T*)dk, (T*)dv, st);
  };
  if (p.d <= 64) return args(std::integral_constant<int, 64>());
  if (p.d <= 96) return args(std::integral_constant<int, 96>());
  if (p.d <= 128) return args(std::integral_constant<int, 128>());
  return args(std::integral_constant<int, 256>());
}

}  // namespace

// Plain C entry points for ctypes.  `dtype` is 0 for fp32 and 1 for bf16;
// `dims` holds (B, S, H, KV, D) and `strides` the element strides of q, k
// and v over (batch, seq, head, dim), both in host memory.  Pointers are
// device addresses on `device`; O, dO, dQ, dK and dV are contiguous
// (B, S, heads, D); lse and delta are (B, H, S) fp32.  Launches go on
// `stream` and are not synchronised.  Each returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int64_t* dims,
                                   const int64_t* strides, int window, int is_global,
                                   int device, cudaStream_t stream) {
  Params p;
  if (!make_params(dims, strides, window, is_global, &p) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0 ? forward_any<float>(p, q, k, v, o, lse, stream)
                          : forward_any<__nv_bfloat16>(p, q, k, v, o, lse, stream));
}

extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   const int64_t* dims, const int64_t* strides, int window,
                                   int is_global, int device, cudaStream_t stream) {
  Params p;
  if (!make_params(dims, strides, window, is_global, &p) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0
                   ? backward_any<float>(p, q, k, v, o, dout, lse, delta, dq, dk, dv, stream)
                   : backward_any<__nv_bfloat16>(p, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                 stream));
}
