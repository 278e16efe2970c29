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
// Threads.  Four lanes hold one (row b, channel d), four of its N <= 16
// states each (a smaller N is zero-padded), so a warp covers 8 channels and
// a block of 256 threads 64.  Lane l of a warp holds channel l % 8 and states
// [4q, 4q + 4), q = l / 8: each quarter-warp holds one q, so its reads of Bm
// and Cm are one address.  The loop over S replaces the TPU's sequential time
// grid axis.  A sum over N (y, dx, ddt) is each lane's four states in state
// order, then the four lanes in two `__shfl_xor_sync` levels, (q0 + q1) +
// (q2 + q3): the forward reduce-scatters four steps' sums at once, so that
// each lane ends with one step's y, and the backward two steps' dx and ddt
// (the same order, so the same bits, as a sum of one step at a time).  The
// exp is one `ex2.approx.ftz.f32` on dt A', A' = A log2(e) rounded to fp32
// once per state at load time (relative error below 2^-22 a value; the CUDA
// library's precise `expf` spends several instructions around the same
// MUFU.EX2).  tests/test_torch_scan_numerics.py models this arithmetic on the
// CPU.
//
// Staging.  x and dt (and dy in the backward) come through shared memory a
// tile of steps at a time, [steps][64 channels + 32 bytes of pad] in the
// input type, by 16-byte `cp.async` copies when D and every pointer allow
// them (else plain loads), two tiles in a ring, so that the next tile's
// copies are in flight while the current one is scanned.  The outputs y (dx,
// ddt) replace the inputs in the tile as they are consumed and leave it in
// 16-byte stores once it is done.  Bm and Cm, the same for every channel of
// a row, are loaded into registers for the next tile while the current one
// runs and stored as fp32 [steps][16] beside it.  Rows past S and channels
// past D are zero, which keeps a masked lane's state at 0.
//
// Kernels:
//   scan_fwd_kernel   32-step tiles.  When a gradient is wanted it also
//                     writes the state before every kChunk-th step, ckpt (B,
//                     ceil(S / kChunk), D, N) fp32, never the full (B, S, D,
//                     N) state.  On request it writes the state after the
//                     last step, h_fin (B, D, N) fp32, which the TPU kernel
//                     keeps in its VMEM scratch at the last time block: the
//                     Mamba state that a prefill hands to decode.
//   scan_bwd_kernel   the same threads walk the 8-step chunks from the last,
//                     one chunk a tile: recompute the chunk's states from its
//                     checkpoint into registers (8 steps x 4 states, the loop
//                     unrolled; a ragged last chunk takes a predicated copy),
//                     then run the reverse-time recurrence over them.  dBm
//                     and dCm sum over channels: per step each lane
//                     reduce-scatters its 8 values (4 of each) over the warp's
//                     8 channels in 3 shuffle levels, the block's warps are
//                     summed in shared memory in warp order, and every block
//                     writes its partial (ceil(D / 64), B, S, 32): 16.4 MB at
//                     (80, 64, 1600, 16), written once and read once by the
//                     second pass (8.5 MB at 128 channels a block, whose 16
//                     warps the registers allow only once an SM).  da_log and
//                     dd_skip sum over t in registers and are written per
//                     row, (B, D, N) and (B, D).
//   reduce_bc_kernel, reduce_params_kernel
//                     the second pass: sum the partials over channel blocks, and
//                     over the rows of each group, in index order.  No atomics,
//                     so the gradient is the same from run to run.
//
// What bounds it on this card, at the hymba path's (80, 64, 1600, 16) fp32:
// the forward reads x and dt and writes y (12 bytes an element of (b, t, d))
// and takes one exp an element of (b, t, d, n): 131 M exps at the SFU's 16 a
// clock an SM (~4.2e12 a second on 132 SMs) take 0.031 ms, the bytes 0.030
// ms.  With checkpoints it also writes 65.5 MB (twice x), a floor of ~0.05 ms
// for the forward of local SGD that the function itself does not need.  The
// backward moves twice the bytes and takes twice the exps; its bound is the
// bytes (0.050 ms).  What the kernels spend instead: each lane reads 32
// bytes of Bm and Cm a step (a warp 1 KB, 8 cycles of shared memory for 128
// exps, as many as the SFUs take), which with x, dt and the shuffles keeps
// the forward above its SFU time; the backward issues several times the
// forward's instructions a lane a step (the recompute, the reverse
// recurrence, the lane sums and the reduce-scatter) at 128 registers, so 16
// warps an SM.  The time loop is serial per lane, so the card fills only
// when B x D is large: at B = 4 and D = 1600 just 25,600 lanes run.
//
// What paid (chip_smoke.py --scan-baseline on an H100 80GB HBM3 at 700 W,
// kernel-only time at the local-SGD shape, and in the poll, against copies
// of this source with one step undone):
//   exp2 on A'        forward 1.72x, 1.80x; backward 1.28x
//   cp.async staging  forward 1.35x, 1.45x; backward 1.63x
//   four lanes a channel with registers for the chunk, alone (precise exp,
//   plain loads): forward 1.42x but 0.72x in the poll, backward 0.98x,
//   against the one-thread-a-channel kernel it replaced.  With the two
//   above it pays everywhere: 2.74x (forward) and 1.84x (backward) over that
//   kernel, where exp2 in the old layout gives 1.30x and 1.10x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kN = 16;                     // the most states; a smaller N is zero-padded
constexpr int kLanes = 4;                  // lanes a channel
constexpr int kPer = kN / kLanes;          // states a lane
constexpr int kChannels = 64;              // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // forward: steps staged at once
constexpr int kChunk = 8;                  // steps between checkpoints; the backward's tile
// Blocks an SM that the registers must allow: 32 and 16 warps
constexpr int kFwdBlocks = 4, kBwdBlocks = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A tile row of kChannels steps in shared memory, padded by 32 bytes so that
// the rows of four consecutive steps start in different banks.
template <typename T>
constexpr int kRow = kChannels + 32 / (int)sizeof(T);

struct Dims {
  int b, s, d, n, groups, rows_per_group, n_chunks;
  bool st4;  // N % 4 == 0 and the per-state buffers 16-byte aligned: float4 state moves
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Steps [t0, t0 + STEPS) of the block's channels [d0, d0 + kChannels) of a
// (B, S, D) tensor into dst [STEPS][kRow], zero past S and past D.  VEC:
// 16-byte cp.async copies, left in flight for the caller to commit (D is then
// a multiple of the copy's elements, so a copy is all in or all out); else
// plain loads.
template <typename T, int STEPS, bool VEC>
__device__ __forceinline__ void stage_seq(T* dst, const T* src, int64_t row0, int t0, int d0,
                                          const Dims& p) {
  if constexpr (VEC) {
    constexpr int kEl = 16 / sizeof(T), kPerRow = kChannels / kEl;
    for (int e = threadIdx.x; e < STEPS * kPerRow; e += kThreads) {
      const int j = e / kPerRow, c = (e % kPerRow) * kEl;
      const bool ok = t0 + j < p.s && d0 + c < p.d;
      cp_async16(dst + j * kRow<T> + c, ok ? src + (row0 + t0 + j) * p.d + d0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < STEPS * kChannels; e += kThreads) {
      const int j = e / kChannels, c = e % kChannels;
      const bool ok = t0 + j < p.s && d0 + c < p.d;
      dst[j * kRow<T> + c] = ok ? src[(row0 + t0 + j) * p.d + d0 + c] : from_f<T>(0.0f);
    }
  }
}

// The tile src [STEPS][kRow] back to steps [t0, t0 + STEPS), channels
// [d0, d0 + kChannels) of a (B, S, D) tensor, past S and past D skipped:
// 16-byte stores (VEC) or element stores.
template <typename T, int STEPS, bool VEC>
__device__ __forceinline__ void unstage_seq(T* dst, const T* src, int64_t row0, int t0, int d0,
                                            const Dims& p) {
  if constexpr (VEC) {
    constexpr int kEl = 16 / sizeof(T), kPerRow = kChannels / kEl;
    for (int e = threadIdx.x; e < STEPS * kPerRow; e += kThreads) {
      const int j = e / kPerRow, c = (e % kPerRow) * kEl;
      if (t0 + j < p.s && d0 + c < p.d)
        *reinterpret_cast<uint4*>(dst + (row0 + t0 + j) * p.d + d0 + c) =
            *reinterpret_cast<const uint4*>(src + j * kRow<T> + c);
    }
  } else {
    for (int e = threadIdx.x; e < STEPS * kChannels; e += kThreads) {
      const int j = e / kChannels, c = e % kChannels;
      if (t0 + j < p.s && d0 + c < p.d)
        dst[(row0 + t0 + j) * p.d + d0 + c] = src[j * kRow<T> + c];
    }
  }
}

// Bm and Cm of steps [t0, t0 + STEPS) of one row as fp32 [STEPS][kN], zero
// past S and past N: this thread's elements threadIdx.x + i kThreads, loaded
// into registers by load_bc and written to shared memory by store_bc.
__host__ __device__ constexpr int bc_per_thread(int steps) {
  return (steps * kN + kThreads - 1) / kThreads;
}

template <typename T, int STEPS>
__device__ __forceinline__ void load_bc(float (&rb)[bc_per_thread(STEPS)],
                                        float (&rc)[bc_per_thread(STEPS)], const T* bm,
                                        const T* cm, int64_t row0, int t0, const Dims& p) {
#pragma unroll
  for (int i = 0; i < bc_per_thread(STEPS); ++i) {
    const int e = threadIdx.x + i * kThreads, j = e / kN, k = e % kN;
    const bool ok = e < STEPS * kN && t0 + j < p.s && k < p.n;
    const int64_t at = (row0 + t0 + j) * p.n + k;
    rb[i] = ok ? to_f(bm[at]) : 0.0f;
    rc[i] = ok ? to_f(cm[at]) : 0.0f;
  }
}

template <int STEPS>
__device__ __forceinline__ void store_bc(float* sb, float* sc,
                                         const float (&rb)[bc_per_thread(STEPS)],
                                         const float (&rc)[bc_per_thread(STEPS)]) {
#pragma unroll
  for (int i = 0; i < bc_per_thread(STEPS); ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < STEPS * kN) {
      sb[e] = rb[i];
      sc[e] = rc[i];
    }
  }
}

__device__ __forceinline__ void read4(float (&v)[kPer], const float* s) {
  const float4 f = *reinterpret_cast<const float4*>(s);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// This lane's states [k0, k0 + kPer) of a per-state row at `at` (N values);
// with st4, N is a multiple of kPer, so a lane's states are all in or all out.
__device__ __forceinline__ void load_states(float (&v)[kPer], const float* at, int k0,
                                            const Dims& p, bool live) {
  if (p.st4 && (!live || k0 >= p.n)) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = 0.0f;
    return;
  }
  if (p.st4) {
    read4(v, at + k0);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = (live && k0 + i < p.n) ? at[k0 + i] : 0.0f;
}

__device__ __forceinline__ void store_states(float* at, const float (&v)[kPer], int k0,
                                             const Dims& p) {
  if (p.st4) {
    if (k0 < p.n) *reinterpret_cast<float4*>(at + k0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (k0 + i < p.n) at[k0 + i] = v[i];
}

// A = -exp(a_log) of this lane's states; 0 for a masked channel or state.
__device__ __forceinline__ void load_a(float (&a)[kPer], const float* a_log, int g, int d,
                                       int k0, const Dims& p, bool live) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = k0 + i;
    a[i] = (live && k < p.n) ? -expf(a_log[((int64_t)g * p.d + d) * p.n + k]) : 0.0f;
  }
}

// A' = A log2(e), the exp's scale, rounded once.
__device__ __forceinline__ void load_a2(float (&a2)[kPer], const float* a_log, int g, int d,
                                        int k0, const Dims& p, bool live) {
  load_a(a2, a_log, g, d, k0, p, live);
#pragma unroll
  for (int i = 0; i < kPer; ++i) a2[i] = __fmul_rn(a2[i], kLog2e);
}

// One step of this lane's states, h = 2^(dt A') h + (dt x) Bm.
__device__ __forceinline__ void step_states(float (&h)[kPer], const float (&a2)[kPer], float dtt,
                                            float drive, const float (&bv)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    h[i] = __fmaf_rn(ex2(__fmul_rn(dtt, a2[i])), h[i], __fmul_rn(drive, bv[i]));
}

// Lane l of a warp holds states [4q, 4q + 4) of channel 8 warp + c, where
// c = l % 8 and q = l / 8: each quarter of the warp holds one q, so a read of
// Bm or Cm is the same address across it.
__device__ __forceinline__ int lane_channel(int tid) { return tid / 32 * 8 + tid % 8; }
__device__ __forceinline__ int lane_quarter(int tid) { return tid % 32 / 8; }

// Sum over the four lanes of a channel, (q0 + q1) + (q2 + q3) in every lane.
__device__ __forceinline__ float lane_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Four sums over the four lanes of a channel at once, each in lane_sum's
// order: lane q ends with the sum of v[lane_pick(q)], in two shuffle levels
// (a reduce-scatter).  w[4] rides along unsummed: the lane ends with
// w[lane_pick(q)] too.
__device__ __forceinline__ int lane_pick(int q) { return 2 * (q & 1) + (q >> 1); }

__device__ __forceinline__ float lane_scatter4(const float (&v)[4], const float (&w)[4], int q,
                                               float* w_out) {
  const bool up1 = q & 1, up2 = q & 2;
  float keep[2], kw[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = up1 ? v[k] : v[k + 2];
    keep[k] = (up1 ? v[k + 2] : v[k]) + __shfl_xor_sync(0xffffffffu, send, 8);
    kw[k] = up1 ? w[k + 2] : w[k];
  }
  const float send = up2 ? keep[0] : keep[1];
  *w_out = up2 ? kw[1] : kw[0];
  return (up2 ? keep[1] : keep[0]) + __shfl_xor_sync(0xffffffffu, send, 16);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
scan_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a_log,
                const float* __restrict__ d_skip, T* __restrict__ y, float* __restrict__ ckpt,
                float* __restrict__ h_fin, Dims p) {
  // sx holds a tile of x, then, step by step as x is consumed, of y
  __shared__ __align__(16) T sx[2][kTile * kRow<T>], sdt[2][kTile * kRow<T>];
  __shared__ __align__(16) float sb[2][kTile * kN], sc[2][kTile * kN];
  const int ch = lane_channel(threadIdx.x), q = lane_quarter(threadIdx.x), k0 = q * kPer;
  const int d0 = blockIdx.x * kChannels, d = d0 + ch;
  const int b = blockIdx.y, g = b / p.rows_per_group;
  const bool live = d < p.d;
  float a2[kPer], h[kPer];
  load_a2(a2, a_log, g, d, k0, p, live);
#pragma unroll
  for (int i = 0; i < kPer; ++i) h[i] = 0.0f;
  const float dsk = live ? d_skip[(int64_t)g * p.d + d] : 0.0f;
  const int64_t row0 = (int64_t)b * p.s;
  const int n_tiles = (p.s + kTile - 1) / kTile;
  float* ck = ckpt + ((int64_t)b * p.n_chunks * p.d + d) * p.n;  // chunk 0 of this channel
  const int64_t ck_stride = (int64_t)p.d * p.n;

  float rb[bc_per_thread(kTile)], rc[bc_per_thread(kTile)];
  stage_seq<T, kTile, VEC>(sx[0], x, row0, 0, d0, p);
  stage_seq<T, kTile, VEC>(sdt[0], dt, row0, 0, d0, p);
  cp_commit();
  load_bc<T, kTile>(rb, rc, bm, cm, row0, 0, p);
  store_bc<kTile>(sb[0], sc[0], rb, rc);

  for (int i = 0; i < n_tiles; ++i) {
    const int cur = i & 1, t0 = i * kTile, len = min(kTile, p.s - t0);
    cp_wait_all();
    __syncthreads();  // tile i has landed; tile i - 1 is written out
    const bool more = i + 1 < n_tiles;
    if (more) {
      stage_seq<T, kTile, VEC>(sx[cur ^ 1], x, row0, t0 + kTile, d0, p);
      stage_seq<T, kTile, VEC>(sdt[cur ^ 1], dt, row0, t0 + kTile, d0, p);
      cp_commit();
      load_bc<T, kTile>(rb, rc, bm, cm, row0, t0 + kTile, p);
    }
    // One step of this lane's states: returns its part of y_t, and x_t.
    auto advance = [&](int j, float& xt) {
      if (ckpt != nullptr && j % kChunk == 0 && live)  // t0 is a multiple of kChunk
        store_states(ck + (t0 + j) / kChunk * ck_stride, h, k0, p);
      xt = to_f(sx[cur][j * kRow<T> + ch]);
      const float dtt = to_f(sdt[cur][j * kRow<T> + ch]);
      float bv[kPer], cv[kPer];
      read4(bv, &sb[cur][j * kN + k0]);
      read4(cv, &sc[cur][j * kN + k0]);
      step_states(h, a2, dtt, __fmul_rn(dtt, xt), bv);
      float part = __fmul_rn(h[0], cv[0]);
#pragma unroll
      for (int k = 1; k < kPer; ++k) part = __fmaf_rn(h[k], cv[k], part);
      return part;
    };
    // y_t replaces x_t in the tile once every lane of the channel has read it
    // (the shuffles order the reads before the write).
    auto single = [&](int j) {
      float xt;
      const float yt = lane_sum(advance(j, xt));
      if (q == 0) sx[cur][j * kRow<T> + ch] = from_f<T>(__fmaf_rn(dsk, xt, yt));
    };
    auto quad = [&](int j) {  // four steps; lane q writes y of step j + lane_pick(q)
      float part[4], xs[4], xt;
#pragma unroll
      for (int r = 0; r < 4; ++r) part[r] = advance(j + r, xs[r]);
      const float yt = lane_scatter4(part, xs, q, &xt);
      sx[cur][(j + lane_pick(q)) * kRow<T> + ch] = from_f<T>(__fmaf_rn(dsk, xt, yt));
    };
    if (len == kTile) {  // len is the same for the whole block
#pragma unroll
      for (int j = 0; j < kTile; j += 4) quad(j);
    } else {
      int j = 0;
      for (; j + 4 <= len; j += 4) quad(j);
      for (; j < len; ++j) single(j);
    }
    if (more) store_bc<kTile>(sb[cur ^ 1], sc[cur ^ 1], rb, rc);
    __syncthreads();  // the tile of y is complete
    unstage_seq<T, kTile, VEC>(y, sx[cur], row0, t0, d0, p);
  }
  if (h_fin != nullptr && live)  // the state after the last step
    store_states(h_fin + ((int64_t)b * p.d + d) * p.n, h, k0, p);
}

// One butterfly level of the reduce-scatter over a warp's 8 channels: lanes
// l and l ^ W swap the halves of v[0, 2W) that the other keeps, and add.
template <int W>
__device__ __forceinline__ void scatter_level(float (&v)[2 * kPer], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = up ? v[k] : v[k + W];
    const float keep = up ? v[k + W] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// v holds this lane's dBm (v[0, 4)) and dCm (v[4, 8)) terms of its states;
// returns the sum over the warp's 8 channels of v[c], c = lane % 8 this
// lane's channel in the warp.
__device__ __forceinline__ float reduce_scatter8(float (&v)[2 * kPer], int lane) {
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  return v[0];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ a_log,
                const float* __restrict__ d_skip, const float* __restrict__ ckpt,
                const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ ddt,
                float* __restrict__ part_bc, float* __restrict__ part_a,
                float* __restrict__ part_d, Dims p) {
  // sx and sdt hold a chunk of x and dt, then, step by step as they are
  // consumed, of dx and ddt
  __shared__ __align__(16) T sx[2][kChunk * kRow<T>], sdt[2][kChunk * kRow<T>],
      sdy[2][kChunk * kRow<T>];
  __shared__ __align__(16) float sb[2][kChunk * kN], sc[2][kChunk * kN];
  __shared__ float sred[kWarps][kChunk][32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = lane_channel(tid), q = lane_quarter(tid), k0 = q * kPer;
  const int d0 = blockIdx.x * kChannels, d = d0 + ch;
  const int b = blockIdx.y, g = b / p.rows_per_group;
  const bool live = d < p.d;
  // the slot of this lane's reduce-scatter sum in a step's 32 values:
  // dBm of states 0..15, then dCm of states 0..15
  const int wc = lane % 8;
  const int slot = wc < kPer ? k0 + wc : kN + k0 + wc - kPer;
  // du[i] = sum_t dh h_{t-1} abar dt of state k0 + i; da_log is A du
  float a2[kPer], carry[kPer], du[kPer];
  load_a2(a2, a_log, g, d, k0, p, live);
#pragma unroll
  for (int i = 0; i < kPer; ++i) carry[i] = du[i] = 0.0f;
  const float dsk = live ? d_skip[(int64_t)g * p.d + d] : 0.0f;
  float dd = 0.0f;
  const int64_t row0 = (int64_t)b * p.s;
  const int64_t ck_stride = (int64_t)p.d * p.n;
  const float* ck_row = ckpt + ((int64_t)b * p.n_chunks * p.d + d) * p.n;

  float rb[bc_per_thread(kChunk)], rc[bc_per_thread(kChunk)], ck[kPer];
  int c = p.n_chunks - 1;
  stage_seq<T, kChunk, VEC>(sx[0], x, row0, c * kChunk, d0, p);
  stage_seq<T, kChunk, VEC>(sdt[0], dt, row0, c * kChunk, d0, p);
  stage_seq<T, kChunk, VEC>(sdy[0], dy, row0, c * kChunk, d0, p);
  cp_commit();
  load_bc<T, kChunk>(rb, rc, bm, cm, row0, c * kChunk, p);
  store_bc<kChunk>(sb[0], sc[0], rb, rc);
  load_states(ck, ck_row + c * ck_stride, k0, p, live);

  for (int it = 0; c >= 0; ++it, --c) {
    const int cur = it & 1, t0 = c * kChunk, len = min(kChunk, p.s - t0);
    cp_wait_all();
    __syncthreads();  // chunk c has landed; chunk c + 1 is written out
    float h[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) h[i] = ck[i];
    if (c > 0) {
      stage_seq<T, kChunk, VEC>(sx[cur ^ 1], x, row0, t0 - kChunk, d0, p);
      stage_seq<T, kChunk, VEC>(sdt[cur ^ 1], dt, row0, t0 - kChunk, d0, p);
      stage_seq<T, kChunk, VEC>(sdy[cur ^ 1], dy, row0, t0 - kChunk, d0, p);
      cp_commit();
      load_bc<T, kChunk>(rb, rc, bm, cm, row0, t0 - kChunk, p);
      load_states(ck, ck_row + (c - 1) * ck_stride, k0, p, live);
    }
    T* cx = sx[cur];
    T* cdt = sdt[cur];
    const T* cdy = sdy[cur];

    // Recompute the chunk's states from its checkpoint: hs[j] = h_{t0+j-1}.
    float hs[kChunk][kPer];
    auto recompute = [&](int j) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) hs[j][i] = h[i];
      const float dtt = to_f(cdt[j * kRow<T> + ch]);
      float bv[kPer];
      read4(bv, &sb[cur][j * kN + k0]);
      step_states(h, a2, dtt, __fmul_rn(dtt, to_f(cx[j * kRow<T> + ch])), bv);
    };
    // One reverse step: h holds h_t, hs[j] holds h_{t-1}.  With u = dh
    // h_{t-1} abar, ddt = sum_n u A + x sum_n dh Bm, and A = A' ln 2.
    // Returns this lane's parts of dx_t (without d_skip dy_t, returned) and
    // of ddt_t.
    auto back = [&](int j, float& dxp, float& ddtp) {
      const int at = j * kRow<T> + ch;
      const float xt = to_f(cx[at]), dtt = to_f(cdt[at]), dyt = to_f(cdy[at]);
      const float drive = __fmul_rn(dtt, xt);
      float bv[kPer], cv[kPer], v[2 * kPer];
      read4(bv, &sb[cur][j * kN + k0]);
      read4(cv, &sc[cur][j * kN + k0]);
      float dxs = 0.0f, dus = 0.0f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float ab = ex2(__fmul_rn(dtt, a2[i]));
        const float dh = __fmaf_rn(dyt, cv[i], carry[i]);
        const float u = __fmul_rn(__fmul_rn(dh, hs[j][i]), ab);
        v[i] = __fmul_rn(dh, drive);
        v[kPer + i] = __fmul_rn(dyt, h[i]);
        dxs = i == 0 ? __fmul_rn(dh, bv[i]) : __fmaf_rn(dh, bv[i], dxs);
        dus = i == 0 ? __fmul_rn(u, a2[i]) : __fmaf_rn(u, a2[i], dus);
        du[i] = __fmaf_rn(u, dtt, du[i]);
        carry[i] = __fmul_rn(ab, dh);
        h[i] = hs[j][i];
      }
      dxp = __fmul_rn(dxs, dtt);
      ddtp = __fmaf_rn(dus, kLn2, __fmul_rn(xt, dxs));
      dd = __fmaf_rn(dyt, xt, dd);
      sred[warp][j][slot] = reduce_scatter8(v, lane);
      return __fmul_rn(dsk, dyt);
    };
    // dx_t and ddt_t replace x_t and dt_t in the tiles once every lane of the
    // channel has read them (the shuffles order the reads before the write).
    auto single = [&](int j) {
      float dxp, ddtp;
      const float skip = back(j, dxp, ddtp);
      dxp = lane_sum(dxp);
      ddtp = lane_sum(ddtp);
      if (q == 0) {
        cx[j * kRow<T> + ch] = from_f<T>(dxp + skip);
        cdt[j * kRow<T> + ch] = from_f<T>(ddtp);
      }
    };
    auto pair = [&](int j) {  // steps j and j - 1: lane q writes one of dx, ddt of one
      float v[4], w[4], skip;
      w[0] = back(j, v[0], v[1]);
      w[2] = back(j - 1, v[2], v[3]);
      w[1] = w[3] = 0.0f;
      const float z = lane_scatter4(v, w, q, &skip);
      ((q & 2) ? cdt : cx)[(j - (q & 1)) * kRow<T> + ch] = from_f<T>(z + skip);
    };
    if (len == kChunk) {  // len is the same for the whole block
#pragma unroll
      for (int j = 0; j < kChunk; ++j) recompute(j);
#pragma unroll
      for (int j = kChunk - 1; j > 0; j -= 2) pair(j);
    } else {  // the ragged last chunk
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < len) recompute(j);
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j)
        if (j < len) single(j);
    }
    if (c > 0) store_bc<kChunk>(sb[cur ^ 1], sc[cur ^ 1], rb, rc);
    __syncthreads();  // the chunk's dx, ddt and channel sums are complete
    for (int e = tid; e < len * 32; e += kThreads) {
      const int j = e / 32, i = e % 32;
      float s = sred[0][j][i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += sred[w][j][i];
      part_bc[(((int64_t)blockIdx.x * p.b + b) * p.s + t0 + j) * 32 + i] = s;
    }
    unstage_seq<T, kChunk, VEC>(dx, cx, row0, t0, d0, p);
    unstage_seq<T, kChunk, VEC>(ddt, cdt, row0, t0, d0, p);
  }
  if (live) {
    float a[kPer];
    load_a(a, a_log, g, d, k0, p, live);
#pragma unroll
    for (int i = 0; i < kPer; ++i) du[i] = __fmul_rn(a[i], du[i]);
    store_states(part_a + ((int64_t)b * p.d + d) * p.n, du, k0, p);
    if (q == 0) part_d[(int64_t)b * p.d + d] = dd;
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
  p->st4 = false;
  return true;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if ((uintptr_t)q % 16 != 0) return false;
  return true;
}

// 16-byte copies of the (B, S, D) tensors in and out: every row start 16-byte
// aligned.
template <typename T>
bool vec_rows(const Dims& p, std::initializer_list<const void*> ptrs) {
  return (p.d * sizeof(T)) % 16 == 0 && aligned16(ptrs);
}

dim3 scan_grid(const Dims& p) { return dim3((p.d + kChannels - 1) / kChannels, p.b); }

template <typename T>
cudaError_t forward(Dims p, const void* x, const void* dt, const void* bm, const void* cm,
                    const float* a_log, const float* d_skip, void* y, float* ckpt, float* h_fin,
                    cudaStream_t st) {
  p.st4 = p.n % kPer == 0 && aligned16({ckpt, h_fin});
  auto kernel =
      vec_rows<T>(p, {x, dt, y}) ? scan_fwd_kernel<T, true> : scan_fwd_kernel<T, false>;
  kernel<<<scan_grid(p), kThreads, 0, st>>>((const T*)x, (const T*)dt, (const T*)bm,
                                            (const T*)cm, a_log, d_skip, (T*)y, ckpt, h_fin, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(Dims p, const void* x, const void* dt, const void* bm, const void* cm,
                     const float* a_log, const float* d_skip, const float* ckpt,
                     const void* dy, void* dx, void* ddt, void* dbm, void* dcm, float* da_log,
                     float* dd_skip, float* part_bc, float* part_a, float* part_d,
                     cudaStream_t st) {
  p.st4 = p.n % kPer == 0 && aligned16({ckpt, part_a});
  auto kernel =
      vec_rows<T>(p, {x, dt, dy, dx, ddt}) ? scan_bwd_kernel<T, true> : scan_bwd_kernel<T, false>;
  const dim3 grid = scan_grid(p);
  kernel<<<grid, kThreads, 0, st>>>((const T*)x, (const T*)dt, (const T*)bm, (const T*)cm, a_log,
                                    d_skip, ckpt, (const T*)dy, (T*)dx, (T*)ddt, part_bc, part_a,
                                    part_d, p);
  cudaError_t err = cudaGetLastError();
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
extern "C" int mamba_scan_block() { return kChannels; }

// y = scan(x, dt, Bm, Cm, a_log, d_skip); ckpt may be null (no gradient), and
// so may h_fin (B, D, N) fp32, the state after the last step (a decode cache).
extern "C" int mamba_scan_fwd(int dtype, const void* x, const void* dt, const void* bm,
                              const void* cm, const float* a_log, const float* d_skip, void* y,
                              float* ckpt, float* h_fin, const int64_t* dims, int device,
                              cudaStream_t stream) {
  Dims p;
  if (!make_dims(dims, &p) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0
                   ? forward<float>(p, x, dt, bm, cm, a_log, d_skip, y, ckpt, h_fin, stream)
                   : forward<__nv_bfloat16>(p, x, dt, bm, cm, a_log, d_skip, y, ckpt, h_fin,
                                            stream));
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
