// Causal flash attention, forward and backward, on Hopper's tensor cores (sm_90a).
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
//   fwd_kernel   one block per (q-tile of 64, head, batch), 4 warps of 16
//                query rows: S = Q K^T, online softmax, O += P V; writes O, L.
//   dq_kernel    the same grid: delta_i = dO_i . O_i (written out for
//                dkdv_kernel), then over the k-tiles P = exp(scale S - L),
//                dP = dO V^T, dS = P (dP - delta), dQ += scale dS K.
//   dkdv_kernel  one block per (k-tile of 64, kv head, batch), 4 warps of 16
//                key rows: over the G query heads of the group and the
//                q-tiles from the diagonal to the window's end, S^T = K Q^T,
//                dV += P^T dO, dP^T = V dO^T, dK += scale dS^T Q.  A block
//                owns its rows of dK and dV, so there are no atomics and the
//                result is the same bits run to run.
//
// Every product runs on the tensor cores through `mma.sync`, by one template
// instantiated for two MMA atoms (struct Mma below): bf16 inputs as
// m16n8k16 bf16 with fp32 sums; fp32 inputs as 3xTF32 on m16n8k8 (each
// operand split as x = big + small, big = tf32(x), small = x - big, of which
// the tensor core reads the top 10 mantissa bits, and a b summed as
// small.big + big.small + big.big), which keeps close to
// fp32 accuracy: the fp32 path must match the JAX package, which multiplies
// in full fp32, and plain TF32 (10 mantissa bits) would not.  The running
// max, denominator, accumulators and L are fp32; O and the gradients are
// written in the input type.  The softmax probabilities P (and dS) become
// the A operand of the next product in registers: for bf16 the m16n8 C
// fragment is the m16n8k16 A fragment (the FA2 trick); for tf32 it is not,
// so the contraction index is permuted (A column t <-> key 2t, t + 4 <->
// 2t + 1) and the B operand read in the same permuted order, which needs
// no shuffle.
//
// What bounds it on this card: at the main path's S = 64 one (b, h) block
// does ~1.3 MFLOP against ~80 KB of q, k, v and O (~16 FLOP a byte), so it
// is bound by bytes (3.35 TB/s); at S = 2048 by operations, against 989
// TFLOP/s for bf16 and 495/3 = 165 TFLOP/s for 3xTF32.
//
// Tiles and loads.  q, k and v are read in place through their element
// strides (unit stride on D; no transpose, no GQA repeat); O, dO, dQ, dK and
// dV are contiguous in the model layout.  Tiles are copied global -> shared
// by `cp.async`: 16-byte copies when every row start is 16-byte aligned,
// else 4-byte copies (fp32, or bf16 pairs when rows are 4-byte aligned), else
// (bf16 at odd offsets) element copies; the entry point picks the mode from
// the pointers and strides at run time.  Rows past S and columns past D are
// zero-filled (src-size 0), and D is padded in shared memory only to the MMA
// depth, DP = D rounded up to 16 (bf16) or 8 (tf32), so D = 80 stays 80.
// Rows sit in shared memory with a 16-byte pad, which makes both the
// `ldmatrix` reads (bf16) and the fragment reads (tf32) free of bank
// conflicts.  The k-tiles (forward, dQ) or (head, q-tile) items (dK/dV)
// run through a two-stage ring: the next tile's copies are in flight while
// the current one is multiplied (one stage when the block has one tile, or
// when two stages would leave room for only one block an SM).
//
// Templates over DMAX in {64, 80, 128, 256} (80 is stablelm's head width)
// size the register tiles.  Products over D stop at DP at run time; products
// into D run over all their columns with no branch between 8-column tiles
// (a branch per tile would serialise their MMAs) and drop the columns past
// D.  A warp's 16 rows hold COLS / 2 fp32 accumulators a thread for O or dQ
// and COLS for dK with dV, where a block computes COLS of the DMAX output
// columns and DMAX / COLS blocks share a tile, each recomputing its scores:
//   fwd   COLS = DMAX, but 128 at fp32 DMAX 256; 64-key tiles, 32 at 256;
//   dQ    COLS = DMAX; 64-key tiles up to DMAX 80 (128 in bf16), else 32;
//   dK/dV COLS = DMAX up to 80 (128 in bf16), else 64 (128 in bf16);
//         32-query tiles in fp32, 64 in bf16 up to DMAX 80.
// So that no template holds more than 255 registers a thread: none spills
// (python3 -m repro_torch.kernels.build) but the bf16 dQ kernel at DMAX 80, where ptxas
// keeps to 168 registers for 3 blocks an SM and spills one (4 bytes);
// `__launch_bounds__(kThreads, 1)` removes that spill and slows it ~8 %.

// Later work: `wgmma` fed by TMA with warp specialisation (bf16 at long S,
// where the tensor-core rate, not bytes, is the bound), and one block
// serving all G query heads of a kv head at small S (k and v read once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;            // q rows (fwd, dQ) or k rows (dK/dV) a block
constexpr size_t kMaxSmem = 232448;           // shared memory a block may use
constexpr size_t kSmemPerSm = 233472;         // an SM's, 1 KB of it reserved a block

enum LoadMode { kElem = 0, kVec4 = 1, kVec16 = 2 };

struct Params {
  int b, s, h, kv, d;
  int dp;                    // D padded to the MMA depth
  int64_t q[4], k[4], v[4];  // element strides over (batch, seq, head, dim)
  int window;                // > 0 with is_global == 0: sliding window
  int is_global;
  float scale;
  int mode;                  // LoadMode
  int stages;                // 1 or 2
};

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices at (row0 + {0, 8}, col0 + {0, 8}) of a row-major
// shared tile with row stride `ld` elements: lane l gives the address of row
// (l & 7) of matrix l >> 3, in the order (0, 0), (8, 0), (0, 8), (8, 8).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                        int row0, int col0) {
  const int l = threadIdx.x & 31;
  const __nv_bfloat16* p = base + (row0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + col0 + (l >> 4) * 8;
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = big + small: big is x rounded to TF32 (to nearest on the low 13
// mantissa bits, ties away, as `cvt.rna.tf32.f32` rounds, but in two integer
// operations where the conversion takes the slow pipe); small = x - big is
// exact in fp32 and goes to the tensor core as it is, which reads its top 10
// mantissa bits (a further error below 2^-21 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a b with a = ab + as, b = bb + bs, dropping as.bs.  With
// FRESH the three products are summed into a zero fragment that is then
// added to c in fp32: the tensor core's own fp32 accumulation does not round
// to nearest, and over the thousands of steps of a long sum (dK and dV at
// S = 2048) its bias into a large c grows past the fp32 tolerance.  The
// products over D (at most 32 steps) accumulate in place.
template <bool FRESH>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  if (FRESH) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, as, bb0, bb1);
    mma_tf32(d, ab, bs0, bs1);
    mma_tf32(d, ab, bb0, bb1);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += d[i];
  } else {
    mma_tf32(c, as, bb0, bb1);
    mma_tf32(c, ab, bs0, bs1);
    mma_tf32(c, ab, bb0, bb1);
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ tiles and loads

// Tile shapes by input type and DMAX.  A block computes COLS of the DMAX
// output columns (O in the forward, dK and dV in the dK/dV kernel); where
// COLS < DMAX, DMAX / COLS blocks share a tile and each recomputes its
// scores, so that a thread's accumulators fit in registers without spills.
template <typename T, int DMAX> struct Tiles {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BK = DMAX <= 128 ? 64 : 32;                         // forward keys
  static constexpr int BKQ = DMAX <= 80 || (DMAX <= 128 && !kF32) ? 64 : 32;  // dQ keys
  static constexpr int BQ2 = kF32 ? 32 : DMAX <= 80 ? 64 : 32;             // dK/dV queries
  static constexpr int FCOLS = kF32 && DMAX > 128 ? 128 : DMAX;            // forward columns
  static constexpr int KCOLS = kF32 && DMAX > 80 ? 64 : DMAX > 128 ? 128 : DMAX;  // dK/dV
  static constexpr int DT = DMAX / 8;  // 8-wide column tiles of dQ
};

// Row stride of a shared tile: DP plus a 16-byte pad.  For bf16 that is an
// odd multiple of 16 bytes, so the 8 rows an `ldmatrix` reads fall in 8
// distinct 16-byte bank groups; for fp32 it is 4 x an odd number of words,
// so the tf32 fragment reads (rows g, columns t; or rows 2t, columns g) hit
// 32 distinct banks.
template <typename T>
__host__ __device__ __forceinline__ int tile_ld(int dp) { return dp + 16 / (int)sizeof(T); }

// Rows [r0, r0 + R) of one head (row stride ss elements, unit stride on D)
// into a shared tile with row stride ld, out to DP columns, zero past S and
// past D.  cp.async copies are left in flight for the caller to commit.
template <typename T, int R>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int64_t ss, int r0,
                                          const Params& p) {
  if (p.mode == kVec16 || p.mode == kVec4) {
    const int ce = (p.mode == kVec16 ? 16 : 4) / (int)sizeof(T);  // elements a copy
    const int nch = p.dp / ce;
    for (int e = threadIdx.x; e < R * nch; e += kThreads) {
      const int r = e / nch, c = (e - r * nch) * ce;
      const int valid = r0 + r < p.s ? max(0, min(ce, p.d - c)) : 0;
      const T* g = valid ? src + (int64_t)(r0 + r) * ss + c : src;
      if (p.mode == kVec16)
        cp_async16(dst + r * ld + c, g, valid * (int)sizeof(T));
      else
        cp_async4(dst + r * ld + c, g, valid * (int)sizeof(T));
    }
  } else {  // bf16 rows that are not 4-byte aligned: element copies
    for (int e = threadIdx.x; e < R * p.dp; e += kThreads) {
      const int r = e / p.dp, c = e - r * p.dp;
      const bool in = r0 + r < p.s && c < p.d;
      dst[r * ld + c] = in ? src[(int64_t)(r0 + r) * ss + c] : from_f<T>(0.0f);
    }
  }
}

// Entries [r0, r0 + R) of a (S,) fp32 row of L or delta, zero past S.
template <int R>
__device__ __forceinline__ void load_stats(float* dst, const float* src, int r0, int s) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool in = r0 + i < s;
    cp_async4(dst + i, in ? src + r0 + i : src, in ? 4 : 0);
  }
}

// ------------------------------------------------------------ MMA policies
//
// abt: c (16 x 8 NT) += A B^T, A the warp's 16 rows of a shared tile, B the
//      first 8 NT rows of another, both contracted over their first DP
//      columns (Q K^T, dO V^T, K Q^T, V dO^T).
// pb:  acc (16 x 8 DT) += P B, P a 16 x 8 NK block held as m16n8 C
//      fragments, B the first 8 NK rows of a shared tile (P V, dS K, P^T dO,
//      dS^T Q).  All DMAX columns are computed, with no branch between the
//      tiles; those past DP read into the next row (or the slack at the end
//      of the block's shared memory) and are never written out.
// Fragment layouts (PTX ISA, mma.m16n8k*): lane = 4 g + t; C holds rows g
// and g + 8, columns 2t and 2t + 1.

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kDepth = 16;

  template <int NT>
  static __device__ __forceinline__ void abt(float (&c)[NT][4], const T* sa, const T* sb, int ld,
                                             int dp) {
    static_assert(NT % 2 == 0, "n-tiles go in pairs");
#pragma unroll 2
    for (int k0 = 0; k0 < dp; k0 += 16) {
      uint32_t a[4];
      ldsm_x4<false>(a, sa, ld, 0, k0);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];  // rows 8j.. and 8j + 8.. of B, depth k0 + {0, 8}
        ldsm_x4<false>(b, sb, ld, j * 8, k0);
        mma_bf16(c[j], a, b[0], b[2]);
        mma_bf16(c[j + 1], a, b[1], b[3]);
      }
    }
  }

  template <int NK, int DT>
  static __device__ __forceinline__ void pb(float (&acc)[DT][4], const float (&pf)[NK][4],
                                            const T* sb, int ld) {
    static_assert(NK % 2 == 0 && DT % 2 == 0, "tiles go in pairs");
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      // the C fragments of columns 16 kk.. and 16 kk + 8.. are the A fragment
      const uint32_t a[4] = {pack_bf16(pf[2 * kk][0], pf[2 * kk][1]),
                             pack_bf16(pf[2 * kk][2], pf[2 * kk][3]),
                             pack_bf16(pf[2 * kk + 1][0], pf[2 * kk + 1][1]),
                             pack_bf16(pf[2 * kk + 1][2], pf[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t b[4];  // B rows 16 kk.., columns 8 dt.. and 8 dt + 8.., transposed
        ldsm_x4<true>(b, sb, ld, kk * 16, dt * 8);
        mma_bf16(acc[dt], a, b[0], b[1]);
        mma_bf16(acc[dt + 1], a, b[2], b[3]);
      }
    }
  }
};

template <> struct Mma<float> {
  using T = float;
  static constexpr int kDepth = 8;

  template <int NT>
  static __device__ __forceinline__ void abt(float (&c)[NT][4], const T* sa, const T* sb, int ld,
                                             int dp) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll 2
    for (int k = t; k < dp; k += 8) {
      uint32_t ab[4], as[4];
      split_tf32(sa[g * ld + k], ab[0], as[0]);
      split_tf32(sa[(g + 8) * ld + k], ab[1], as[1]);
      split_tf32(sa[g * ld + k + 4], ab[2], as[2]);
      split_tf32(sa[(g + 8) * ld + k + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* row = sb + (j * 8 + g) * ld + k;
        mma_3xtf32<false>(c[j], ab, as, row[0], row[4]);
      }
    }
  }

  template <int NK, int DT>
  static __device__ __forceinline__ void pb(float (&acc)[DT][4], const float (&pf)[NK][4],
                                            const T* sb, int ld) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      // The m16n8 C fragment is not the m16n8k8 A fragment, so the
      // contraction is permuted: A column t <-> key 8j + 2t and column t + 4
      // <-> key 8j + 2t + 1, and B is read in the same order.
      uint32_t ab[4], as[4];
      split_tf32(pf[j][0], ab[0], as[0]);
      split_tf32(pf[j][2], ab[1], as[1]);
      split_tf32(pf[j][1], ab[2], as[2]);
      split_tf32(pf[j][3], ab[3], as[3]);
      const T* rows = sb + (j * 8 + 2 * t) * ld + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        mma_3xtf32<true>(acc[dt], ab, as, rows[dt * 8], rows[ld + dt * 8]);
    }
  }
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const Params& p, bool windowed) {
  return kpos <= qpos && qpos < p.s && (!windowed || qpos - kpos < p.window);
}

// First and last k-tile that query rows [q0, q0 + kRows) see.
template <int BK>
__device__ __forceinline__ void k_range(int q0, const Params& p, bool windowed, int* lo, int* hi) {
  *hi = (min(q0 + kRows, p.s) - 1) / BK;
  *lo = windowed ? max(0, q0 - p.window + 1) / BK : 0;
}

// Whether every (query, key) pair of rows [q0, q0 + nq) and keys
// [k0, k0 + nk) is visible, so that the tile needs no mask.
__device__ __forceinline__ bool tile_visible(int q0, int nq, int k0, int nk, const Params& p,
                                             bool windowed) {
  return k0 + nk - 1 <= q0 && q0 + nq <= p.s && (!windowed || q0 + nq - 1 - k0 < p.window);
}

// ------------------------------------------------------------------- forward

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Params p) {
  using M = Mma<T>;
  constexpr int BK = Tiles<T, DMAX>::BK, NT = BK / 8, COLS = Tiles<T, DMAX>::FCOLS;
  constexpr int NCOL = DMAX / COLS, DT = COLS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(p.dp);
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* skv = sq + kRows * ld;  // stage st: K at skv + 2 st BK ld, V after it

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = blockIdx.x / NCOL * kRows, c0 = blockIdx.x % NCOL * COLS;  // rows, O columns
  const int h = blockIdx.y, b = blockIdx.z;
  if (c0 >= p.d) return;
  const int hk = h / (p.h / p.kv);
  const bool windowed = p.window > 0 && !p.is_global;
  const T* kb = k + b * p.k[0] + hk * p.k[2];
  const T* vb = v + b * p.v[0] + hk * p.v[2];
  auto issue = [&](int kt, int st) {
    T* sk = skv + 2 * st * BK * ld;
    load_tile<T, BK>(sk, ld, kb, p.k[1], kt * BK, p);
    load_tile<T, BK>(sk + BK * ld, ld, vb, p.v[1], kt * BK, p);
    cp_commit();
  };

  int kt_lo, kt_hi;
  k_range<BK>(q0, p, windowed, &kt_lo, &kt_hi);
  load_tile<T, kRows>(sq, ld, q + b * p.q[0] + h * p.q[2], p.q[1], q0, p);
  issue(kt_lo, 0);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's two query rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    cp_wait<0>();
    __syncthreads();  // this tile is in; every warp is done with the other stage
    const int st = p.stages == 2 ? (kt - kt_lo) & 1 : 0;
    if (p.stages == 2 && kt < kt_hi) issue(kt + 1, st ^ 1);
    const T* sk = skv + 2 * st * BK * ld;
    const T* sv = sk + BK * ld;
    const int k0 = kt * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    M::template abt<NT>(s, sq + warp * 16 * ld, sk, ld, p.dp);

    const bool full = tile_visible(q0, kRows, k0, BK, p, windowed);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool in = full || visible(e < 2 ? ra : rb, kpos, p, windowed);
        s[j][e] = in ? s[j][e] * p.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;  // a row with nothing visible yet
      corr[r] = expf(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= corr[r];  // this thread's part of the row sum; the quad adds at the end
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_use[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
    M::template pb<NT, DT>(acc, s, sv + c0, ld);

    if (p.stages == 1 && kt < kt_hi) {
      __syncthreads();
      issue(kt + 1, 0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r ? rb : ra;
    const float lsum = quad_sum(l[r]);
    if (qpos >= p.s) continue;
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
    T* orow = o + (((int64_t)b * p.s + qpos) * p.h + h) * p.d;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = c0 + dt * 8 + 2 * t;
      if (d < p.d) orow[d] = from_f<T>(acc[dt][2 * r] * inv);
      if (d + 1 < p.d) orow[d + 1] = from_f<T>(acc[dt][2 * r + 1] * inv);
    }
    if (t == 0 && c0 == 0) lse[((int64_t)b * p.h + h) * p.s + qpos] = m[r] + logf(lsum);
  }
}

// ------------------------------------------------------------------------ dQ

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, Params p) {
  using M = Mma<T>;
  constexpr int BK = Tiles<T, DMAX>::BKQ, NT = BK / 8, DT = Tiles<T, DMAX>::DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(p.dp);
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + kRows * ld;
  T* skv = sdo + kRows * ld;  // stage st: K at skv + 2 st BK ld, V after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.h / p.kv);
  const bool windowed = p.window > 0 && !p.is_global;
  const int64_t row = (int64_t)p.h * p.d;  // seq stride of O, dO, dQ
  const int64_t head0 = (int64_t)b * p.s * row + (int64_t)h * p.d;
  const int64_t stat0 = ((int64_t)b * p.h + h) * p.s;
  const T* kb = k + b * p.k[0] + hk * p.k[2];
  const T* vb = v + b * p.v[0] + hk * p.v[2];
  auto issue = [&](int kt, int st) {
    T* sk = skv + 2 * st * BK * ld;
    load_tile<T, BK>(sk, ld, kb, p.k[1], kt * BK, p);
    load_tile<T, BK>(sk + BK * ld, ld, vb, p.v[1], kt * BK, p);
    cp_commit();
  };

  int kt_lo, kt_hi;
  k_range<BK>(q0, p, windowed, &kt_lo, &kt_hi);
  load_tile<T, kRows>(sq, ld, q + b * p.q[0] + h * p.q[2], p.q[1], q0, p);
  load_tile<T, kRows>(sdo, ld, dout + head0, row, q0, p);
  issue(kt_lo, 0);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's two query rows
  const float L[2] = {ra < p.s ? lse[stat0 + ra] : 0.0f, rb < p.s ? lse[stat0 + rb] : 0.0f};

  // delta = rowsum(dO * O), each thread over the columns it would hold of a
  // C fragment (dO from the shared tile, O from global), then across its
  // quad; in a fixed order, so the same bits every run
  cp_wait<0>();
  __syncthreads();
  float dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r ? rb : ra;
    const T* srow = sdo + (qpos - q0) * ld;
    const T* orow = o + head0 + (int64_t)min(qpos, p.s - 1) * row;
    float part = 0.0f;
    for (int d = 2 * t; d < p.d; d += 8) {
      part = fmaf(to_f(srow[d]), to_f(orow[d]), part);
      if (d + 1 < p.d) part = fmaf(to_f(srow[d + 1]), to_f(orow[d + 1]), part);
    }
    dl[r] = quad_sum(part);
    if (t == 0 && qpos < p.s) delta[stat0 + qpos] = dl[r];
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    cp_wait<0>();
    __syncthreads();
    const int st = p.stages == 2 ? (kt - kt_lo) & 1 : 0;
    if (p.stages == 2 && kt < kt_hi) issue(kt + 1, st ^ 1);
    const T* sk = skv + 2 * st * BK * ld;
    const T* sv = sk + BK * ld;
    const int k0 = kt * BK;

    float s[NT][4], dpm[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dpm[j][e] = 0.0f;
    M::template abt<NT>(s, sq + warp * 16 * ld, sk, ld, p.dp);
    M::template abt<NT>(dpm, sdo + warp * 16 * ld, sv, ld, p.dp);

    const bool full = tile_visible(q0, kRows, k0, BK, p, windowed);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const bool in = full || visible(e < 2 ? ra : rb, kpos, p, windowed);
        const float pr = in ? expf(s[j][e] * p.scale - L[e >> 1]) : 0.0f;
        s[j][e] = pr * (dpm[j][e] - dl[e >> 1]);  // dS
      }
    M::template pb<NT, DT>(acc, s, sk, ld);

    if (p.stages == 1 && kt < kt_hi) {
      __syncthreads();
      issue(kt + 1, 0);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r ? rb : ra;
    if (qpos >= p.s) continue;
    T* grow = dq + head0 + (int64_t)qpos * row;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (d < p.d) grow[d] = from_f<T>(acc[dt][2 * r] * p.scale);
      if (d + 1 < p.d) grow[d + 1] = from_f<T>(acc[dt][2 * r + 1] * p.scale);
    }
  }
}

// --------------------------------------------------------------------- dK/dV
//
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Params p) {
  using M = Mma<T>;
  constexpr int BQ = Tiles<T, DMAX>::BQ2, NQ = BQ / 8, COLS = Tiles<T, DMAX>::KCOLS;
  constexpr int NCOL = DMAX / COLS, DT = COLS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(p.dp);
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kRows * ld;
  T* sqd = sv + kRows * ld;  // stage st: Q at sqd + 2 st BQ ld, dO after it
  float* sstat = reinterpret_cast<float*>(sqd + 2 * p.stages * BQ * ld);  // stage st: L, delta

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int k0 = blockIdx.x / NCOL * kRows, c0 = blockIdx.x % NCOL * COLS;  // rows, columns
  const int hk = blockIdx.y, b = blockIdx.z;
  if (c0 >= p.d) return;
  const int group = p.h / p.kv;
  const bool windowed = p.window > 0 && !p.is_global;
  const int64_t row = (int64_t)p.h * p.d;  // seq stride of dO

  // q-tiles that see keys [k0, k0 + kRows): from the diagonal to the end, or
  // to the window's reach; the block walks (query head, q-tile) items.
  const int qt_lo = k0 / BQ;
  int qt_hi = (p.s - 1) / BQ;
  if (windowed) qt_hi = min(qt_hi, (min(k0 + kRows, p.s) - 1 + p.window - 1) / BQ);
  const int nqt = qt_hi - qt_lo + 1, items = group * nqt;
  auto issue = [&](int it, int st) {
    const int hq = hk * group + it / nqt, q0 = (qt_lo + it % nqt) * BQ;
    T* sq = sqd + 2 * st * BQ * ld;
    const int64_t stat0 = ((int64_t)b * p.h + hq) * p.s;
    load_tile<T, BQ>(sq, ld, q + b * p.q[0] + hq * p.q[2], p.q[1], q0, p);
    load_tile<T, BQ>(sq + BQ * ld, ld, dout + (int64_t)b * p.s * row + (int64_t)hq * p.d, row,
                     q0, p);
    load_stats<BQ>(sstat + 2 * st * BQ, lse + stat0, q0, p.s);
    load_stats<BQ>(sstat + 2 * st * BQ + BQ, delta + stat0, q0, p.s);
    cp_commit();
  };

  load_tile<T, kRows>(sk, ld, k + b * p.k[0] + hk * p.k[2], p.k[1], k0, p);
  load_tile<T, kRows>(sv, ld, v + b * p.v[0] + hk * p.v[2], p.v[1], k0, p);
  issue(0, 0);

  const int ka = k0 + warp * 16 + g, kb = ka + 8;  // this thread's two key rows
  float gv[DT][4], gk[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[dt][e] = gk[dt][e] = 0.0f;

  for (int it = 0; it < items; ++it) {
    cp_wait<0>();
    __syncthreads();
    const int st = p.stages == 2 ? it & 1 : 0;
    if (p.stages == 2 && it + 1 < items) issue(it + 1, st ^ 1);
    const T* sq = sqd + 2 * st * BQ * ld;
    const T* sdo = sq + BQ * ld;
    const float* sl = sstat + 2 * st * BQ;
    const float* sdl = sl + BQ;
    const int q0 = (qt_lo + it % nqt) * BQ;

    float s[NQ][4];  // S^T, then P^T
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    M::template abt<NQ>(s, sk + warp * 16 * ld, sq, ld, p.dp);
    const bool full = tile_visible(q0, BQ, k0, kRows, p, windowed);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const bool in = full || visible(q0 + c, e < 2 ? ka : kb, p, windowed);
        s[j][e] = in ? expf(s[j][e] * p.scale - sl[c]) : 0.0f;
      }
    M::template pb<NQ, DT>(gv, s, sdo + c0, ld);
    {
      float dpt[NQ][4];  // dP^T, then dS^T
#pragma unroll
      for (int j = 0; j < NQ; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.0f;
      M::template abt<NQ>(dpt, sv + warp * 16 * ld, sdo, ld, p.dp);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[j][e] = s[j][e] * (dpt[j][e] - sdl[j * 8 + 2 * t + (e & 1)]);
      M::template pb<NQ, DT>(gk, dpt, sq + c0, ld);
    }

    if (p.stages == 1 && it + 1 < items) {
      __syncthreads();
      issue(it + 1, 0);
    }
  }

  const int64_t krow = (int64_t)p.kv * p.d;  // seq stride of dK, dV
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r ? kb : ka;
    if (kpos >= p.s) continue;
    const int64_t at = ((int64_t)b * p.s + kpos) * krow + (int64_t)hk * p.d;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = c0 + dt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (d + e >= p.d) continue;
        dv[at + d + e] = from_f<T>(gv[dt][2 * r + e]);
        dk[at + d + e] = from_f<T>(gk[dt][2 * r + e] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------- launching

template <typename T>
size_t tile_bytes(const Params& p, int rows) {
  return (size_t)rows * tile_ld<T>(p.dp) * sizeof(T);
}

// Slack after a block's tiles: `pb` reads all DMAX columns of its last row.
template <typename T, int DMAX>
constexpr size_t slack() { return DMAX * sizeof(T); }

// Two stages when the block has more than one tile and two blocks of two
// stages still fit on an SM: one resident block of 4 warps hides too little
// latency for its prefetch to pay (fp32 at D = 128, or dQ at D = 80).
int pick_stages(bool many, size_t two) { return many && 2 * (two + 1024) <= kSmemPerSm ? 2 : 1; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DMAX>
cudaError_t forward(Params p, const T* q, const T* k, const T* v, T* o, float* lse,
                    cudaStream_t stream) {
  constexpr int BK = Tiles<T, DMAX>::BK;
  const size_t base = tile_bytes<T>(p, kRows), stage = 2 * tile_bytes<T>(p, BK);
  p.stages = pick_stages(p.s > BK, base + 2 * stage + slack<T, DMAX>());
  const size_t smem = base + p.stages * stage + slack<T, DMAX>();
  cudaError_t err = prepare(fwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + kRows - 1) / kRows * (DMAX / Tiles<T, DMAX>::FCOLS), p.h, p.b);
  fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t backward(Params p, const T* q, const T* k, const T* v, const T* o, const T* dout,
                     const float* lse, float* delta, T* dq, T* dk, T* dv, cudaStream_t stream) {
  constexpr int BK = Tiles<T, DMAX>::BKQ;
  const size_t base = 2 * tile_bytes<T>(p, kRows), stage = 2 * tile_bytes<T>(p, BK);
  Params pq = p;
  pq.stages = pick_stages(p.s > BK, base + 2 * stage + slack<T, DMAX>());
  const size_t smem = base + pq.stages * stage + slack<T, DMAX>();
  cudaError_t err = prepare(dq_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + kRows - 1) / kRows, p.h, p.b);
  dq_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(q, k, v, o, dout, lse, delta, dq, pq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int BQ = Tiles<T, DMAX>::BQ2;
  const size_t kbase = 2 * tile_bytes<T>(p, kRows);
  const size_t kstage = 2 * tile_bytes<T>(p, BQ) + 2 * BQ * sizeof(float);
  p.stages = pick_stages(p.s > BQ || p.h > p.kv, kbase + 2 * kstage + slack<T, DMAX>());
  const size_t ksmem = kbase + p.stages * kstage + slack<T, DMAX>();
  err = prepare(dkdv_kernel<T, DMAX>, ksmem);
  if (err != cudaSuccess) return err;
  const dim3 kgrid((p.s + kRows - 1) / kRows * (DMAX / Tiles<T, DMAX>::KCOLS), p.kv, p.b);
  dkdv_kernel<T, DMAX><<<kgrid, kThreads, ksmem, stream>>>(q, k, v, dout, lse, delta, dk, dv, p);
  return cudaGetLastError();
}

// The widest cp.async copy that every row start of the loaded tensors allows:
// their pointers and their (batch, seq, head) strides in bytes.
template <typename T>
int load_mode(const void* const* ptrs, int n_ptrs, const int64_t* strides, int n_strides, int d) {
  bool a16 = (d * sizeof(T)) % 4 == 0, a4 = (d * sizeof(T)) % 4 == 0;
  for (int i = 0; i < n_ptrs; ++i) {
    a16 = a16 && (uintptr_t)ptrs[i] % 16 == 0;
    a4 = a4 && (uintptr_t)ptrs[i] % 4 == 0;
  }
  for (int i = 0; i < n_strides; ++i) {
    a16 = a16 && (strides[i] * (int64_t)sizeof(T)) % 16 == 0;
    a4 = a4 && (strides[i] * (int64_t)sizeof(T)) % 4 == 0;
  }
  return a16 ? kVec16 : a4 ? kVec4 : kElem;
}

template <typename T>
bool make_params(const int64_t* dims, const int64_t* strides, int window, int is_global,
                 Params* p) {
  p->b = (int)dims[0];
  p->s = (int)dims[1];
  p->h = (int)dims[2];
  p->kv = (int)dims[3];
  p->d = (int)dims[4];
  constexpr int depth = Mma<T>::kDepth;
  p->dp = (p->d + depth - 1) / depth * depth;
  for (int i = 0; i < 4; ++i) {
    p->q[i] = strides[i];
    p->k[i] = strides[4 + i];
    p->v[i] = strides[8 + i];
  }
  p->window = window;
  p->is_global = is_global;
  p->scale = 1.0f / sqrtf((float)p->d);
  p->stages = 1;
  return p->b > 0 && p->s > 0 && p->kv > 0 && p->h % p->kv == 0 && p->d > 0 && p->d <= 256 &&
         p->b <= 65535 && p->h <= 65535 && p->q[3] == 1 && p->k[3] == 1 && p->v[3] == 1;
}

template <typename T>
cudaError_t forward_any(const int64_t* dims, const int64_t* strides, int window, int is_global,
                        const void* q, const void* k, const void* v, void* o, float* lse,
                        cudaStream_t st) {
  Params p;
  if (!make_params<T>(dims, strides, window, is_global, &p)) return cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v};
  const int64_t qkv[] = {p.q[0], p.q[1], p.q[2], p.k[0], p.k[1], p.k[2],
                         p.v[0], p.v[1], p.v[2]};
  p.mode = load_mode<T>(ptrs, 3, qkv, 9, p.d);
  auto run = [&](auto dmax) {
    constexpr int D = decltype(dmax)::value;
    return forward<T, D>(p, (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, st);
  };
  if (p.dp <= 64) return run(std::integral_constant<int, 64>());
  if (p.dp <= 80) return run(std::integral_constant<int, 80>());
  if (p.dp <= 128) return run(std::integral_constant<int, 128>());
  return run(std::integral_constant<int, 256>());
}

template <typename T>
cudaError_t backward_any(const int64_t* dims, const int64_t* strides, int window, int is_global,
                         const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, cudaStream_t st) {
  Params p;
  if (!make_params<T>(dims, strides, window, is_global, &p)) return cudaErrorInvalidValue;
  // O and dO are contiguous (B, S, H, D): their row strides are multiples of D
  const void* ptrs[] = {q, k, v, o, dout};
  const int64_t rows[] = {p.q[0], p.q[1], p.q[2], p.k[0], p.k[1], p.k[2],
                          p.v[0], p.v[1], p.v[2], p.d};
  p.mode = load_mode<T>(ptrs, 5, rows, 10, p.d);
  auto run = [&](auto dmax) {
    constexpr int D = decltype(dmax)::value;
    return backward<T, D>(p, (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
                          lse, delta, (T*)dq, (T*)dk, (T*)dv, st);
  };
  if (p.dp <= 64) return run(std::integral_constant<int, 64>());
  if (p.dp <= 80) return run(std::integral_constant<int, 80>());
  if (p.dp <= 128) return run(std::integral_constant<int, 128>());
  return run(std::integral_constant<int, 256>());
}

}  // namespace

// Plain C entry points for ctypes.  `dtype` is 0 for fp32 and 1 for bf16;
// `dims` holds (B, S, H, KV, D) and `strides` the element strides of q, k
// and v over (batch, seq, head, dim), both in host memory; the stride over
// dim must be 1.  Pointers are device addresses on `device`; O, dO, dQ, dK
// and dV are contiguous (B, S, heads, D); lse and delta are (B, H, S) fp32.
// Launches go on `stream` and are not synchronised.  Each returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a shape or a layout
// the kernels do not take).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int64_t* dims,
                                   const int64_t* strides, int window, int is_global,
                                   int device, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0
                   ? forward_any<float>(dims, strides, window, is_global, q, k, v, o, lse, stream)
                   : forward_any<__nv_bfloat16>(dims, strides, window, is_global, q, k, v, o,
                                                lse, stream));
}

extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   const int64_t* dims, const int64_t* strides, int window,
                                   int is_global, int device, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 0
                   ? backward_any<float>(dims, strides, window, is_global, q, k, v, o, dout, lse,
                                         delta, dq, dk, dv, stream)
                   : backward_any<__nv_bfloat16>(dims, strides, window, is_global, q, k, v, o,
                                                 dout, lse, delta, dq, dk, dv, stream));
}
