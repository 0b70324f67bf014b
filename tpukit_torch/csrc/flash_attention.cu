// Causal flash attention for Hopper (sm_90a): forward, and a backward in
// three kernels (D = rowsum(dO * O), then dK/dV, then dQ).
//
// Replaces the Pallas TPU kernels of tpukit/ops/pallas_attention.py:
//   - `_fwd_kernel` (:178) launched by `_flash_forward` (:215, call :227);
//   - `_bwd_kernel` (:259) launched by `_flash_backward` (:504, call :530),
//     and `_dq_kernel` (:346) / `_dkv_kernel` (:389) launched by
//     `_flash_backward_split` (:437, calls :448, :470). The TPU picks one of
//     the two backwards by the number of key blocks; here one split design
//     covers every length: no S^2-scaled dQ partials and no atomics, so the
//     result does not change from run to run. D = rowsum(dO * O) is tpukit's
//     `dcap` (:290-291), computed by its own small kernel.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [B*H, S, D] row-major in the compute
// dtype T (f32 or bf16); q arrives unscaled with the softmax scale, and each
// kernel computes q_s = round_T(f32(q) * f32(round_T(scale))) where it loads
// q (the bits of the wrapper's `prescale`, as `_fwd4_impl` does at :599);
// `bias` is the [B, S] f32 pad bias (0 or finfo(f32).min per key, or null
// without a pad mask); lse and D are [B*H, S] f32.
//
// Semantics (as `_masked_scores` :126 and the kernels above):
//   s = q_s.k in f32, plus the key's pad bias; keys after the query (j > i)
//   are left out. tpukit selects -1e9 there and gets exp(-1e9 - m) == 0
//   exactly for every row that has an unpadded key, so leaving them out
//   changes no bit; a fully padded query row then attends uniformly over
//   j <= i, the behaviour documented at pallas_attention.py:11-19 (such rows
//   carry ignore targets).
//   Forward: online softmax over key tiles in f32 (m, l), walking key tiles
//   upward from key 0, so the first tile gives every row a finite m; p
//   rounded to T before the P.V product, l summed from the unrounded p;
//   O = acc / l in f32, then rounded; lse = m + log(l).
//   Backward: D = rowsum(f32(dO) * f32(O)); P = exp(s - lse) in f32;
//   dV += P^T dO with P in f32 and dO read as f32; dP = dO V^T in f32;
//   dS = P * (dP - D); dS rounded to T before dK += dS^T q_s and
//   dQ += dS k; dQ times scale (q was prescaled).
//   Any S: rows and keys past S are masked in the kernel.
//
// Bound. At the GPT-2-small training shape (B 64, H 12, S 512, D 64, bf16,
// pad mask) one forward must move q, k, v and O (4 x 50.3 MB), lse and the
// bias: 61 us at 3.35 TB/s, against 4*B*H*D*S(S+1)/2 = 2.58e10 flops, 26 us
// at the bf16 tensor-core peak of 989 TFLOP/s, so bytes bound it; the
// backward moves 7 such tensors and two [B*H, S] rows (106 us) for 2.5x the
// flops (65 us), 3x with the two-term dV below (78 us): bytes bound it too,
// but at mma.sync's reach (about two thirds of the peak) the products come
// close to the bytes.
//
// Design, bf16 (the training path): tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 accumulate), 128-thread blocks of 4 warps, each
// warp owning a 16-row slice of the block's tile. Tiles are bf16 in shared
// memory, filled by 16-byte cp.async with an XOR swizzle of the 16-byte
// chunks (ldmatrix reads 8 rows of one chunk column without a bank
// conflict), double-buffered so the next tile's copy is in flight while the
// current tile's products run (one __syncthreads per tile); operands reach
// registers through ldmatrix (.trans for the operands stored the other way).
// No S x S tensor touches device memory and the probabilities never touch
// shared memory: an m16n8 accumulator pair, rounded and packed, is the A
// fragment of the next product, so P and dS go from the score product to
// the value product in registers; masking and the online softmax run in
// registers, row statistics reduced over a lane quad by shuffles. Each
// block reads its own q (or k/v) tile once, key tiles past the diagonal are
// never loaded, and warps whose rows see none of a tile skip its products.
// On the H100, more resident warps an SM beat more reuse a warp (PERF.md),
// so registers are capped for 3-4 blocks an SM up to D = 64 (kFwdBlocks and
// below); the longest tiles of every head are launched first.
//   - forward: 64 query rows a block, 64-key tiles;
//   - dK/dV: a block holds 64 keys (16 a warp) and walks the query tiles
//     from the diagonal to the end (64 queries, 32 at D = 128); it forms
//     S^T = K Q^T, so P^T and dS^T come out in the A layout of the dV and
//     dK products;
//   - dQ: a block holds 64 queries and walks the key tiles 0 .. diagonal;
//   - D: a warp forms 16 rows' rowsum(dO * O) as the diagonal of dO O^T, by
//     the products that form dP in the dQ kernel, so dP - D cancels exactly
//     where it does in exact arithmetic.
// dV precision: tpukit multiplies P in f32 against dO in f32
// (pallas_attention.py:285,294-299 and :402,411-416). The dK/dV kernel
// splits P into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and accumulates
// P_hi^T dO + P_lo^T dO on the tensor cores: dO is bf16, so both products
// are exact in the f32 accumulator and P is carried to about 2^-16
// relative, tpukit's semantics within f32 summation noise, for one extra
// product a pair. The plain version keeps f32 P.
// Design, f32 (the f32 parity runs): the first version's CUDA-core kernels,
// 256 threads on 64 x 64 f32 tiles; TF32 would change the arithmetic.
// wgmma, TMA and warp specialisation (long S, D = 128) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "tk_mma.cuh"

namespace {

constexpr int kTile = 64;           // query rows and key columns per tile
constexpr int kThreads = 256;       // a 16 x 16 grid: tx = tid % 16, ty = tid / 16
constexpr int kTM = kTile / 16;     // tile rows per thread: ty + 16 * i
constexpr int kTN = kTile / 16;     // tile columns per thread: tx + 16 * j
constexpr int kLP = kTile + 1;      // padded row stride of a [64][64] tile
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T and widen it back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Reductions over the 16 threads that share a tile row: lanes tx and tx ^ o
// (o < 16) sit in the same half-warp and have the same ty.
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + kTile) of a [S, D] slab into a [kTile][D + 1] f32 tile,
// zeros past S, each value times `scale` rounded to T (the q tile's
// prescale, round_T(f32(q) * f32(round_T(scale))); 1 leaves k, v, dO as they
// are).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int S,
                                          float scale = 1.f) {
  const float mul = round_to<T>(scale);
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D, row = r0 + r;
    dst[r * (D + 1) + d] =
        row < S ? round_to<T>(to_f32(src[static_cast<size_t>(row) * D + d]) * mul) : 0.f;
  }
}

// Score of (row, col) after masking: the pad bias added, -inf for a left-out
// entry (a key after the query, or past S).
__device__ __forceinline__ float masked_score(float s, int row, int col, int S,
                                              const float* __restrict__ bias_b) {
  if (col > row || col >= S) return -INFINITY;
  return bias_b != nullptr ? s + bias_b[col] : s;
}

// Grid (ceil(S / 64), B * H), kThreads threads.
// Dynamic shared memory: Q, K, V tiles [64][D + 1] and P [64][65], f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 int H, int S, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DC = (D + 15) / 16;  // output columns per thread: tx + 16 * c
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t slab = static_cast<size_t>(bh) * S * D;
  const float* bias_b = bias != nullptr ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  load_tile<T, D>(Qs, q + slab, q0, S, scale);
  float m[kTM], l[kTM], acc[kTM][DC];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // key tiles 0 .. the one holding the tile's last visible key
  const int num_kt = (min(q0 + kTile, S) - 1) / kTile + 1;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(Ks, k + slab, k0, S);
    load_tile<T, D>(Vs, v + slab, k0, S);
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kTN; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        s[i][j] = masked_score(s[i][j], row, k0 + tx + 16 * j, S, bias_b);
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      tile_max = row_max16(tile_max);
      // finite: key 0 is visible to every row, so tile 0 sets m
      const float m_new = fmaxf(m[i], tile_max);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[r * kLP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P complete

    for (int j = 0; j < kTile; ++j) {
      float pv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) pv[i] = Ps[(ty + 16 * i) * kLP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = Vs[j * LD + d];
#pragma unroll
          for (int i = 0; i < kTM; ++i) acc[i][c] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[slab + static_cast<size_t>(row) * D + d] = from_f32<T>(acc[i][c] / l[i]);
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l[i]);
  }
}

// Scores and dP of one (query tile, key tile) pair, then P and dS into
// shared memory: P in f32 (dV's operand), dS rounded to T. Rows are the
// query rows ty + 16 i, columns the keys tx + 16 j.
template <typename T, int D>
__device__ __forceinline__ void pair_grads(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const float* Ls, const float* Dc,
                                           float* Ps, float* dSs, int q0, int k0, int S,
                                           const float* __restrict__ bias_b) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[kTM][kTN], dp[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[kTM], ov[kTM], kv[kTN], vv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + d];
      ov[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += ov[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + 16 * j;
      float p = 0.f;
      if (row < S) {
        const float x = masked_score(s[i][j], row, k0 + c, S, bias_b);
        p = expf(x - Ls[r]);  // left-out entries: exp(-inf) == 0
      }
      Ps[r * kLP + c] = p;
      dSs[r * kLP + c] = round_to<T>(p * (dp[i][j] - Dc[r]));
    }
  }
}

// per-row lse and D of query tile q0 into shared memory (0 past S)
__device__ __forceinline__ void load_rows(float* Ls, float* Dc, const float* __restrict__ lse,
                                          const float* __restrict__ dcap, int q0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = q0 + r;
    Ls[r] = row < S ? lse[row] : 0.f;
    Dc[r] = row < S ? dcap[row] : 0.f;
  }
}

// dK and dV of one key tile: grid (ceil(S / 64), B * H), kThreads threads;
// loops over the query tiles from the diagonal to the end.
// Dynamic shared memory: K, V, Q, dO tiles [64][D + 1], P and dS [64][65],
// lse and D [64], f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dcap,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int S, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DC = (D + 15) / 16;
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kLP;
  float* Ls = dSs + kTile * kLP;
  float* Dc = Ls + kTile;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t slab = static_cast<size_t>(bh) * S * D;
  const size_t rows = static_cast<size_t>(bh) * S;
  const float* bias_b = bias != nullptr ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  load_tile<T, D>(Ks, k + slab, k0, S);
  load_tile<T, D>(Vs, v + slab, k0, S);
  float dk_acc[kTM][DC], dv_acc[kTM][DC];  // key rows ty + 16 i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int num_qt = (S + kTile - 1) / kTile;
  for (int qt = blockIdx.x; qt < num_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    load_tile<T, D>(Qs, q + slab, q0, S, scale);
    load_tile<T, D>(dOs, dout + slab, q0, S);
    load_rows(Ls, Dc, lse + rows, dcap + rows, q0, S);
    __syncthreads();
    pair_grads<T, D>(Qs, dOs, Ks, Vs, Ls, Dc, Ps, dSs, q0, k0, S, bias_b);
    __syncthreads();
    for (int r = 0; r < kTile; ++r) {
      float pk[kTM], sk[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        pk[i] = Ps[r * kLP + ty + 16 * i];
        sk[i] = dSs[r * kLP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float o = dOs[r * LD + d], qq = Qs[r * LD + d];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            dv_acc[i][c] += pk[i] * o;
            dk_acc[i][c] += sk[i] * qq;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[slab + static_cast<size_t>(row) * D + d] = from_f32<T>(dk_acc[i][c]);
        dv[slab + static_cast<size_t>(row) * D + d] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// dQ of one query tile: grid (ceil(S / 64), B * H), kThreads threads; loops
// over the key tiles from 0 to the diagonal. Same shared memory as dK/dV.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dcap,
                    T* __restrict__ dq, int H, int S, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DC = (D + 15) / 16;
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kLP;
  float* Ls = dSs + kTile * kLP;
  float* Dc = Ls + kTile;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t slab = static_cast<size_t>(bh) * S * D;
  const size_t rows = static_cast<size_t>(bh) * S;
  const float* bias_b = bias != nullptr ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  load_tile<T, D>(Qs, q + slab, q0, S, scale);
  load_tile<T, D>(dOs, dout + slab, q0, S);
  load_rows(Ls, Dc, lse + rows, dcap + rows, q0, S);
  float acc[kTM][DC];  // query rows ty + 16 i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt <= static_cast<int>(blockIdx.x); ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V, P and dS are no longer read
    load_tile<T, D>(Ks, k + slab, k0, S);
    load_tile<T, D>(Vs, v + slab, k0, S);
    __syncthreads();
    pair_grads<T, D>(Qs, dOs, Ks, Vs, Ls, Dc, Ps, dSs, q0, k0, S, bias_b);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float sv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) sv[i] = dSs[(ty + 16 * i) * kLP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float kk = Ks[j * LD + d];
#pragma unroll
          for (int i = 0; i < kTM; ++i) acc[i][c] += sv[i] * kk;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[slab + static_cast<size_t>(row) * D + d] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = 32 * kWarpsTC;
constexpr int kKeysTC = 64;  // rows of a tile: queries or keys, 16 a warp (4 warps)
constexpr int kThreadsPre = 256;

// Element offset of 16-byte chunk `c` of row `r` of a [rows][D] bf16 tile:
// the chunk index is XORed with bits of the row, so the 8 rows one ldmatrix
// matrix reads at one chunk column fall on 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;
  constexpr int kSpan = kChunks >= 8 ? 1 : 8 / kChunks;  // rows that share 128 bytes
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return r * D + ((c ^ ((r / kSpan) & kMask)) << 3);
}

// Rows [r0, r0 + ROWS) of a [S, D] slab into a swizzled tile by cp.async,
// zeros past S. Thread t copies chunks t, t + 128, ...
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src, int r0,
                                                int S) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreadsTC) {
    const int r = e / kChunks, c = e % kChunks, row = r0 + r;
    const bool in = row < S;
    cp_async_16(dst + swz<D>(r, c), src + (in ? static_cast<size_t>(row) * D + c * 8 : 0), in);
  }
}

__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The prescale of a q tile in place, each thread on the chunks it copied
// itself (load_tile_async's assignment): after cp_async_wait they are
// visible to it, and the caller's __syncthreads publishes the result.
template <int D, int ROWS>
__device__ __forceinline__ void prescale_own(bf16* tile, float qscale) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreadsTC) {
    bf16* p = tile + swz<D>(e / kChunks, e % kChunks);
    uint4 w = ld_b128(p);
    w.x = pack_bf16x2(lo_f32(w.x) * qscale, hi_f32(w.x) * qscale);
    w.y = pack_bf16x2(lo_f32(w.y) * qscale, hi_f32(w.y) * qscale);
    w.z = pack_bf16x2(lo_f32(w.z) * qscale, hi_f32(w.z) * qscale);
    w.w = pack_bf16x2(lo_f32(w.w) * qscale, hi_f32(w.w) * qscale);
    st_b128(p, w);
  }
}

// Row addresses of the four ldmatrix matrices (see tk_mma.cuh), for a tile
// of row stride D at rows r0.., columns 16 c0..:
//   a_rows: a 16 x 16 A operand (rows r0 + 0..15, chunks 2 c0, 2 c0 + 1);
//   b_rows: B operands of two n8 tiles from rows stored n-major (rows
//     r0 + 0..15 are n, the 16 columns are k): registers 0-1 for rows 0-7,
//     2-3 for rows 8-15;
//   bt_rows: B operands of two n8 tiles from rows stored k-major (rows
//     r0 + 0..15 are k, the 16 columns are n; ldmatrix .trans): registers
//     0-1 for columns 0-7, 2-3 for columns 8-15.
template <int D>
__device__ __forceinline__ const bf16* a_rows(const bf16* tile, int r0, int c0, int lane) {
  return tile + swz<D>(r0 + (lane & 15), 2 * c0 + (lane >> 4));
}
template <int D>
__device__ __forceinline__ const bf16* b_rows(const bf16* tile, int r0, int c0, int lane) {
  return tile + swz<D>(r0 + ((lane >> 4) << 3) + (lane & 7), 2 * c0 + ((lane >> 3) & 1));
}
template <int D>
__device__ __forceinline__ const bf16* bt_rows(const bf16* tile, int r0, int c0, int lane) {
  return tile + swz<D>(r0 + (((lane >> 3) & 1) << 3) + (lane & 7), 2 * c0 + (lane >> 4));
}

// The A fragment of a 16 x 16 block whose columns are the n8 accumulator
// tiles x and y, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[4],
                                         const float (&y)[4]) {
  a[0] = pack_bf16x2(x[0], x[1]);
  a[1] = pack_bf16x2(x[2], x[3]);
  a[2] = pack_bf16x2(y[0], y[1]);
  a[3] = pack_bf16x2(y[2], y[3]);
}

// Two f32 values rounded to bf16, stored at p (4-byte aligned).
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  st_b32(p, pack_bf16x2(a, b));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The pad bias of keys [k0, k0 + N) into `dst` by cp.async (threads 0 .. N - 1,
// N <= kThreadsTC), zeros past S.
template <int N>
__device__ __forceinline__ void load_bias_async(float* dst, const float* __restrict__ bias_b,
                                                int k0, int S) {
  const int i = threadIdx.x, col = k0 + i;
  if (i < N) cp_async_4(dst + i, bias_b + (col < S ? col : 0), col < S);
}

// Forward. Grid (B * H, ceil(S / 64)), kThreadsTC threads, at least MINB
// blocks an SM; block (x, y) takes head x's query tile gridDim.y - 1 - y:
// blocks are started in order of x + gridDim.x y, so the longest tiles of
// every head go first and the last wave is short ones. Warp w holds rows
// q0 + 16 w + {g, g + 8}. Dynamic shared memory: Q [64][D], K and V
// [2][64][D] bf16, the keys' pad bias [2][64] f32.
template <int D, int MINB>
__global__ void __launch_bounds__(kThreadsTC, MINB)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    bf16* __restrict__ out, float* __restrict__ lse, int H, int S, float scale) {
  constexpr int BM = 16 * kWarpsTC, BN = kKeysTC, KS = D / 16, NT = BN / 8, DT = D / 8;
  extern __shared__ float smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * D;
  bf16* Vs = Ks + 2 * BN * D;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BN * D);  // [2][BN]
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t slab = static_cast<size_t>(bh) * S * D;
  const float* bias_b = bias != nullptr ? bias + static_cast<size_t>(bh / H) * S : nullptr;
  const int r_lo = q0 + 16 * warp, r_hi = r_lo + 15;

  load_tile_async<D, BM>(Qs, q + slab, q0, S);
  load_tile_async<D, BN>(Ks, k + slab, 0, S);
  load_tile_async<D, BN>(Vs, v + slab, 0, S);
  if (bias_b != nullptr) load_bias_async<BN>(Bs, bias_b, 0, S);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's share
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;

  // key tiles 0 .. the one holding the tile's last visible key
  const int num_kt = (min(q0 + BM, S) - 1) / BN + 1;
  for (int kt = 0; kt < num_kt; ++kt) {
    cp_async_wait<0>();  // tile kt (and at kt == 0 the q tile) has landed
    if (kt == 0) prescale_own<D, BM>(Qs, round_to<bf16>(scale));
    __syncthreads();  // ... for every thread; tile kt - 1 is no longer read
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], a_rows<D>(Qs, 16 * warp, ks, lane));
    }
    if (kt + 1 < num_kt) {  // the next tile's copy runs under this tile's products
      const int nb = (kt + 1) & 1;
      load_tile_async<D, BN>(Ks + nb * BN * D, k + slab, (kt + 1) * BN, S);
      load_tile_async<D, BN>(Vs + nb * BN * D, v + slab, (kt + 1) * BN, S);
      if (bias_b != nullptr) load_bias_async<BN>(Bs + nb * BN, bias_b, (kt + 1) * BN, S);
      cp_async_commit();
    }
    const int k0 = kt * BN;
    if (k0 > r_hi) continue;  // every key of the tile is after each of the warp's rows
    const bf16* Kb = Ks + (kt & 1) * BN * D;
    const bf16* Vb = Vs + (kt & 1) * BN * D;
    const float* Bb = Bs + (kt & 1) * BN;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_rows<D>(Kb, 16 * np, ks, lane));
        mma_m16n8k16_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_m16n8k16_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }

    // masking: the pad bias, and -inf for keys after the row or past S
    const bool edge = k0 + BN - 1 > r_lo || k0 + BN > S;
    float bcol[NT][2];  // this lane's keys' bias (0 without a mask)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) bcol[nt][e] = bias_b != nullptr ? Bb[8 * nt + 2 * t + e] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + g + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * nt + 2 * t + e;
          float& x = s[nt][2 * h + e];
          x = edge && (col > row || col >= S) ? -INFINITY : x + bcol[nt][e];
          mx = fmaxf(mx, x);
        }
      // finite: key 0 is visible to every row, so tile 0 sets m
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float corr = __expf(m[h] - m_new);
      m[h] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * h + e];
          x = __expf(x - m_new);
          psum += x;
        }
      l[h] = l[h] * corr + psum;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * h] *= corr;
        o[dt][2 * h + 1] *= corr;
      }
    }

    // O += round(P) V: P from the score accumulators, V by ldmatrix .trans
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_rows<D>(Vb, 16 * kk, dp, lane));
        mma_m16n8k16_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_m16n8k16_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lq = quad_sum(l[h]);
    const int row = r_lo + g + 8 * h;
    if (row >= S) continue;
    bf16* orow = out + slab + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store_pair(orow + 8 * dt, o[dt][2 * h] / lq, o[dt][2 * h + 1] / lq);
    if (t == 0) lse[static_cast<size_t>(bh) * S + row] = m[h] + logf(lq);
  }
}

// D = rowsum(f32(dO) * f32(O)) per row. f32: grid ceil(rows / 256),
// kThreadsPre threads, a thread a row, summed in element order as the f32
// kernels sum dP. bf16: grid ceil(rows / 64), kThreadsTC threads, a warp on
// 16 rows: the diagonal of dO O^T by the same chain of m16n8k16 products,
// over the same k steps and at the same fragment positions, as the dQ
// kernel forms dP = dO V^T. So where a row's O equals a V row bit for bit,
// the kernels' dP - D is exactly 0 as it is in exact arithmetic: query 0
// sees key 0 alone, O_0 = V_0, and its dQ row is exactly 0.
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsPre)
flash_bwd_dcap_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                      float* __restrict__ dcap, int rows) {
  constexpr int kPer = 16 / sizeof(T);
  const int row = blockIdx.x * kThreadsPre + threadIdx.x;
  if (row >= rows) return;
  const size_t at = static_cast<size_t>(row) * D;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += kPer) {
    const uint4 wa = ld_b128(dout + at + c), wb = ld_b128(out + at + c);
    T a[kPer], b[kPer];
    memcpy(a, &wa, sizeof(a));  // not a cast: T and uint4 may not alias
    memcpy(b, &wb, sizeof(b));
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum += to_f32(a[i]) * to_f32(b[i]);
  }
  dcap[row] = sum;
}

// Two bf16 at element `col` of row `row` of a [rows, D] tensor (0 past the end).
template <int D>
__device__ __forceinline__ uint32_t pair_at(const bf16* __restrict__ x, int row, int col,
                                            int rows) {
  return row < rows ? ld_b32(x + static_cast<size_t>(row) * D + col) : 0u;
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
flash_bwd_dcap_kernel_tc(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                         float* __restrict__ dcap, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (blockIdx.x * kWarpsTC + warp) * 16;
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int col = 16 * ks + 2 * t;
    const uint32_t a[4] = {pair_at<D>(dout, r0 + g, col, rows),
                           pair_at<D>(dout, r0 + g + 8, col, rows),
                           pair_at<D>(dout, r0 + g, col + 8, rows),
                           pair_at<D>(dout, r0 + g + 8, col + 8, rows)};
    // n tile 0: O rows r0 .. r0 + 7; n tile 1: rows r0 + 8 .. r0 + 15
    mma_m16n8k16_bf16(c0, a, pair_at<D>(out, r0 + g, col, rows),
                      pair_at<D>(out, r0 + g, col + 8, rows));
    mma_m16n8k16_bf16(c1, a, pair_at<D>(out, r0 + 8 + g, col, rows),
                      pair_at<D>(out, r0 + 8 + g, col + 8, rows));
  }
  // the diagonal: (g, g) of tile 0 and (g + 8, g) of tile 1 sit in lane 4 g + g / 2
  if (t == (g >> 1)) {
    if (r0 + g < rows) dcap[r0 + g] = c0[g & 1];
    if (r0 + g + 8 < rows) dcap[r0 + g + 8] = c1[2 + (g & 1)];
  }
}

// dK and dV of one 64-key tile: grid (B * H, ceil(S / 64)), kThreadsTC
// threads, block (x, y) on head x's key tile y (the longest first, as the
// forward); warp w holds keys k0 + 16 w + {g, g + 8} and walks the query
// tiles of BQ rows from the diagonal to the end. Dynamic shared memory: K, V
// [64][D], Q and dO [2][BQ][D] bf16, lse and D [2][BQ] f32.
template <int D, int BQ, int MINB>
__global__ void __launch_bounds__(kThreadsTC, MINB)
flash_bwd_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dcap, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int S, float scale) {
  constexpr int BN = kKeysTC, KS = D / 16, NQ = BQ / 8, DT = D / 8;
  extern __shared__ float smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * D;
  bf16* Qs = Vs + BN * D;    // [2][BQ][D]
  bf16* dOs = Qs + 2 * BQ * D;  // [2][BQ][D]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * D);  // [2][BQ]
  float* Dc = Ls + 2 * BQ;                                  // [2][BQ]
  const int bh = blockIdx.x, k0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t slab = static_cast<size_t>(bh) * S * D;
  const size_t rows = static_cast<size_t>(bh) * S;
  const float* bias_b = bias != nullptr ? bias + static_cast<size_t>(bh / H) * S : nullptr;
  const int kw0 = k0 + 16 * warp;
  const float qscale = round_to<bf16>(scale);
  float bkey[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + g + 8 * h;
    bkey[h] = bias_b != nullptr && key < S ? bias_b[key] : 0.f;
  }

  auto fetch_q_tile = [&](int qt, int buf) {  // Q, dO, lse and D of query tile qt
    const int q0 = qt * BQ;
    load_tile_async<D, BQ>(Qs + buf * BQ * D, q + slab, q0, S);
    load_tile_async<D, BQ>(dOs + buf * BQ * D, dout + slab, q0, S);
    const int i = threadIdx.x, row = q0 + (i % BQ);
    const bool in = row < S;
    if (i < BQ) cp_async_4(Ls + buf * BQ + i, lse + rows + (in ? row : 0), in);
    else if (i < 2 * BQ) cp_async_4(Dc + buf * BQ + (i - BQ), dcap + rows + (in ? row : 0), in);
  };
  const int qt0 = k0 / BQ, num_qt = (S + BQ - 1) / BQ;
  load_tile_async<D, BN>(Ks, k + slab, k0, S);
  load_tile_async<D, BN>(Vs, v + slab, k0, S);
  fetch_q_tile(qt0, 0);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dt][i] = dva[dt][i] = 0.f;

  for (int qt = qt0; qt < num_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    bf16* Qb = Qs + buf * BQ * D;
    const bf16* dOb = dOs + buf * BQ * D;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Dc + buf * BQ;
    cp_async_wait<0>();
    prescale_own<D, BQ>(Qb, qscale);
    __syncthreads();  // tile qt complete and prescaled; tile qt - 1 no longer read
    if (qt + 1 < num_qt) {
      fetch_q_tile(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = qt * BQ;
    if (q0 + BQ - 1 < kw0) continue;  // every query of the tile is before each key of the warp

    // S^T = K Q_s^T and dP^T = V dO^T: rows are the warp's keys, columns queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4];
      ldmatrix_x4(ka, a_rows<D>(Ks, 16 * warp, ks, lane));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_rows<D>(Qb, 16 * np, ks, lane));
        mma_m16n8k16_bf16(st[2 * np], ka, b[0], b[1]);
        mma_m16n8k16_bf16(st[2 * np + 1], ka, b[2], b[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t va[4];
      ldmatrix_x4(va, a_rows<D>(Vs, 16 * warp, ks, lane));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_rows<D>(dOb, 16 * np, ks, lane));
        mma_m16n8k16_bf16(dpt[2 * np], va, b[0], b[1]);
        mma_m16n8k16_bf16(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P^T = exp(s - lse) (0 for rows past S); dS^T = P^T (dP^T - D)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * nt + 2 * t + e, row = q0 + qi;
        const float lse_r = Lb[qi], d_r = Db[qi];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = kw0 + g + 8 * h;
          const float x = key > row || key >= S ? -INFINITY : st[nt][2 * h + e] + bkey[h];
          const float p = row < S ? __expf(x - lse_r) : 0.f;
          st[nt][2 * h + e] = p;
          dpt[nt][2 * h + e] = p * (dpt[nt][2 * h + e] - d_r);
        }
      }

    // dV += (P_hi + P_lo)^T dO and dK += round(dS)^T Q_s; dO and Q by .trans
#pragma unroll
    for (int kq = 0; kq < NQ / 2; ++kq) {
      uint32_t ph[4], pl[4], sa[4];
      acc_to_a(ph, st[2 * kq], st[2 * kq + 1]);
      float rest[2][4];  // P - P_hi: exact in f32
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = st[2 * kq + j][i];
          rest[j][i] = p - round_to<bf16>(p);
        }
      acc_to_a(pl, rest[0], rest[1]);
      acc_to_a(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_rows<D>(dOb, 16 * kq, dp, lane));
        mma_m16n8k16_bf16(dva[2 * dp], ph, b[0], b[1]);
        mma_m16n8k16_bf16(dva[2 * dp], pl, b[0], b[1]);
        mma_m16n8k16_bf16(dva[2 * dp + 1], ph, b[2], b[3]);
        mma_m16n8k16_bf16(dva[2 * dp + 1], pl, b[2], b[3]);
        ldmatrix_x4_trans(b, bt_rows<D>(Qb, 16 * kq, dp, lane));
        mma_m16n8k16_bf16(dka[2 * dp], sa, b[0], b[1]);
        mma_m16n8k16_bf16(dka[2 * dp + 1], sa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + g + 8 * h;
    if (key >= S) continue;
    const size_t at = slab + static_cast<size_t>(key) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      store_pair(dk + at + 8 * dt, dka[dt][2 * h], dka[dt][2 * h + 1]);
      store_pair(dv + at + 8 * dt, dva[dt][2 * h], dva[dt][2 * h + 1]);
    }
  }
}

// dQ of one 64-query tile: grid (B * H, ceil(S / 64)), kThreadsTC threads;
// block (x, y) takes head x's query tile gridDim.y - 1 - y (the longest
// first, as the forward); warp w holds rows
// q0 + 16 w + {g, g + 8} and walks the key tiles 0 .. diagonal. Dynamic
// shared memory: Q, dO [64][D], K and V [2][64][D] bf16, the keys' pad bias
// [2][64] f32.
template <int D, int MINB>
__global__ void __launch_bounds__(kThreadsTC, MINB)
flash_bwd_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dcap, bf16* __restrict__ dq, int H, int S,
                       float scale) {
  constexpr int BM = 16 * kWarpsTC, BN = kKeysTC, KS = D / 16, NT = BN / 8, DT = D / 8;
  extern __shared__ float smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BM * D;
  bf16* Ks = dOs + BM * D;  // [2][BN][D]
  bf16* Vs = Ks + 2 * BN * D;  // [2][BN][D]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BN * D);  // [2][BN]
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t slab = static_cast<size_t>(bh) * S * D;
  const size_t rows = static_cast<size_t>(bh) * S;
  const float* bias_b = bias != nullptr ? bias + static_cast<size_t>(bh / H) * S : nullptr;
  const int r_lo = q0 + 16 * warp, r_hi = r_lo + 15;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + g + 8 * h;
    lse_r[h] = row < S ? lse[rows + row] : 0.f;
    d_r[h] = row < S ? dcap[rows + row] : 0.f;
  }

  load_tile_async<D, BM>(Qs, q + slab, q0, S);
  load_tile_async<D, BM>(dOs, dout + slab, q0, S);
  load_tile_async<D, BN>(Ks, k + slab, 0, S);
  load_tile_async<D, BN>(Vs, v + slab, 0, S);
  if (bias_b != nullptr) load_bias_async<BN>(Bs, bias_b, 0, S);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  const int num_kt = (min(q0 + BM, S) - 1) / BN + 1;
  for (int kt = 0; kt < num_kt; ++kt) {
    cp_async_wait<0>();
    if (kt == 0) prescale_own<D, BM>(Qs, round_to<bf16>(scale));
    __syncthreads();
    if (kt + 1 < num_kt) {
      const int nb = (kt + 1) & 1;
      load_tile_async<D, BN>(Ks + nb * BN * D, k + slab, (kt + 1) * BN, S);
      load_tile_async<D, BN>(Vs + nb * BN * D, v + slab, (kt + 1) * BN, S);
      if (bias_b != nullptr) load_bias_async<BN>(Bs + nb * BN, bias_b, (kt + 1) * BN, S);
      cp_async_commit();
    }
    const int k0 = kt * BN;
    if (k0 > r_hi) continue;
    const bf16* Kb = Ks + (kt & 1) * BN * D;
    const bf16* Vb = Vs + (kt & 1) * BN * D;
    const float* Bb = Bs + (kt & 1) * BN;

    // S = Q_s K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldmatrix_x4(qa, a_rows<D>(Qs, 16 * warp, ks, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_rows<D>(Kb, 16 * np, ks, lane));
        mma_m16n8k16_bf16(s[2 * np], qa, b[0], b[1]);
        mma_m16n8k16_bf16(s[2 * np + 1], qa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t oa[4];
      ldmatrix_x4(oa, a_rows<D>(dOs, 16 * warp, ks, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_rows<D>(Vb, 16 * np, ks, lane));
        mma_m16n8k16_bf16(dp[2 * np], oa, b[0], b[1]);
        mma_m16n8k16_bf16(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // P = exp(s - lse) (0 for rows past S); dS = P (dP - D), into s
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * nt + 2 * t + e;
        const float bc = bias_b != nullptr ? Bb[8 * nt + 2 * t + e] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r_lo + g + 8 * h;
          const float x = col > row || col >= S ? -INFINITY : s[nt][2 * h + e] + bc;
          const float p = row < S ? __expf(x - lse_r[h]) : 0.f;
          s[nt][2 * h + e] = p * (dp[nt][2 * h + e] - d_r[h]);
        }
      }

    // dQ += round(dS) K, K by ldmatrix .trans
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_rows<D>(Kb, 16 * kk, dp2, lane));
        mma_m16n8k16_bf16(acc[2 * dp2], sa, b[0], b[1]);
        mma_m16n8k16_bf16(acc[2 * dp2 + 1], sa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + g + 8 * h;
    if (row >= S) continue;
    bf16* qrow = dq + slab + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store_pair(qrow + 8 * dt, acc[dt][2 * h] * scale, acc[dt][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

size_t fwd_smem(int D) { return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLP); }
size_t bwd_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLP + 2 * kTile);
}

// Blocks an SM (the register cap: 65536 / (128 x blocks) registers a
// thread) and the dK/dV query tile (BQ) of the bf16 kernels by head dim. On
// the H100 more resident warps beat unspilled registers: at D <= 64 the caps
// cost the dK/dV and dQ instances 16 and 12 bytes of spill stores and
// measured faster than the caps that spill nothing (PERF.md). At D = 128 a
// warp's accumulators take twice the registers and the dK/dV query tile
// halves.
template <int D> constexpr int kFwdBlocks = D <= 64 ? 4 : 2;
template <int D> constexpr int kDkvBQ = D <= 64 ? 64 : 32;
template <int D> constexpr int kDkvBlocks = D <= 64 ? 3 : 1;
template <int D> constexpr int kDqBlocks = D <= 64 ? 4 : 1;
size_t tc_fwd_smem(int D) {
  return sizeof(bf16) * D * (16 * kWarpsTC + 4 * kKeysTC) + sizeof(float) * 2 * kKeysTC;
}
size_t tc_dkv_smem(int D, int BQ) {
  return sizeof(bf16) * D * (2 * kKeysTC + 4 * BQ) + sizeof(float) * 4 * BQ;
}
size_t tc_dq_smem(int D) {
  return sizeof(bf16) * D * (2 * 16 * kWarpsTC + 4 * kKeysTC) + sizeof(float) * 2 * kKeysTC;
}

// Raise the kernel's dynamic shared-memory cap to the most a block may use,
// once per kernel instance (a function-local static in the caller), so no
// runtime configuration call lands inside a CUDA-graph capture.
template <typename Kernel>
int allow_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
}

template <typename Kernel, typename... Args>
int launch(int allowed, Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (allowed != 0) return allowed;
  if (smem > static_cast<size_t>(kSmemLimit)) return -2;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
        int BH, int H, int S, float scale, cudaStream_t stream) {
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  const auto* b_ = static_cast<const float*>(bias);
  auto* o_ = static_cast<T*>(out);
  auto* l_ = static_cast<float*>(lse);
  if constexpr (kTensorCores<T>) {
    const auto kernel = flash_fwd_kernel_tc<D, kFwdBlocks<D>>;
    static const int allowed = allow_smem(kernel);
    return launch(allowed, kernel, dim3(BH, (S + kKeysTC - 1) / kKeysTC), kThreadsTC,
                  tc_fwd_smem(D), stream, q_, k_, v_, b_, o_, l_, H, S, scale);
  } else {
    static const int allowed = allow_smem(flash_fwd_kernel<T, D>);
    return launch(allowed, flash_fwd_kernel<T, D>, dim3((S + kTile - 1) / kTile, BH), kThreads,
                  fwd_smem(D), stream, q_, k_, v_, b_, o_, l_, H, S, scale);
  }
}

template <typename T, int D>
int bwd_dcap(const void* dout, const void* out, void* dcap, int rows, cudaStream_t stream) {
  const auto* do_ = static_cast<const T*>(dout);
  const auto* o_ = static_cast<const T*>(out);
  auto* d_ = static_cast<float*>(dcap);
  if constexpr (kTensorCores<T>) {
    constexpr int kRows = 16 * kWarpsTC;
    static const int allowed = allow_smem(flash_bwd_dcap_kernel_tc<D>);
    return launch(allowed, flash_bwd_dcap_kernel_tc<D>, dim3((rows + kRows - 1) / kRows),
                  kThreadsTC, 0, stream, do_, o_, d_, rows);
  } else {
    static const int allowed = allow_smem(flash_bwd_dcap_kernel<T, D>);
    return launch(allowed, flash_bwd_dcap_kernel<T, D>,
                  dim3((rows + kThreadsPre - 1) / kThreadsPre), kThreadsPre, 0, stream, do_, o_,
                  d_, rows);
  }
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
            const void* lse, const void* dcap, void* dk, void* dv, int BH, int H, int S,
            float scale, cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, BH);  // 64 keys a block; (B * H, tiles) for bf16
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  const auto* b_ = static_cast<const float*>(bias);
  const auto* do_ = static_cast<const T*>(dout);
  const auto* l_ = static_cast<const float*>(lse);
  const auto* d_ = static_cast<const float*>(dcap);
  if constexpr (kTensorCores<T>) {
    constexpr int BQ = kDkvBQ<D>;
    const auto kernel = flash_bwd_dkv_kernel_tc<D, BQ, kDkvBlocks<D>>;
    static const int allowed = allow_smem(kernel);
    return launch(allowed, kernel, dim3(grid.y, grid.x), kThreadsTC, tc_dkv_smem(D, BQ),
                  stream, q_, k_, v_, b_, do_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv),
                  H, S, scale);
  } else {
    static const int allowed = allow_smem(flash_bwd_dkv_kernel<T, D>);
    return launch(allowed, flash_bwd_dkv_kernel<T, D>, grid, kThreads, bwd_smem(D), stream, q_,
                  k_, v_, b_, do_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv), H, S,
                  scale);
  }
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
           const void* lse, const void* dcap, void* dq, int BH, int H, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, BH);  // 64 queries a block; (B * H, tiles) for bf16
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  const auto* b_ = static_cast<const float*>(bias);
  const auto* do_ = static_cast<const T*>(dout);
  const auto* l_ = static_cast<const float*>(lse);
  const auto* d_ = static_cast<const float*>(dcap);
  if constexpr (kTensorCores<T>) {
    const auto kernel = flash_bwd_dq_kernel_tc<D, kDqBlocks<D>>;
    static const int allowed = allow_smem(kernel);
    return launch(allowed, kernel, dim3(grid.y, grid.x), kThreadsTC, tc_dq_smem(D), stream,
                  q_, k_, v_, b_, do_, l_, d_, static_cast<T*>(dq), H, S, scale);
  } else {
    static const int allowed = allow_smem(flash_bwd_dq_kernel<T, D>);
    return launch(allowed, flash_bwd_dq_kernel<T, D>, grid, kThreads, bwd_smem(D), stream, q_,
                  k_, v_, b_, do_, l_, d_, static_cast<T*>(dq), H, S, scale);
  }
}

}  // namespace

// One switch over (dtype kind, head dim) for each entry point below; -1 for a
// pair this library has no instance of.
#define TK_DISPATCH(FN, ...)                                          \
  switch (kind * 1000 + D) {                                          \
    case 16: return FN<float, 16>(__VA_ARGS__);                       \
    case 32: return FN<float, 32>(__VA_ARGS__);                       \
    case 64: return FN<float, 64>(__VA_ARGS__);                       \
    case 128: return FN<float, 128>(__VA_ARGS__);                     \
    case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);            \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);            \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);            \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);           \
    default: return -1;                                               \
  }

extern "C" {

// kind: 0 f32, 1 bf16; q is unscaled, `scale` the softmax scale. Each
// returns cudaGetLastError() after its launch, -1 for a (kind, D) without an
// instance, -2 for shared memory over the cap.
int tk_flash_fwd(int kind, int D, const void* q, const void* k, const void* v,
                 const void* bias, void* out, void* lse, int BH, int H, int S, float scale,
                 void* stream) {
  TK_DISPATCH(fwd, q, k, v, bias, out, lse, BH, H, S, scale, static_cast<cudaStream_t>(stream))
}

// D = rowsum(dO * O) over `rows` rows of D values into the f32 `dcap`.
int tk_flash_bwd_dcap(int kind, int D, const void* dout, const void* out, void* dcap, int rows,
                      void* stream) {
  TK_DISPATCH(bwd_dcap, dout, out, dcap, rows, static_cast<cudaStream_t>(stream))
}

int tk_flash_bwd_dkv(int kind, int D, const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse, const void* dcap,
                     void* dk, void* dv, int BH, int H, int S, float scale, void* stream) {
  TK_DISPATCH(bwd_dkv, q, k, v, bias, dout, lse, dcap, dk, dv, BH, H, S, scale,
              static_cast<cudaStream_t>(stream))
}

int tk_flash_bwd_dq(int kind, int D, const void* q, const void* k, const void* v,
                    const void* bias, const void* dout, const void* lse, const void* dcap,
                    void* dq, int BH, int H, int S, float scale, void* stream) {
  TK_DISPATCH(bwd_dq, q, k, v, bias, dout, lse, dcap, dq, BH, H, S, scale,
              static_cast<cudaStream_t>(stream))
}

const char* tk_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
