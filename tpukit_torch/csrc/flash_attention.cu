// Causal flash attention for Hopper (sm_90a): forward, and a backward in two
// kernels (dK/dV, then dQ).
//
// Replaces the Pallas TPU kernels of tpukit/ops/pallas_attention.py:
//   - `_fwd_kernel` (:178) launched by `_flash_forward` (:215, call :227);
//   - `_bwd_kernel` (:259) launched by `_flash_backward` (:504, call :530),
//     and `_dq_kernel` (:346) / `_dkv_kernel` (:389) launched by
//     `_flash_backward_split` (:437, calls :448, :470). The TPU picks one of
//     the two backwards by the number of key blocks; here one split design
//     covers every length: no S^2-scaled dQ partials and no atomics, so the
//     result does not change from run to run.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [B*H, S, D] row-major in the compute
// dtype T (f32 or bf16); q arrives prescaled by 1/sqrt(D) in T (the wrapper
// does it, as `_fwd4_impl` does at :599); `bias` is the [B, S] f32 pad bias
// (0 or finfo(f32).min per key, or null without a pad mask); lse and
// D = rowsum(dO * O) are [B*H, S] f32.
//
// Semantics (as `_masked_scores` :126 and the kernels above):
//   s = q.k in f32, plus the key's pad bias; keys after the query (j > i) are
//   left out. tpukit selects -1e9 there and gets exp(-1e9 - m) == 0 exactly
//   for every row that has an unpadded key, so leaving them out changes no
//   bit; a fully padded query row then attends uniformly over j <= i, the
//   behaviour documented at pallas_attention.py:11-19 (such rows carry
//   ignore targets).
//   Forward: online softmax over key tiles in f32 (m, l); p rounded to T
//   before the P.V product, l summed from the unrounded p; O = acc / l in
//   f32, then rounded; lse = m + log(l).
//   Backward: P = exp(s - lse) in f32; dV += P^T dO with dO read as f32;
//   dP = dO V^T in f32; dS = P * (dP - D); dS rounded to T before dK += dS^T q
//   and dQ += dS k; dQ times 1/sqrt(D) (q was prescaled).
//   Any S: rows and keys past S are masked in the kernel.
//
// Bound. At the GPT-2-small training shape (B 64, H 12, S 512, D 64, bf16)
// one forward must move q, k, v and O (4 x 50.3 MB) and lse: 61 us at
// 3.35 TB/s, against 4*B*H*D*S(S+1)/2 = 2.58e10 flops, 26 us at the bf16
// tensor-core peak, so bytes bound it; the backward moves about twice the
// bytes for 2.5x the flops. What the design does about it: no S x S tensor
// touches device memory (scores and probabilities live in shared memory one
// 64 x 64 tile at a time), K/V tiles past the diagonal are never loaded, and
// each block reads its own q (or k/v) tile once. This first version
// multiplies on CUDA cores in f32 (an f32 product of two bf16 values is
// exact), 16 products per thread per shared-memory step; wgmma/TMA and
// bf16 tiles in shared memory are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// zeros past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int S) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? to_f32(src[static_cast<size_t>(row) * D + d]) : 0.f;
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
                 int H, int S) {
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

  load_tile<T, D>(Qs, q + slab, q0, S);
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
                     T* __restrict__ dk, T* __restrict__ dv, int H, int S) {
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
    load_tile<T, D>(Qs, q + slab, q0, S);
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

  load_tile<T, D>(Qs, q + slab, q0, S);
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

size_t fwd_smem(int D) { return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLP); }
size_t bwd_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLP + 2 * kTile);
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
int launch(int allowed, Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  if (allowed != 0) return allowed;
  if (smem > static_cast<size_t>(kSmemLimit)) return -2;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
        int BH, int H, int S, cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, BH);
  static const int allowed = allow_smem(flash_fwd_kernel<T, D>);
  return launch(allowed, flash_fwd_kernel<T, D>, grid, fwd_smem(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const float*>(bias), static_cast<T*>(out),
                static_cast<float*>(lse), H, S);
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
            const void* lse, const void* dcap, void* dk, void* dv, int BH, int H, int S,
            cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, BH);
  static const int allowed = allow_smem(flash_bwd_dkv_kernel<T, D>);
  return launch(allowed, flash_bwd_dkv_kernel<T, D>, grid, bwd_smem(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const float*>(bias), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(dcap),
                static_cast<T*>(dk), static_cast<T*>(dv), H, S);
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
           const void* lse, const void* dcap, void* dq, int BH, int H, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + kTile - 1) / kTile, BH);
  static const int allowed = allow_smem(flash_bwd_dq_kernel<T, D>);
  return launch(allowed, flash_bwd_dq_kernel<T, D>, grid, bwd_smem(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const float*>(bias), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(dcap),
                static_cast<T*>(dq), H, S, scale);
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

// kind: 0 f32, 1 bf16. Each returns cudaGetLastError() after its launch, -1
// for a (kind, D) without an instance, -2 for shared memory over the cap.
int tk_flash_fwd(int kind, int D, const void* q, const void* k, const void* v,
                 const void* bias, void* out, void* lse, int BH, int H, int S, void* stream) {
  TK_DISPATCH(fwd, q, k, v, bias, out, lse, BH, H, S, static_cast<cudaStream_t>(stream))
}

int tk_flash_bwd_dkv(int kind, int D, const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse, const void* dcap,
                     void* dk, void* dv, int BH, int H, int S, void* stream) {
  TK_DISPATCH(bwd_dkv, q, k, v, bias, dout, lse, dcap, dk, dv, BH, H, S,
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
