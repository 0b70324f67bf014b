// Fused LM head + cross-entropy for Hopper (sm_90a): forward, and a backward
// in two kernels (dW, then dH). No kernel writes the [N, V] logits.
//
// Replaces the Pallas TPU kernels of tpukit/ops/fused_head_ce.py:
//   - `_fwd_kernel` (:65) launched by `_fused_fwd_arrays` (:194, call :202);
//   - `_bwd_kernel` (:134) launched by `_fused_bwd_arrays` (:235, call :245).
//
// Inputs: hidden states h [N, dim] and the head kernel W [dim, Vp], both in
// the compute dtype T (the wrapper rounds the f32 W to T, as `_prep` does
// with `w.astype(h.dtype)`, :187); targets [N] int32 with -100 for ignored
// rows; `vocab` <= Vp real columns, the rest pad columns.
//
// Forward, per row: logits = h.W in f32 over vocab tiles; pad columns are
// -1e9 (:95); an online log-sum-exp over the tiles (running max m and sum
// l); the target's logit; with `with_argmax`, the first column of the row's
// maximum (smallest column within a tile, and a later tile only on a
// strictly greater value, :113-122). Writes lse, the target logit and the
// argmax, f32/f32/int32 [N].
// Backward, from the cotangents g_lse and g_tgt of those two outputs (the
// caller's loss gives g_lse = g, g_tgt = -g on valid rows, 0 elsewhere):
//   d = softmax * g_lse + onehot(target) * g_tgt, rounded to T (:168);
//   dW = h^T d (f32 out, [dim, Vp]); dH = d W^T (rounded to T once).
// Blocks run in parallel and in no order here, so the TPU's accumulation in
// a revisited output block (:146-179) becomes two kernels that each
// recompute their logits tile: dW with one block per 32 vocab columns,
// looping over all tokens, and dH with one block per 32 tokens, looping over
// all vocab tiles, each keeping its f32 accumulator in shared memory. No
// atomics: the results do not change from run to run. tpukit rounds each
// vocab tile's dH partial to T before an f32 sum (:263, :270), a layout
// artefact of its grid; these kernels sum dH over the whole vocab in f32 and
// round once.
//
// Two instances of each kernel:
//   - bf16 (the training path): every product on the tensor cores (WMMA
//     16x16x16 bf16 fragments, f32 accumulation; a bf16 x bf16 product is
//     exact in f32, so only the summation order differs from an f32 sum);
//     the logits tile goes through shared memory to the same per-thread
//     epilogue as the f32 instance;
//   - f32 (`--disable_amp`): CUDA cores in true f32 (not TF32), the tile
//     held in registers.
//
// Bound. At the GPT-2-small training shape (N = 64 x 512 tokens, dim 768, Vp
// 50304, bf16) the forward is 2*N*dim*Vp = 2.53e12 flops, 2.6 ms at the bf16
// tensor-core peak, against 50 MB of h and 77 MB of W (0.04 ms at
// 3.35 TB/s): operations bound it, and the backward has three such products
// (7.7 ms). What the design does about it: logits never reach device memory
// (6.6 GB in f32 at this shape); h and W tiles are staged in shared memory
// and each is reused across a 128 x 128 tile (forward) or 128 x 32 and
// 32 x 64 tiles (backward); the bf16 staging moves 16 bytes a load and
// fetches the next chunk into registers while the tensor cores work on the
// current one; the backward recomputes the logits once per kernel. Not done
// yet: wgmma, TMA or cp.async, and a backward that shares one logits
// recomputation between dW and dH.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // a 16 x 16 grid: tx = tid % 16, ty = tid / 16
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;              // dim chunk staged in shared memory
constexpr int kIgnore = -100;
constexpr float kPadLogit = -1e9f;   // pad columns (apply_head's clamp)
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use

// f32 instance: forward tokens x vocab columns per tile; dW tokens per step
// x columns per block; dH tokens per block x columns per step
constexpr int kFT = 64, kFV = 64;
constexpr int kWT = 64, kWV = 32;
constexpr int kHT = 32, kHV = 64;
// bf16 (tensor-core) instance
constexpr int kFTc = 128, kFVc = 128;
constexpr int kWTc = 128, kWVc = 32;
constexpr int kHTc = 32, kHVc = 64;
constexpr int kKCc = 64;             // dim chunk of the logits products
constexpr int kDC = 128;             // dim chunk of the dW and dH products

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Reductions over the 16 threads that share a tile row (same ty, lanes of
// one half-warp).
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int row_min16(int v) {
  for (int o = 8; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Carve shared memory: `n` elements of E at `*cursor`, the cursor moved on
// by a multiple of 128 bytes (WMMA wants 32-byte aligned tiles).
template <typename E>
__device__ __forceinline__ E* carve(unsigned char*& cursor, size_t n) {
  E* out = reinterpret_cast<E*>(cursor);
  cursor += (n * sizeof(E) + 127) / 128 * 128;
  return out;
}

// ---------------------------------------------------------------------------
// Shared pieces: the forward's fold of one logits tile into the running row
// terms, the per-row backward terms, and d of one logit.
// ---------------------------------------------------------------------------

struct RowTerms {
  float m, l, tl, bv;
  int bi, tgt;
};

// Fold tile columns [v0, v0 + 16 TN) of rows ty + 16 i (logits in acc) into
// the running terms. Columns past Vp are left out; column v0 is in every
// tile, so the tile maximum is finite.
template <int TM, int TN>
__device__ __forceinline__ void fold_tile(float (&acc)[TM][TN], RowTerms (&rt)[TM], int v0,
                                          int Vp, int vocab, int with_argmax) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = v0 + tx + 16 * j;
      acc[i][j] = col >= Vp ? -INFINITY : (col < vocab ? acc[i][j] : kPadLogit);
      tile_max = fmaxf(tile_max, acc[i][j]);
    }
    tile_max = row_max16(tile_max);
    const float m_new = fmaxf(rt[i].m, tile_max);
    float psum = 0.f, hit = 0.f;
    int idx = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = v0 + tx + 16 * j;
      psum += expf(acc[i][j] - m_new);
      if (col == rt[i].tgt) hit += acc[i][j];
      if (acc[i][j] == tile_max && col < idx) idx = col;
    }
    rt[i].l = rt[i].l * expf(rt[i].m - m_new) + row_sum16(psum);
    rt[i].m = m_new;
    rt[i].tl += row_sum16(hit);
    if (with_argmax) {
      idx = row_min16(idx);
      if (tile_max > rt[i].bv) {
        rt[i].bv = tile_max;
        rt[i].bi = idx;
      }
    }
  }
}

template <int TM>
__device__ __forceinline__ void init_rows(RowTerms (&rt)[TM], const int32_t* __restrict__ targets,
                                          int t0, int N) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = t0 + ty + 16 * i;
    rt[i] = RowTerms{-INFINITY, 0.f, 0.f, -INFINITY, 0, row < N ? targets[row] : kIgnore};
  }
}

template <int TM>
__device__ __forceinline__ void write_rows(const RowTerms (&rt)[TM], float* __restrict__ lse,
                                           float* __restrict__ tgt_logit,
                                           int32_t* __restrict__ best, int t0, int N,
                                           int with_argmax) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = t0 + ty + 16 * i;
    if (row >= N) continue;
    lse[row] = rt[i].m + logf(rt[i].l);
    tgt_logit[row] = rt[i].tl;
    best[row] = with_argmax ? rt[i].bi : 0;
  }
}

// Per-row lse, g_lse, g_tgt and target of rows [t0, t0 + rows) into shared
// memory; rows past N get zero cotangents and the ignore target.
__device__ __forceinline__ void load_row_terms(float* Ls, float* Gl, float* Gt, int* Tg,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ g_lse,
                                               const float* __restrict__ g_tgt,
                                               const int32_t* __restrict__ targets, int t0,
                                               int rows, int N) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int row = t0 + r;
    const bool in = row < N;
    Ls[r] = in ? lse[row] : 0.f;
    Gl[r] = in ? g_lse[row] : 0.f;
    Gt[r] = in ? g_tgt[row] : 0.f;
    Tg[r] = in ? targets[row] : kIgnore;
  }
}

// d of (tile row r, column col) from its logit, rounded to T.
template <typename T>
__device__ __forceinline__ float dlogit(float logit, int r, int row, int col, int N, int Vp,
                                        int vocab, const float* Ls, const float* Gl,
                                        const float* Gt, const int* Tg) {
  if (row >= N || col >= Vp) return 0.f;
  const float x = col < vocab ? logit : kPadLogit;
  const float p = expf(x - Ls[r]);  // pad columns: exp(-1e9 - lse) == 0
  return round_to<T>(p * Gl[r] + (col == Tg[r] ? Gt[r] : 0.f));
}

// acc[i][j] = C[(ty + 16 i) * ldc + tx + 16 j]: a logits tile from shared
// memory into the per-thread layout of the epilogues.
template <int TM, int TN>
__device__ __forceinline__ void read_tile(float (&acc)[TM][TN], const float* C, int ldc) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = C[(ty + 16 * i) * ldc + tx + 16 * j];
}

// ---------------------------------------------------------------------------
// f32 instance: CUDA cores, true f32.
// ---------------------------------------------------------------------------

// h rows [t0, t0 + rows) x dims [k0, k0 + kKC) -> Hs [rows][kKC + 1], zeros
// outside [N, dim).
__device__ __forceinline__ void load_h(float* Hs, const float* __restrict__ h, int t0,
                                       int rows, int k0, int N, int dim) {
  for (int e = threadIdx.x; e < rows * kKC; e += kThreads) {
    const int r = e / kKC, dd = e % kKC, row = t0 + r, kk = k0 + dd;
    Hs[r * (kKC + 1) + dd] = (row < N && kk < dim) ? h[static_cast<size_t>(row) * dim + kk] : 0.f;
  }
}

// W dims [k0, k0 + kKC) x columns [v0, v0 + cols) -> Ws [kKC][cols + 1],
// zeros outside [dim, Vp).
__device__ __forceinline__ void load_w(float* Ws, const float* __restrict__ w, int k0, int v0,
                                       int cols, int dim, int Vp) {
  for (int e = threadIdx.x; e < kKC * cols; e += kThreads) {
    const int dd = e / cols, c = e % cols, kk = k0 + dd, col = v0 + c;
    Ws[dd * (cols + 1) + c] = (kk < dim && col < Vp) ? w[static_cast<size_t>(kk) * Vp + col] : 0.f;
  }
}

// acc[i][j] = logit of (tile row ty + 16 i, tile column tx + 16 j) over the
// whole dim, staging kKC-wide chunks of h and W.
template <int TM, int TN, int ROWS, int COLS>
__device__ __forceinline__ void logits_tile(float (&acc)[TM][TN], float* Hs, float* Ws,
                                            const float* __restrict__ h,
                                            const float* __restrict__ w, int t0, int v0,
                                            int N, int dim, int Vp) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < dim; k0 += kKC) {
    __syncthreads();  // the previous chunk (or the caller's last reads) is done
    load_h(Hs, h, t0, ROWS, k0, N, dim);
    load_w(Ws, w, k0, v0, COLS, dim, Vp);
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kKC; ++dd) {
      float hv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) hv[i] = Hs[(ty + 16 * i) * (kKC + 1) + dd];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = Ws[dd * (COLS + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += hv[i] * wv[j];
    }
  }
}

// Grid (ceil(N / 64)), kThreads threads; loops over the vocab tiles.
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const int32_t* __restrict__ targets, float* __restrict__ lse,
              float* __restrict__ tgt_logit, int32_t* __restrict__ best, int N, int dim,
              int Vp, int vocab, int with_argmax) {
  extern __shared__ __align__(128) float smem[];
  constexpr int TM = kFT / 16, TN = kFV / 16;
  float* Hs = smem;
  float* Ws = Hs + kFT * (kKC + 1);
  const int t0 = blockIdx.x * kFT;
  RowTerms rt[TM];
  init_rows(rt, targets, t0, N);
  for (int v0 = 0; v0 < Vp; v0 += kFV) {
    float acc[TM][TN];
    logits_tile<TM, TN, kFT, kFV>(acc, Hs, Ws, h, w, t0, v0, N, dim, Vp);
    fold_tile(acc, rt, v0, Vp, vocab, with_argmax);
  }
  write_rows(rt, lse, tgt_logit, best, t0, N, with_argmax);
}

// dW of 32 vocab columns: grid (ceil(Vp / 32)), kThreads threads; loops over
// all tokens, 64 at a time.
__global__ void __launch_bounds__(kThreads)
ce_bwd_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const int32_t* __restrict__ targets, const float* __restrict__ lse,
                 const float* __restrict__ g_lse, const float* __restrict__ g_tgt,
                 float* __restrict__ dw, int N, int dim, int Vp, int vocab) {
  extern __shared__ __align__(128) float smem[];
  constexpr int TM = kWT / 16, TN = kWV / 16;
  float* acc_s = smem;
  float* Hs = acc_s + static_cast<size_t>(dim) * kWV;
  float* Ws = Hs + kWT * (kKC + 1);
  float* Ds = Ws + kKC * (kWV + 1);
  float* Ls = Ds + kWT * (kWV + 1);
  float* Gl = Ls + kWT;
  float* Gt = Gl + kWT;
  int* Tg = reinterpret_cast<int*>(Gt + kWT);
  const int v0 = blockIdx.x * kWV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int e = threadIdx.x; e < dim * kWV; e += kThreads) acc_s[e] = 0.f;

  for (int t0 = 0; t0 < N; t0 += kWT) {
    __syncthreads();  // the previous step's row terms are no longer read
    load_row_terms(Ls, Gl, Gt, Tg, lse, g_lse, g_tgt, targets, t0, kWT, N);
    float a[TM][TN];
    logits_tile<TM, TN, kWT, kWV>(a, Hs, Ws, h, w, t0, v0, N, dim, Vp);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ds[r * (kWV + 1) + c] = dlogit<float>(a[i][j], r, t0 + r, v0 + c, N, Vp, vocab, Ls,
                                              Gl, Gt, Tg);
      }
    // acc[kk][c] += sum_r h[r][kk] * d[r][c], one kKC chunk of dim at a time;
    // thread (ty, tx) owns dims ty + 16 a and columns tx + 16 b of a chunk
    for (int k0 = 0; k0 < dim; k0 += kKC) {
      __syncthreads();  // Ds written; the previous chunk's Hs no longer read
      load_h(Hs, h, t0, kWT, k0, N, dim);
      __syncthreads();
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int r = 0; r < kWT; ++r) {
        const float h0 = Hs[r * (kKC + 1) + ty], h1 = Hs[r * (kKC + 1) + ty + 16];
        const float d0 = Ds[r * (kWV + 1) + tx], d1 = Ds[r * (kWV + 1) + tx + 16];
        s[0][0] += h0 * d0;
        s[0][1] += h0 * d1;
        s[1][0] += h1 * d0;
        s[1][1] += h1 * d1;
      }
#pragma unroll
      for (int a2 = 0; a2 < 2; ++a2) {
        const int kk = k0 + ty + 16 * a2;
        if (kk < dim) {
          acc_s[kk * kWV + tx] += s[a2][0];
          acc_s[kk * kWV + tx + 16] += s[a2][1];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < dim * kWV; e += kThreads) {
    const int kk = e / kWV, c = e % kWV, col = v0 + c;
    if (col < Vp) dw[static_cast<size_t>(kk) * Vp + col] = acc_s[e];
  }
}

// dH of 32 tokens: grid (ceil(N / 32)), kThreads threads; loops over all
// vocab tiles, 64 columns at a time.
__global__ void __launch_bounds__(kThreads)
ce_bwd_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const int32_t* __restrict__ targets, const float* __restrict__ lse,
                 const float* __restrict__ g_lse, const float* __restrict__ g_tgt,
                 float* __restrict__ dh, int N, int dim, int Vp, int vocab) {
  extern __shared__ __align__(128) float smem[];
  constexpr int TM = kHT / 16, TN = kHV / 16;
  float* acc_s = smem;
  float* Hs = acc_s + static_cast<size_t>(kHT) * dim;
  float* Ws = Hs + kHT * (kKC + 1);
  float* Ds = Ws + kKC * (kHV + 1);
  float* Ls = Ds + kHT * (kHV + 1);
  float* Gl = Ls + kHT;
  float* Gt = Gl + kHT;
  int* Tg = reinterpret_cast<int*>(Gt + kHT);
  const int t0 = blockIdx.x * kHT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int e = threadIdx.x; e < kHT * dim; e += kThreads) acc_s[e] = 0.f;
  load_row_terms(Ls, Gl, Gt, Tg, lse, g_lse, g_tgt, targets, t0, kHT, N);

  for (int v0 = 0; v0 < Vp; v0 += kHV) {
    float a[TM][TN];
    logits_tile<TM, TN, kHT, kHV>(a, Hs, Ws, h, w, t0, v0, N, dim, Vp);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ds[r * (kHV + 1) + c] = dlogit<float>(a[i][j], r, t0 + r, v0 + c, N, Vp, vocab, Ls,
                                              Gl, Gt, Tg);
      }
    // acc[r][kk] += sum_c d[r][c] * W[kk][c], one kKC chunk of dim at a
    // time; thread (ty, tx) owns rows ty + 16 a and dims tx + 16 b of a chunk
    for (int k0 = 0; k0 < dim; k0 += kKC) {
      __syncthreads();  // Ds written; the previous chunk's Ws no longer read
      load_w(Ws, w, k0, v0, kHV, dim, Vp);
      __syncthreads();
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int c = 0; c < kHV; ++c) {
        const float d0 = Ds[ty * (kHV + 1) + c], d1 = Ds[(ty + 16) * (kHV + 1) + c];
        const float w0 = Ws[tx * (kHV + 1) + c], w1 = Ws[(tx + 16) * (kHV + 1) + c];
        s[0][0] += d0 * w0;
        s[0][1] += d0 * w1;
        s[1][0] += d1 * w0;
        s[1][1] += d1 * w1;
      }
#pragma unroll
      for (int b2 = 0; b2 < 2; ++b2) {
        const int kk = k0 + tx + 16 * b2;
        if (kk < dim) {
          acc_s[ty * dim + kk] += s[0][b2];
          acc_s[(ty + 16) * dim + kk] += s[1][b2];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kHT * dim; e += kThreads) {
    const int r = e / dim, kk = e % dim, row = t0 + r;
    if (row < N) dh[static_cast<size_t>(row) * dim + kk] = acc_s[e];
  }
}

// ---------------------------------------------------------------------------
// bf16 instance: tensor cores (WMMA), f32 accumulation.
// ---------------------------------------------------------------------------

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Eight bf16 of row gr, columns [gc, gc + 8) of a row-major matrix (ld
// columns; zeros outside [R, Cn)), as raw bits: one 16-byte load where the
// run is whole and aligned, element by element otherwise.
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ src, int ld, int gr,
                                       int gc, int R, int Cn) {
  const uint16_t* p = src + static_cast<size_t>(gr) * ld + gc;
  if (gr < R && gc + 8 <= Cn && reinterpret_cast<uintptr_t>(p) % 16 == 0)
    return *reinterpret_cast<const uint4*>(p);
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (gr < R && gc + k < Cn) ? p[k] : 0u;
  uint4 out;
  out.x = v[0] | (v[1] << 16);
  out.y = v[2] | (v[3] << 16);
  out.z = v[4] | (v[5] << 16);
  out.w = v[6] | (v[7] << 16);
  return out;
}

// A [ROWS x COLS] block of a row-major bf16 matrix staged into shared memory
// in two steps, so the next block's global loads are in flight while the
// tensor cores work on the current one: `fetch` loads it into registers
// (16 bytes a load), `put` writes it to shared memory (row stride lds).
template <int ROWS, int COLS>
struct Stager {
  static_assert(COLS % 8 == 0, "whole 16-byte runs");
  static constexpr int kVecs = ROWS * COLS / 8;
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  uint4 r[kPer];

  __device__ __forceinline__ void fetch(const bf16* __restrict__ src, int ld, int r0, int c0,
                                        int R, int Cn) {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kVecs) {
        const int rr = e / (COLS / 8), cc = e % (COLS / 8) * 8;
        r[i] = load8(s16, ld, r0 + rr, c0 + cc, R, Cn);
      }
    }
  }

  __device__ __forceinline__ void put(bf16* S, int lds) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kVecs) {
        const int rr = e / (COLS / 8), cc = e % (COLS / 8) * 8;
        *reinterpret_cast<uint4*>(S + rr * lds + cc) = r[i];
      }
    }
  }
};

// The [ROWS x COLS] logits tile h[t0 ..] . W[:, v0 ..] on the tensor cores,
// stored to C (f32, row stride COLS + 4). The 8 warps tile it WR x WC; each
// owns a (ROWS / 16 / WR) x (COLS / 16 / WC) block of 16 x 16 fragments.
// As [ROWS][kKCc + 8] and Bs [kKCc][COLS + 8] hold the current h and W
// chunks while the next ones load.
template <int ROWS, int COLS, int WR, int WC>
__device__ __forceinline__ void logits_tile_tc(float* C, bf16* As, bf16* Bs,
                                               const bf16* __restrict__ h,
                                               const bf16* __restrict__ w, int t0, int v0,
                                               int N, int dim, int Vp) {
  static_assert(WR * WC == kWarps, "the warps tile the logits");
  constexpr int PR = ROWS / 16 / WR, PC = COLS / 16 / WC;
  constexpr int lda = kKCc + 8, ldb = COLS + 8, ldc = COLS + 4;
  const int warp = threadIdx.x >> 5;
  const int fr0 = (warp / WC) * PR, fc0 = (warp % WC) * PC;
  FragC acc[PR][PC];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  Stager<ROWS, kKCc> sa;
  Stager<kKCc, COLS> sb;
  sa.fetch(h, dim, t0, 0, N, dim);
  sb.fetch(w, Vp, 0, v0, dim, Vp);
  for (int k0 = 0; k0 < dim; k0 += kKCc) {
    __syncthreads();  // the previous chunk (or the caller's last reads) is done
    sa.put(As, lda);
    sb.put(Bs, ldb);
    __syncthreads();
    if (k0 + kKCc < dim) {
      sa.fetch(h, dim, t0, k0 + kKCc, N, dim);
      sb.fetch(w, Vp, k0 + kKCc, v0, dim, Vp);
    }
#pragma unroll
    for (int ks = 0; ks < kKCc; ks += 16) {
      FragA a[PR];
      FragB b[PC];
#pragma unroll
      for (int i = 0; i < PR; ++i)
        wmma::load_matrix_sync(a[i], As + (fr0 + i) * 16 * lda + ks, lda);
#pragma unroll
      for (int j = 0; j < PC; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * ldb + (fc0 + j) * 16, ldb);
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j)
      wmma::store_matrix_sync(C + (fr0 + i) * 16 * ldc + (fc0 + j) * 16, acc[i][j], ldc,
                              wmma::mem_row_major);
  __syncthreads();
}

// Grid (ceil(N / 128)), kThreads threads; loops over 128-column vocab tiles.
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel_tc(const bf16* __restrict__ h, const bf16* __restrict__ w,
                 const int32_t* __restrict__ targets, float* __restrict__ lse,
                 float* __restrict__ tgt_logit, int32_t* __restrict__ best, int N, int dim,
                 int Vp, int vocab, int with_argmax) {
  extern __shared__ __align__(128) float smem[];
  constexpr int TM = kFTc / 16, TN = kFVc / 16;
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  float* C = carve<float>(cur, kFTc * (kFVc + 4));
  bf16* As = carve<bf16>(cur, kFTc * (kKCc + 8));
  bf16* Bs = carve<bf16>(cur, kKCc * (kFVc + 8));
  const int t0 = blockIdx.x * kFTc;
  RowTerms rt[TM];
  init_rows(rt, targets, t0, N);
  for (int v0 = 0; v0 < Vp; v0 += kFVc) {
    logits_tile_tc<kFTc, kFVc, 2, 4>(C, As, Bs, h, w, t0, v0, N, dim, Vp);
    float acc[TM][TN];
    read_tile(acc, C, kFVc + 4);
    fold_tile(acc, rt, v0, Vp, vocab, with_argmax);
  }
  write_rows(rt, lse, tgt_logit, best, t0, N, with_argmax);
}

// dW of 32 vocab columns: grid (ceil(Vp / 32)), kThreads threads; loops over
// all tokens, 128 at a time. The accumulator [dimp][32] f32 (dimp = dim
// rounded up to kDC) lives in shared memory; each 128-dim chunk of
// acc += h^T d is two 16 x 16 fragments per warp.
__global__ void __launch_bounds__(kThreads)
ce_bwd_dw_kernel_tc(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int32_t* __restrict__ targets, const float* __restrict__ lse,
                    const float* __restrict__ g_lse, const float* __restrict__ g_tgt,
                    float* __restrict__ dw, int N, int dim, int Vp, int vocab) {
  extern __shared__ __align__(128) float smem[];
  constexpr int TM = kWTc / 16, TN = kWVc / 16;
  constexpr int ldd = kWVc + 8, ldh = kDC + 8;
  const int dimp = (dim + kDC - 1) / kDC * kDC;
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  float* acc_s = carve<float>(cur, static_cast<size_t>(dimp) * kWVc);
  float* C = carve<float>(cur, kWTc * (kWVc + 4));
  bf16* As = carve<bf16>(cur, kWTc * (kKCc + 8));
  bf16* Bs = carve<bf16>(cur, kKCc * (kWVc + 8));
  bf16* Ds = carve<bf16>(cur, kWTc * ldd);
  bf16* Ht = carve<bf16>(cur, kWTc * ldh);
  float* Ls = carve<float>(cur, kWTc);
  float* Gl = carve<float>(cur, kWTc);
  float* Gt = carve<float>(cur, kWTc);
  int* Tg = carve<int>(cur, kWTc);
  const int v0 = blockIdx.x * kWVc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, warp = threadIdx.x >> 5;
  // this warp's two fragments of a 128 x 32 chunk: rows fr and fr + 4
  const int fr = warp / 2, fc = warp % 2;
  for (int e = threadIdx.x; e < dimp * kWVc; e += kThreads) acc_s[e] = 0.f;

  for (int t0 = 0; t0 < N; t0 += kWTc) {
    __syncthreads();  // the previous step's row terms and Ds are no longer read
    load_row_terms(Ls, Gl, Gt, Tg, lse, g_lse, g_tgt, targets, t0, kWTc, N);
    logits_tile_tc<kWTc, kWVc, 4, 2>(C, As, Bs, h, w, t0, v0, N, dim, Vp);
    float a[TM][TN];
    read_tile(a, C, kWVc + 4);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ds[r * ldd + c] = __float2bfloat16_rn(
            dlogit<bf16>(a[i][j], r, t0 + r, v0 + c, N, Vp, vocab, Ls, Gl, Gt, Tg));
      }
    Stager<kWTc, kDC> sh;
    sh.fetch(h, dim, t0, 0, N, dim);
    for (int k0 = 0; k0 < dimp; k0 += kDC) {
      __syncthreads();  // Ds written; the previous chunk's Ht no longer read
      sh.put(Ht, ldh);
      __syncthreads();
      if (k0 + kDC < dimp) sh.fetch(h, dim, t0, k0 + kDC, N, dim);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = fr + 4 * half;  // fragment row of the chunk
        float* out = acc_s + static_cast<size_t>(k0 + f * 16) * kWVc + fc * 16;
        FragC c;
        wmma::load_matrix_sync(c, out, kWVc, wmma::mem_row_major);
#pragma unroll
        for (int ks = 0; ks < kWTc; ks += 16) {
          FragAt a_t;  // h^T: element (dim m, token k) at Ht[k * ldh + m]
          FragB d;
          wmma::load_matrix_sync(a_t, Ht + ks * ldh + f * 16, ldh);
          wmma::load_matrix_sync(d, Ds + ks * ldd + fc * 16, ldd);
          wmma::mma_sync(c, a_t, d, c);
        }
        wmma::store_matrix_sync(out, c, kWVc, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < dim * kWVc; e += kThreads) {
    const int kk = e / kWVc, c = e % kWVc, col = v0 + c;
    if (col < Vp) dw[static_cast<size_t>(kk) * Vp + col] = acc_s[e];
  }
}

// dH of 32 tokens: grid (ceil(N / 32)), kThreads threads; loops over all
// vocab tiles, 64 columns at a time. The accumulator [32][dimp] f32 lives in
// shared memory; each 128-dim chunk of acc += d W^T is two 16 x 16
// fragments per warp.
__global__ void __launch_bounds__(kThreads)
ce_bwd_dh_kernel_tc(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int32_t* __restrict__ targets, const float* __restrict__ lse,
                    const float* __restrict__ g_lse, const float* __restrict__ g_tgt,
                    bf16* __restrict__ dh, int N, int dim, int Vp, int vocab) {
  extern __shared__ __align__(128) float smem[];
  constexpr int TM = kHTc / 16, TN = kHVc / 16;
  constexpr int ldd = kHVc + 8, ldw = kHVc + 8;
  const int dimp = (dim + kDC - 1) / kDC * kDC;
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  float* acc_s = carve<float>(cur, static_cast<size_t>(kHTc) * dimp);
  float* C = carve<float>(cur, kHTc * (kHVc + 4));
  bf16* As = carve<bf16>(cur, kHTc * (kKCc + 8));
  bf16* Bs = carve<bf16>(cur, kKCc * (kHVc + 8));
  bf16* Ds = carve<bf16>(cur, kHTc * ldd);
  bf16* Wc = carve<bf16>(cur, kDC * ldw);
  float* Ls = carve<float>(cur, kHTc);
  float* Gl = carve<float>(cur, kHTc);
  float* Gt = carve<float>(cur, kHTc);
  int* Tg = carve<int>(cur, kHTc);
  const int t0 = blockIdx.x * kHTc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, warp = threadIdx.x >> 5;
  // this warp's two fragments of a 32 x 128 chunk: columns fc and fc + 4
  const int fr = warp / 4, fc = warp % 4;
  for (int e = threadIdx.x; e < kHTc * dimp; e += kThreads) acc_s[e] = 0.f;
  load_row_terms(Ls, Gl, Gt, Tg, lse, g_lse, g_tgt, targets, t0, kHTc, N);

  for (int v0 = 0; v0 < Vp; v0 += kHVc) {
    logits_tile_tc<kHTc, kHVc, 2, 4>(C, As, Bs, h, w, t0, v0, N, dim, Vp);
    float a[TM][TN];
    read_tile(a, C, kHVc + 4);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ds[r * ldd + c] = __float2bfloat16_rn(
            dlogit<bf16>(a[i][j], r, t0 + r, v0 + c, N, Vp, vocab, Ls, Gl, Gt, Tg));
      }
    Stager<kDC, kHVc> sw;
    sw.fetch(w, Vp, 0, v0, dim, Vp);
    for (int k0 = 0; k0 < dimp; k0 += kDC) {
      __syncthreads();  // Ds written; the previous chunk's Wc no longer read
      sw.put(Wc, ldw);
      __syncthreads();
      if (k0 + kDC < dimp) sw.fetch(w, Vp, k0 + kDC, v0, dim, Vp);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = fc + 4 * half;  // fragment column of the chunk
        float* out = acc_s + static_cast<size_t>(fr * 16) * dimp + k0 + f * 16;
        FragC c;
        wmma::load_matrix_sync(c, out, dimp, wmma::mem_row_major);
#pragma unroll
        for (int ks = 0; ks < kHVc; ks += 16) {
          FragA d;
          FragBt w_t;  // W^T: element (column k, dim n) at Wc[n * ldw + k]
          wmma::load_matrix_sync(d, Ds + fr * 16 * ldd + ks, ldd);
          wmma::load_matrix_sync(w_t, Wc + f * 16 * ldw + ks, ldw);
          wmma::mma_sync(c, d, w_t, c);
        }
        wmma::store_matrix_sync(out, c, dimp, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kHTc * dim; e += kThreads) {
    const int r = e / dim, kk = e % dim, row = t0 + r;
    if (row < N)
      dh[static_cast<size_t>(row) * dim + kk] = __float2bfloat16_rn(acc_s[r * dimp + kk]);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

size_t round128(size_t bytes) { return (bytes + 127) / 128 * 128; }

size_t fwd_smem(bool tc) {
  if (!tc) return sizeof(float) * (kFT * (kKC + 1) + kKC * (kFV + 1));
  return round128(4 * kFTc * (kFVc + 4)) + round128(2 * kFTc * (kKCc + 8)) +
         round128(2 * kKCc * (kFVc + 8));
}
size_t dw_smem(int dim, bool tc) {
  if (!tc)
    return sizeof(float) * (static_cast<size_t>(dim) * kWV + kWT * (kKC + 1) +
                            kKC * (kWV + 1) + kWT * (kWV + 1) + 4 * kWT);
  const size_t dimp = (dim + kDC - 1) / kDC * kDC;
  return round128(4 * dimp * kWVc) + round128(4 * kWTc * (kWVc + 4)) +
         round128(2 * kWTc * (kKCc + 8)) + round128(2 * kKCc * (kWVc + 8)) +
         round128(2 * kWTc * (kWVc + 8)) + round128(2 * kWTc * (kDC + 8)) +
         4 * round128(4 * kWTc);
}
size_t dh_smem(int dim, bool tc) {
  if (!tc)
    return sizeof(float) * (static_cast<size_t>(kHT) * dim + kHT * (kKC + 1) +
                            kKC * (kHV + 1) + kHT * (kHV + 1) + 4 * kHT);
  const size_t dimp = (dim + kDC - 1) / kDC * kDC;
  return round128(4 * kHTc * dimp) + round128(4 * kHTc * (kHVc + 4)) +
         round128(2 * kHTc * (kKCc + 8)) + round128(2 * kKCc * (kHVc + 8)) +
         round128(2 * kHTc * (kHVc + 8)) + round128(2 * kDC * (kHVc + 8)) +
         4 * round128(4 * kHTc);
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

using I32 = int32_t;

int fwd_f32(const void* h, const void* w, const void* t, void* lse, void* tgt, void* best, int N,
            int dim, int Vp, int vocab, int with_argmax, cudaStream_t s) {
  static const int allowed = allow_smem(ce_fwd_kernel);
  return launch(allowed, ce_fwd_kernel, dim3((N + kFT - 1) / kFT), fwd_smem(false), s,
                static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const I32*>(t), static_cast<float*>(lse), static_cast<float*>(tgt),
                static_cast<I32*>(best), N, dim, Vp, vocab, with_argmax);
}

int fwd_bf16(const void* h, const void* w, const void* t, void* lse, void* tgt, void* best,
             int N, int dim, int Vp, int vocab, int with_argmax, cudaStream_t s) {
  static const int allowed = allow_smem(ce_fwd_kernel_tc);
  return launch(allowed, ce_fwd_kernel_tc, dim3((N + kFTc - 1) / kFTc), fwd_smem(true), s,
                static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                static_cast<const I32*>(t), static_cast<float*>(lse), static_cast<float*>(tgt),
                static_cast<I32*>(best), N, dim, Vp, vocab, with_argmax);
}

int dw_f32(const void* h, const void* w, const void* t, const void* lse, const void* gl,
           const void* gt, void* dw, int N, int dim, int Vp, int vocab, cudaStream_t s) {
  static const int allowed = allow_smem(ce_bwd_dw_kernel);
  return launch(allowed, ce_bwd_dw_kernel, dim3((Vp + kWV - 1) / kWV), dw_smem(dim, false), s,
                static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const I32*>(t), static_cast<const float*>(lse),
                static_cast<const float*>(gl), static_cast<const float*>(gt),
                static_cast<float*>(dw), N, dim, Vp, vocab);
}

int dw_bf16(const void* h, const void* w, const void* t, const void* lse, const void* gl,
            const void* gt, void* dw, int N, int dim, int Vp, int vocab, cudaStream_t s) {
  static const int allowed = allow_smem(ce_bwd_dw_kernel_tc);
  return launch(allowed, ce_bwd_dw_kernel_tc, dim3((Vp + kWVc - 1) / kWVc), dw_smem(dim, true),
                s, static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                static_cast<const I32*>(t), static_cast<const float*>(lse),
                static_cast<const float*>(gl), static_cast<const float*>(gt),
                static_cast<float*>(dw), N, dim, Vp, vocab);
}

int dh_f32(const void* h, const void* w, const void* t, const void* lse, const void* gl,
           const void* gt, void* dh, int N, int dim, int Vp, int vocab, cudaStream_t s) {
  static const int allowed = allow_smem(ce_bwd_dh_kernel);
  return launch(allowed, ce_bwd_dh_kernel, dim3((N + kHT - 1) / kHT), dh_smem(dim, false), s,
                static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const I32*>(t), static_cast<const float*>(lse),
                static_cast<const float*>(gl), static_cast<const float*>(gt),
                static_cast<float*>(dh), N, dim, Vp, vocab);
}

int dh_bf16(const void* h, const void* w, const void* t, const void* lse, const void* gl,
            const void* gt, void* dh, int N, int dim, int Vp, int vocab, cudaStream_t s) {
  static const int allowed = allow_smem(ce_bwd_dh_kernel_tc);
  return launch(allowed, ce_bwd_dh_kernel_tc, dim3((N + kHTc - 1) / kHTc), dh_smem(dim, true),
                s, static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                static_cast<const I32*>(t), static_cast<const float*>(lse),
                static_cast<const float*>(gl), static_cast<const float*>(gt),
                static_cast<bf16*>(dh), N, dim, Vp, vocab);
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 bf16 (the dtype of h and W). Each returns
// cudaGetLastError() after its launch, -1 for an unknown kind, -2 for
// shared memory over the cap (dim too large).
int tk_ce_fwd(int kind, const void* h, const void* w, const void* targets, void* lse,
              void* tgt, void* best, int N, int dim, int Vp, int vocab, int with_argmax,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return fwd_f32(h, w, targets, lse, tgt, best, N, dim, Vp, vocab, with_argmax, s);
  if (kind == 1) return fwd_bf16(h, w, targets, lse, tgt, best, N, dim, Vp, vocab, with_argmax, s);
  return -1;
}

int tk_ce_bwd_dw(int kind, const void* h, const void* w, const void* targets, const void* lse,
                 const void* g_lse, const void* g_tgt, void* dw, int N, int dim, int Vp,
                 int vocab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return dw_f32(h, w, targets, lse, g_lse, g_tgt, dw, N, dim, Vp, vocab, s);
  if (kind == 1) return dw_bf16(h, w, targets, lse, g_lse, g_tgt, dw, N, dim, Vp, vocab, s);
  return -1;
}

int tk_ce_bwd_dh(int kind, const void* h, const void* w, const void* targets, const void* lse,
                 const void* g_lse, const void* g_tgt, void* dh, int N, int dim, int Vp,
                 int vocab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return dh_f32(h, w, targets, lse, g_lse, g_tgt, dh, N, dim, Vp, vocab, s);
  if (kind == 1) return dh_bf16(h, w, targets, lse, g_lse, g_tgt, dh, N, dim, Vp, vocab, s);
  return -1;
}

const char* tk_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
