// Fused LM head + cross-entropy for Hopper (sm_90a). No kernel writes the
// [N, V] logits in f32; the bf16 backward keeps its d in a bf16 workspace.
//
// Replaces the Pallas TPU kernels of tpukit/ops/fused_head_ce.py:
//   - `_fwd_kernel` (:65) launched by `_fused_fwd_arrays` (:194, call :202);
//   - `_bwd_kernel` (:134) launched by `_fused_bwd_arrays` (:235, call :245).
//
// The function. Inputs: hidden states h [N, dim] and the head kernel W
// [dim, Vp], both in the compute dtype T (the wrapper rounds the f32 W to T,
// as `_prep` does with `w.astype(h.dtype)`, :187); targets [N] int32 with
// -100 for ignored rows; `vocab` <= Vp real columns, the rest pad columns.
// Forward, per row: logits = h.W in f32; pad columns are -1e9 (:95); the
// log-sum-exp; the target's logit; with `with_argmax`, the first column of
// the row's maximum (:113-122). Writes lse, the target logit and the argmax,
// f32/f32/int32 [N]. Backward, from the cotangents g_lse and g_tgt of those
// two outputs (the caller's loss gives g_lse = g, g_tgt = -g on valid rows,
// 0 elsewhere):
//   d = softmax * g_lse + onehot(target) * g_tgt, rounded to T (:168);
//   dW = h^T d (f32 out, [dim, Vp]); dH = d W^T (rounded to T once).
// tpukit rounds each vocab tile's dH partial to T before an f32 sum (:263,
// :270), a layout artefact of its grid; these kernels sum dH over the whole
// vocab in f32 and round once.
//
// Bound. At the GPT-2-small training shape (N = 64 x 512 tokens, dim 768, Vp
// 50304, bf16) one head product is 2 N dim Vp = 2.53e12 flops, 2.56 ms at the
// bf16 tensor-core peak, against 50 MB of h and 77 MB of W (0.04 ms at
// 3.35 TB/s): operations bound both directions, the forward one product,
// the backward three (h.W to form d, d W^T, h^T d: 7.68 ms).
//
// bf16 design (the training path): every product runs one GEMM mainloop,
// `gemm_body` of tk_gemm.cuh (shared with moe_gemm.cu), on wgmma with TMA
// (the primitives of tk_hopper.cuh):
//   - a persistent grid, one 384-thread block an SM: warpgroup 0 is the
//     producer (one thread keeps TMA loads in flight into a ring of kStages
//     stages, each a 128 x 64 A tile and a 64 x 256 B tile of 128B-swizzled
//     bf16, 48 KB), warpgroups 1 and 2 the consumers (each 64 rows of the
//     128 x 256 output tile, f32 accumulators in 128 registers a thread,
//     m64n256k16 products straight from the stages, one k-block's products
//     in flight while the next is issued); `setmaxnreg` moves registers
//     from the producer to the consumers;
//   - every operand read as it lies in memory, K- or MN-major through the
//     descriptor's transpose bit: h.W (h K-major, W MN-major), d W^T (d
//     K-major, W K-major), h^T d (h MN-major, d MN-major); no transposed copy;
//   - the product's epilogue supplied by a policy type, run by the consumers
//     on the registers while the producer already loads the next tile.
// Forward: the epilogue folds each tile into the row's running (max, sum of
// exponentials, target logit, first-index argmax); a block walks the vocab
// tiles of its split in order. The grid may split the vocab (to fill the
// card when the row tiles do not): each split writes its partial row terms
// and `ce_fwd_combine_kernel` folds them in split order (the smallest column
// within a split, a later split only on a strictly greater value).
// Backward, per chunk of at most C token rows (C such that the d workspace
// [C, Vp'] bf16 stays within 1 GiB: 8192 rows at Vp' 50304):
//   1. `ce_bwd_d_kernel`: h_c.W, whose epilogue forms d (rows past N, and
//      columns past Vp, give 0) and writes it to the workspace;
//   2. `ce_bwd_dh_kernel_wgmma`: d W^T, K = the vocab, split over S vocab
//      ranges where the narrow output leaves SMs idle, each split's f32
//      partial to its own buffer; `ce_bwd_dh_combine_kernel` adds them in
//      split order and rounds to bf16 once;
//   3. `ce_bwd_dw_kernel_wgmma`: dW (+)= h_c^T d in f32; the first chunk
//      stores, later chunks read, add and write, in chunk order.
// Three head-sized products, no atomics: every run gives the same bits. The
// workspace traffic (d written once and read twice, 9.9 GB at the main
// shape) is this design's own cost beyond the bound.
//
// f32 instance (`--disable_amp`): CUDA cores in true f32 (not TF32), the
// tile held in registers; the backward in two kernels (dW with one block per
// 32 vocab columns over all tokens, dH with one block per 32 tokens over all
// vocab tiles), each recomputing its logits tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tk_gemm.cuh"
#include "tk_hopper.cuh"
#include "tk_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // f32 kernels: a 16 x 16 grid, tx = tid % 16, ty = tid / 16
constexpr int kKC = 32;              // dim chunk staged in shared memory
constexpr int kIgnore = -100;
constexpr float kPadLogit = -1e9f;   // pad columns (apply_head's clamp)
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use

// f32 instance: forward tokens x vocab columns per tile; dW tokens per step
// x columns per block; dH tokens per block x columns per step
constexpr int kFT = 64, kFV = 64;
constexpr int kWT = 64, kWV = 32;
constexpr int kHT = 32, kHV = 64;

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

// ---------------------------------------------------------------------------
// f32 instance pieces: the forward's fold of one logits tile into the
// running row terms, the per-row backward terms, and d of one logit.
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

// d of (tile row r, column col) from its logit (f32: no rounding).
__device__ __forceinline__ float dlogit(float logit, int r, int row, int col, int N, int Vp,
                                        int vocab, const float* Ls, const float* Gl,
                                        const float* Gt, const int* Tg) {
  if (row >= N || col >= Vp) return 0.f;
  const float x = col < vocab ? logit : kPadLogit;
  const float p = expf(x - Ls[r]);  // pad columns: exp(-1e9 - lse) == 0
  return p * Gl[r] + (col == Tg[r] ? Gt[r] : 0.f);
}


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
        Ds[r * (kWV + 1) + c] = dlogit(a[i][j], r, t0 + r, v0 + c, N, Vp, vocab, Ls,
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
        Ds[r * (kHV + 1) + c] = dlogit(a[i][j], r, t0 + r, v0 + c, N, Vp, vocab, Ls,
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
// bf16 instance: the wgmma/TMA GEMM mainloop of tk_gemm.cuh, four epilogues.
// ---------------------------------------------------------------------------

constexpr int kMaxSplits = 4;

// Every policy here runs two consumer warpgroups (128 x 256 tiles) on one
// matrix B (no bank) and keeps no per-block plan.

// Forward: logits = h.W (h K-major, W MN-major). Unit u = (row tile
// u % m_tiles, vocab split u / m_tiles) walks the split's vocab tiles in
// order, folding each into the running terms of the thread's two rows;
// `end` writes the split's partial terms, [4][splits][N] (max, sum,
// target logit, best value) and [splits][N] (best column).
template <bool kArgmax>
struct FwdPolicy {
  static constexpr int kAMajor = 0, kBMajor = 1;
  static constexpr int kConsumers = 2, kBBank = 0;
  __device__ __forceinline__ void setup() const {}
  const int32_t* targets;
  float* part;
  int32_t* part_idx;
  int N, Vp, vocab, m_tiles, n_tiles, splits, per_split, k_blocks, units;

  struct State {
    float m[2], l[2], tl[2], bv[2];
    int bi[2], tgt[2];
  };

  __device__ __forceinline__ int tiles(int u) const {
    return min(per_split, n_tiles - (u / m_tiles) * per_split);
  }
  __device__ __forceinline__ Tile tile(int u, int i) const {
    return Tile{(u % m_tiles) * kBM, ((u / m_tiles) * per_split + i) * kBN, 0, k_blocks};
  }
  __device__ __forceinline__ void begin(State& st, int u, int cw) const {
    const Frag f(tile(u, 0), cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      st.m[h] = -INFINITY;
      st.l[h] = st.tl[h] = 0.f;
      st.bv[h] = -INFINITY;
      st.bi[h] = 0;
      st.tgt[h] = row < N ? targets[row] : kIgnore;
    }
  }
  // Columns past Vp are left out; column n0 < Vp is in every tile, so the
  // tile's maximum is finite.
  __device__ __forceinline__ void tile_done(State& st, float (&acc)[128], int, const Tile& t,
                                            int cw) const {
    const Frag f(t, cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = f.col0 + 8 * j + e;
          float& x = acc[4 * j + 2 * h + e];
          x = col >= Vp ? -INFINITY : (col < vocab ? x : kPadLogit);
          tile_max = fmaxf(tile_max, x);
        }
      tile_max = quad_max(tile_max);
      const float m_new = fmaxf(st.m[h], tile_max);
      float psum = 0.f, hit = 0.f;
      int idx = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = f.col0 + 8 * j + e;
          const float x = acc[4 * j + 2 * h + e];
          psum += expf(x - m_new);
          if (col == st.tgt[h]) hit += x;
          if (kArgmax && x == tile_max && col < idx) idx = col;
        }
      st.l[h] = st.l[h] * expf(st.m[h] - m_new) + quad_sum(psum);
      st.m[h] = m_new;
      st.tl[h] += quad_sum(hit);
      if (kArgmax) {
        idx = quad_min(idx);
        if (tile_max > st.bv[h]) {
          st.bv[h] = tile_max;
          st.bi[h] = idx;
        }
      }
    }
  }
  __device__ __forceinline__ void end(State& st, int u, int cw) const {
    const Frag f(tile(u, 0), cw);
    if (f.q != 0) return;
    const size_t plane = static_cast<size_t>(splits) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      if (row >= N) continue;
      const size_t at = static_cast<size_t>(u / m_tiles) * N + row;
      part[at] = st.m[h];
      part[plane + at] = st.l[h];
      part[2 * plane + at] = st.tl[h];
      part[3 * plane + at] = st.bv[h];
      part_idx[at] = st.bi[h];
    }
  }
};

// Backward 1: d of chunk rows [c0, c0 + rows) from h_c.W (h K-major, W
// MN-major), written in bf16 to the workspace [rows][ldd]; columns past Vp
// are 0. Unit u = tile (u % m_tiles, u / m_tiles): the blocks in flight
// share W's tiles.
struct DPolicy {
  static constexpr int kAMajor = 0, kBMajor = 1;
  static constexpr int kConsumers = 2, kBBank = 0;
  __device__ __forceinline__ void setup() const {}
  using State = NoState;
  const float *lse, *g_lse, *g_tgt;
  const int32_t* targets;
  bf16* ws;
  int c0, rows, ldd, Vp, vocab, m_tiles, k_blocks, units;

  __device__ __forceinline__ int tiles(int) const { return 1; }
  __device__ __forceinline__ Tile tile(int u, int) const {
    return Tile{(u % m_tiles) * kBM, (u / m_tiles) * kBN, 0, k_blocks};
  }
  __device__ __forceinline__ void begin(State&, int, int) const {}
  __device__ __forceinline__ void end(State&, int, int) const {}
  __device__ __forceinline__ float dval(float x, int col, float ls, float gl, float gt,
                                        int tg) const {
    if (col >= Vp) return 0.f;
    const float p = expf((col < vocab ? x : kPadLogit) - ls);  // pad columns: exactly 0
    return p * gl + (col == tg ? gt : 0.f);
  }
  __device__ __forceinline__ void tile_done(State&, float (&acc)[128], int, const Tile& t,
                                            int cw) const {
    const Frag f(t, cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row0 + 8 * h;
      if (r >= rows) continue;
      const int row = c0 + r;
      const float ls = lse[row], gl = g_lse[row], gt = g_tgt[row];
      const int tg = targets[row];
      bf16* out = ws + static_cast<size_t>(r) * ldd;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = f.col0 + 8 * j;  // even; ldd is a multiple of 8
        if (col >= ldd) continue;
        st_b32(out + col, pack_bf16x2(dval(acc[4 * j + 2 * h], col, ls, gl, gt, tg),
                                      dval(acc[4 * j + 2 * h + 1], col + 1, ls, gl, gt, tg)));
      }
    }
  }
};

// Backward 2: dH partials of the chunk, d W^T (d K-major, W K-major), K =
// the vocab cut into `splits` ranges of k-blocks; split s writes its f32
// partial to part [s][rows][dim]. Unit u = (split, row tile, dim tile),
// the dim tile fastest: the blocks in flight share d's rows.
struct DhPolicy {
  static constexpr int kAMajor = 0, kBMajor = 0;
  static constexpr int kConsumers = 2, kBBank = 0;
  __device__ __forceinline__ void setup() const {}
  using State = NoState;
  float* part;
  int rows, dim, m_tiles, n_tiles, per_split, k_blocks, units;

  __device__ __forceinline__ int tiles(int) const { return 1; }
  __device__ __forceinline__ Tile tile(int u, int) const {
    const int s = u / (m_tiles * n_tiles), kb0 = s * per_split;
    return Tile{((u / n_tiles) % m_tiles) * kBM, (u % n_tiles) * kBN, kb0,
                min(k_blocks, kb0 + per_split)};
  }
  __device__ __forceinline__ void begin(State&, int, int) const {}
  __device__ __forceinline__ void end(State&, int, int) const {}
  __device__ __forceinline__ void tile_done(State&, float (&acc)[128], int u, const Tile& t,
                                            int cw) const {
    const Frag f(t, cw);
    float* out = part + static_cast<size_t>(u / (m_tiles * n_tiles)) * rows * dim;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row0 + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = f.col0 + 8 * j;  // even; dim is a multiple of 8
        if (col >= dim) continue;
        out[static_cast<size_t>(r) * dim + col] = acc[4 * j + 2 * h];
        out[static_cast<size_t>(r) * dim + col + 1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
};

// Backward 3: dW (+)= h_c^T d (h MN-major, d MN-major), K = the chunk's
// tokens, into dw [dim][ldw] f32, columns < Vp; `accumulate` 0 stores (the
// first chunk). Unit u = tile (u % m_tiles, u / m_tiles): the blocks in
// flight share d's tiles.
struct DwPolicy {
  static constexpr int kAMajor = 1, kBMajor = 1;
  static constexpr int kConsumers = 2, kBBank = 0;
  __device__ __forceinline__ void setup() const {}
  using State = NoState;
  float* dw;
  int ldw, dim, Vp, accumulate, m_tiles, k_blocks, units;

  __device__ __forceinline__ int tiles(int) const { return 1; }
  __device__ __forceinline__ Tile tile(int u, int) const {
    return Tile{(u % m_tiles) * kBM, (u / m_tiles) * kBN, 0, k_blocks};
  }
  __device__ __forceinline__ void begin(State&, int, int) const {}
  __device__ __forceinline__ void end(State&, int, int) const {}
  __device__ __forceinline__ void tile_done(State&, float (&acc)[128], int, const Tile& t,
                                            int cw) const {
    const Frag f(t, cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row0 + 8 * h;
      if (r >= dim) continue;
      float* out = dw + static_cast<size_t>(r) * ldw;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = f.col0 + 8 * j + e;
          const float v = acc[4 * j + 2 * h + e];
          if (col < Vp) out[col] = accumulate ? out[col] + v : v;
        }
    }
  }
};

template <bool kArgmax>
__global__ void __launch_bounds__(kGemmThreads, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                    const FwdPolicy<kArgmax> p) {
  gemm_body(&ma, &mb, p);
}

__global__ void __launch_bounds__(kGemmThreads, 1)
ce_bwd_d_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                      const __grid_constant__ CUtensorMap mb, const DPolicy p) {
  gemm_body(&ma, &mb, p);
}

__global__ void __launch_bounds__(kGemmThreads, 1)
ce_bwd_dh_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb, const DhPolicy p) {
  gemm_body(&ma, &mb, p);
}

__global__ void __launch_bounds__(kGemmThreads, 1)
ce_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb, const DwPolicy p) {
  gemm_body(&ma, &mb, p);
}

// Per row: the splits' partial terms folded in split order into lse, the
// target logit and the argmax (a later split only on a strictly greater
// value). Grid (ceil(N / kThreads)).
__global__ void __launch_bounds__(kThreads)
ce_fwd_combine_kernel(const float* __restrict__ part, const int32_t* __restrict__ part_idx,
                      float* __restrict__ lse, float* __restrict__ tgt_logit,
                      int32_t* __restrict__ best, int N, int splits, int with_argmax) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= N) return;
  const size_t plane = static_cast<size_t>(splits) * N;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[static_cast<size_t>(s) * N + row]);
  float l = 0.f, tl = 0.f, bv = -INFINITY;
  int bi = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t at = static_cast<size_t>(s) * N + row;
    l += part[plane + at] * expf(part[at] - m);
    tl += part[2 * plane + at];
    if (part[3 * plane + at] > bv) {
      bv = part[3 * plane + at];
      bi = part_idx[at];
    }
  }
  lse[row] = m + logf(l);
  tgt_logit[row] = tl;
  best[row] = with_argmax ? bi : 0;
}

// dh[e] = bf16(sum over the splits, in order, of part[s][e]), e < n.
__global__ void __launch_bounds__(kThreads)
ce_bwd_dh_combine_kernel(const float* __restrict__ part, bf16* __restrict__ dh, int n,
                         int splits) {
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[static_cast<size_t>(s) * n + e];
    dh[e] = __float2bfloat16_rn(sum);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

size_t fwd_smem() { return sizeof(float) * (kFT * (kKC + 1) + kKC * (kFV + 1)); }
size_t dw_smem(int dim) {
  return sizeof(float) * (static_cast<size_t>(dim) * kWV + kWT * (kKC + 1) + kKC * (kWV + 1) +
                          kWT * (kWV + 1) + 4 * kWT);
}
size_t dh_smem(int dim) {
  return sizeof(float) * (static_cast<size_t>(kHT) * dim + kHT * (kKC + 1) + kKC * (kHV + 1) +
                          kHT * (kHV + 1) + 4 * kHT);
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

using I32 = int32_t;

int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

int cdiv(long a, long b) { return static_cast<int>((a + b - 1) / b); }

// The number of splits (1 .. max_splits) of `tiles` equal work units that
// fills the SMs' waves best; the fewest at a tie.
int pick_splits(int tiles, int max_splits) {
  const int sms = num_sms();
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= max_splits; ++s) {
    const long units = static_cast<long>(tiles) * s;
    const double fill = static_cast<double>(units) / (static_cast<double>(cdiv(units, sms)) * sms);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

// `blocks` cut into `splits` runs of `per_split` blocks: the last run may
// be short, and runs that would get no block are dropped, so the returned
// split count is the one launched.
int cut(int blocks, int splits, int* per_split) {
  *per_split = cdiv(blocks, splits);
  return cdiv(blocks, *per_split);
}

// The forward's vocab splits (their 256-column tiles per split in *per).
int fwd_splits(int N, int Vp, int* per) {
  const int n_tiles = cdiv(Vp, kBN);
  return cut(n_tiles, pick_splits(cdiv(N, kBM), std::min(kMaxSplits, n_tiles)), per);
}

// dH's vocab splits for a chunk of `rows` rows (their k-blocks per split in
// *per).
int dh_splits(int rows, int dim, int ldw, int* per) {
  const int k_blocks = cdiv(ldw, kBK);
  return cut(k_blocks, pick_splits(cdiv(rows, kBM) * cdiv(dim, kBN),
                                   std::min(kMaxSplits, k_blocks)), per);
}

// Rows per backward chunk: as few chunks as keep the d workspace
// [C][ldw] bf16 within 1 GiB, of equal size (a multiple of kBM), or the
// caller's `requested` rows.
int chunk_rows(int N, int ldw, int requested) {
  if (requested > 0) return std::min(requested, N);
  const long cap = std::max<long>(kBM, (1l << 30) / (2l * ldw) / kBM * kBM);
  const int chunks = cdiv(N, cap);
  return std::min<long>(N, static_cast<long>(cdiv(cdiv(N, chunks), kBM)) * kBM);
}

int grid_for(int units) { return std::min(units, num_sms()); }

int fwd_bf16(const void* h, const void* w, int ldw, const void* targets, void* part,
             void* part_idx, void* lse, void* tgt, void* best, int N, int dim, int Vp, int vocab,
             int with_argmax, cudaStream_t s) {
  if (dim % 8 != 0 || ldw % 8 != 0 || ldw < Vp) return -5;
  static const int allowed_t = allow_smem(ce_fwd_wgmma_kernel<true>);
  static const int allowed_f = allow_smem(ce_fwd_wgmma_kernel<false>);
  CUtensorMap ma, mb;
  int err = make_tensor_map(&ma, h, N, dim, dim, kBM);
  if (err == 0) err = make_tensor_map(&mb, w, dim, ldw, ldw, kBK);
  if (err != 0) return err;
  int per_split;
  const int m_tiles = cdiv(N, kBM), n_tiles = cdiv(Vp, kBN);
  const int splits = fwd_splits(N, Vp, &per_split), units = m_tiles * splits;
  if (with_argmax) {
    const FwdPolicy<true> p{static_cast<const I32*>(targets), static_cast<float*>(part),
                            static_cast<I32*>(part_idx), N, Vp, vocab, m_tiles, n_tiles, splits,
                            per_split, cdiv(dim, kBK), units};
    err = launch(allowed_t, ce_fwd_wgmma_kernel<true>, dim3(grid_for(units)), kGemmThreads,
                 kGemmSmem, s, ma, mb, p);
  } else {
    const FwdPolicy<false> p{static_cast<const I32*>(targets), static_cast<float*>(part),
                             static_cast<I32*>(part_idx), N, Vp, vocab, m_tiles, n_tiles, splits,
                             per_split, cdiv(dim, kBK), units};
    err = launch(allowed_f, ce_fwd_wgmma_kernel<false>, dim3(grid_for(units)), kGemmThreads,
                 kGemmSmem, s, ma, mb, p);
  }
  if (err != 0) return err;
  return launch(0, ce_fwd_combine_kernel, dim3(cdiv(N, kThreads)), kThreads, 0, s,
                static_cast<const float*>(part), static_cast<const I32*>(part_idx),
                static_cast<float*>(lse), static_cast<float*>(tgt), static_cast<I32*>(best), N,
                splits, with_argmax);
}

int bwd_bf16(const void* h, const void* w, int ldw, const void* targets, const void* lse,
             const void* g_lse, const void* g_tgt, void* ws, void* part, void* dh, void* dw,
             int N, int dim, int Vp, int vocab, int requested_rows, cudaStream_t s) {
  if (dim % 8 != 0 || ldw % 8 != 0 || ldw < Vp) return -5;
  static const int allowed_d = allow_smem(ce_bwd_d_wgmma_kernel);
  static const int allowed_h = allow_smem(ce_bwd_dh_wgmma_kernel);
  static const int allowed_w = allow_smem(ce_bwd_dw_wgmma_kernel);
  const bf16* hb = static_cast<const bf16*>(h);
  bf16* wsb = static_cast<bf16*>(ws);
  CUtensorMap w_mn, w_k;
  int err = make_tensor_map(&w_mn, w, dim, ldw, ldw, kBK);
  if (err == 0) err = make_tensor_map(&w_k, w, dim, ldw, ldw, kBN);
  if (err != 0) return err;
  const int C = chunk_rows(N, ldw, requested_rows);
  for (int c0 = 0; c0 < N; c0 += C) {
    const int rows = std::min(C, N - c0);
    const bf16* hc = hb + static_cast<size_t>(c0) * dim;
    CUtensorMap h_k, h_mn, d_k, d_mn;
    err = make_tensor_map(&h_k, hc, rows, dim, dim, kBM);
    if (err == 0) err = make_tensor_map(&h_mn, hc, rows, dim, dim, kBK);
    if (err == 0) err = make_tensor_map(&d_k, ws, rows, ldw, ldw, kBM);
    if (err == 0) err = make_tensor_map(&d_mn, ws, rows, ldw, ldw, kBK);
    if (err != 0) return err;
    const int m_tiles = cdiv(rows, kBM);
    const DPolicy pd{static_cast<const float*>(lse), static_cast<const float*>(g_lse),
                     static_cast<const float*>(g_tgt), static_cast<const I32*>(targets), wsb,
                     c0, rows, ldw, Vp, vocab, m_tiles, cdiv(dim, kBK),
                     m_tiles * cdiv(Vp, kBN)};
    err = launch(allowed_d, ce_bwd_d_wgmma_kernel, dim3(grid_for(pd.units)), kGemmThreads,
                     kGemmSmem, s, h_k, w_mn, pd);
    if (err != 0) return err;
    int per_split;
    const int splits = dh_splits(rows, dim, ldw, &per_split);
    const DhPolicy ph{static_cast<float*>(part), rows, dim, m_tiles, cdiv(dim, kBN), per_split,
                      cdiv(ldw, kBK), splits * m_tiles * cdiv(dim, kBN)};
    err = launch(allowed_h, ce_bwd_dh_wgmma_kernel, dim3(grid_for(ph.units)), kGemmThreads,
                 kGemmSmem, s, d_k, w_k, ph);
    if (err != 0) return err;
    const int n = rows * dim;
    err = launch(0, ce_bwd_dh_combine_kernel, dim3(std::min(cdiv(n, kThreads), 8 * num_sms())),
                 kThreads, 0, s, static_cast<const float*>(part),
                 static_cast<bf16*>(dh) + static_cast<size_t>(c0) * dim, n, splits);
    if (err != 0) return err;
    const DwPolicy pw{static_cast<float*>(dw), Vp, dim, Vp, c0 > 0 ? 1 : 0, cdiv(dim, kBM),
                      cdiv(rows, kBK), cdiv(dim, kBM) * cdiv(Vp, kBN)};
    err = launch(allowed_w, ce_bwd_dw_wgmma_kernel, dim3(grid_for(pw.units)), kGemmThreads,
                 kGemmSmem, s, h_mn, d_mn, pw);
    if (err != 0) return err;
  }
  return 0;
}

int fwd_f32(const void* h, const void* w, const void* t, void* lse, void* tgt, void* best, int N,
            int dim, int Vp, int vocab, int with_argmax, cudaStream_t s) {
  static const int allowed = allow_smem(ce_fwd_kernel);
  return launch(allowed, ce_fwd_kernel, dim3((N + kFT - 1) / kFT), kThreads, fwd_smem(), s,
                static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const I32*>(t), static_cast<float*>(lse), static_cast<float*>(tgt),
                static_cast<I32*>(best), N, dim, Vp, vocab, with_argmax);
}

int dw_f32(const void* h, const void* w, const void* t, const void* lse, const void* gl,
           const void* gt, void* dw, int N, int dim, int Vp, int vocab, cudaStream_t s) {
  static const int allowed = allow_smem(ce_bwd_dw_kernel);
  return launch(allowed, ce_bwd_dw_kernel, dim3((Vp + kWV - 1) / kWV), kThreads, dw_smem(dim), s,
                static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const I32*>(t), static_cast<const float*>(lse),
                static_cast<const float*>(gl), static_cast<const float*>(gt),
                static_cast<float*>(dw), N, dim, Vp, vocab);
}

int dh_f32(const void* h, const void* w, const void* t, const void* lse, const void* gl,
           const void* gt, void* dh, int N, int dim, int Vp, int vocab, cudaStream_t s) {
  static const int allowed = allow_smem(ce_bwd_dh_kernel);
  return launch(allowed, ce_bwd_dh_kernel, dim3((N + kHT - 1) / kHT), kThreads, dh_smem(dim), s,
                static_cast<const float*>(h), static_cast<const float*>(w),
                static_cast<const I32*>(t), static_cast<const float*>(lse),
                static_cast<const float*>(gl), static_cast<const float*>(gt),
                static_cast<float*>(dh), N, dim, Vp, vocab);
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its first failing launch
// (0 when all launched), -2 for shared memory over the cap (dim too large,
// f32), -3 when the driver has no cuTensorMapEncodeTiled, -4 when a tensor
// map cannot be made, -5 when dim or the padded vocab ldw is no multiple
// of 8 (TMA's 16-byte strides).

// f32: the CUDA-core forward, dW and dH kernels.
int tk_ce_fwd_f32(const void* h, const void* w, const void* targets, void* lse, void* tgt,
                  void* best, int N, int dim, int Vp, int vocab, int with_argmax, void* stream) {
  return fwd_f32(h, w, targets, lse, tgt, best, N, dim, Vp, vocab, with_argmax,
                 static_cast<cudaStream_t>(stream));
}

int tk_ce_bwd_dw_f32(const void* h, const void* w, const void* targets, const void* lse,
                     const void* g_lse, const void* g_tgt, void* dw, int N, int dim, int Vp,
                     int vocab, void* stream) {
  return dw_f32(h, w, targets, lse, g_lse, g_tgt, dw, N, dim, Vp, vocab,
                static_cast<cudaStream_t>(stream));
}

int tk_ce_bwd_dh_f32(const void* h, const void* w, const void* targets, const void* lse,
                     const void* g_lse, const void* g_tgt, void* dh, int N, int dim, int Vp,
                     int vocab, void* stream) {
  return dh_f32(h, w, targets, lse, g_lse, g_tgt, dh, N, dim, Vp, vocab,
                static_cast<cudaStream_t>(stream));
}

// bf16. The forward's vocab splits (its partial buffers are [4][splits][N]
// f32 and [splits][N] int32).
int tk_ce_fwd_splits(int N, int Vp) {
  int per;
  return fwd_splits(N, Vp, &per);
}

// The backward's plan for W [dim][ldw]: out = {rows per chunk, chunks, f32
// elements of the dH partial buffer}; its workspace is [rows per chunk][ldw]
// bf16.
int tk_ce_bwd_plan(int N, int dim, int ldw, int requested_rows, int* out) {
  const int C = chunk_rows(N, ldw, requested_rows);
  const int last = N - (cdiv(N, C) - 1) * C;
  int per;
  out[0] = C;
  out[1] = cdiv(N, C);
  out[2] = std::max(dh_splits(C, dim, ldw, &per) * C, dh_splits(last, dim, ldw, &per) * last) *
           dim;
  return 0;
}

// h [N][dim], W [dim][ldw] (columns >= Vp are zeros), `part`/`part_idx` as
// tk_ce_fwd_splits says.
int tk_ce_fwd_bf16(const void* h, const void* w, int ldw, const void* targets, void* part,
                   void* part_idx, void* lse, void* tgt, void* best, int N, int dim, int Vp,
                   int vocab, int with_argmax, void* stream) {
  return fwd_bf16(h, w, ldw, targets, part, part_idx, lse, tgt, best, N, dim, Vp, vocab,
                  with_argmax, static_cast<cudaStream_t>(stream));
}

// dh [N][dim] bf16, dw [dim][Vp] f32; `ws` and `part` as tk_ce_bwd_plan
// says for the same `requested_rows` (0: the 1 GiB rule).
int tk_ce_bwd_bf16(const void* h, const void* w, int ldw, const void* targets, const void* lse,
                   const void* g_lse, const void* g_tgt, void* ws, void* part, void* dh, void* dw,
                   int N, int dim, int Vp, int vocab, int requested_rows, void* stream) {
  return bwd_bf16(h, w, ldw, targets, lse, g_lse, g_tgt, ws, part, dh, dw, N, dim, Vp, vocab,
                  requested_rows, static_cast<cudaStream_t>(stream));
}

const char* tk_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
