// The grouped-expert FFN for Hopper (sm_90a): forward in two kernels (up,
// down) and backward in four (dh, dx, dWu, dWd), over rows sorted by expert.
//
// Replaces the Pallas TPU kernels of tpukit/ops/moe_gemm.py:
//   - `_fwd_kernel` (:110) launched by `_grouped_ffn_fwd_call` (:241, call :248);
//   - `_bwd_kernel` (:145) launched by `_grouped_ffn_bwd_call` (:262, call :267).
//
// Inputs: rows xs [M, D] sorted by expert; the bank Wu [E, D, F], bu [E, F],
// Wd [E, F, D], bd [E, D], all in the compute dtype T; offsets [E+1] int32,
// expert e owning rows [offsets[e], offsets[e+1]) (offsets[0] = 0,
// offsets[E] = M, E <= 32). Per row of segment e, rounding where tpukit
// rounds (:125-142, :175-214):
//   forward   h  = round_T(relu(x Wu[e] + bu[e]))            (f32 sums)
//             y  = round_T(relu(h Wd[e] + bd[e]))
//   backward  dz2 = g where y > 0 (g is already in T: exact)
//             dWd[e] = h^T dz2, dbd[e] = sum dz2              (f32 out)
//             dz1 = (dz2 Wd[e]^T) where h > 0                 (f32)
//             dWu[e] = x^T round_T(dz1), dbu[e] = sum dz1      (f32, dz1 unrounded)
//             dx  = round_T(round_T(dz1) Wu[e]^T)
// The forward keeps h, rounded to T, for the backward (M x F x 2 bytes in
// bf16: 126 MB per layer at the recipe shape below) instead of recomputing
// it as tpukit does: the same bits (tpukit rounds h to T before the down
// product and before dWd), a fifth product saved. The relu mask of dz1
// reads the rounded h, which is > 0 exactly where the f32 h is, except for
// an f32 h below bf16's smallest subnormal.
//
// Design. tpukit walks 512-row blocks in order and accumulates dW in output
// blocks it revisits (:155-160); here blocks run in parallel and in no
// order, so:
//   - Row kernels (up, down, dh, dx) run on one-expert row tiles: BM rows
//     of one segment (a segment's last tile partial). Each block reads
//     `offsets` itself and finds its tile (segment e has ceil(n_e / BM)
//     tiles); the grid is launched at the bound ceil(M / BM) + E tiles and
//     idle blocks exit, so no host sync is needed and empty experts and
//     1-row segments cost nothing. Blocks along y cover BN output columns.
//   - Weight kernels (dWu, dWd) run a block per (expert, BM x BN tile of
//     dW) that loops over the expert's rows in order, with no atomics: the
//     results do not change from run to run. dbd sums dz2 from the staged
//     tiles of the dWd blocks of the first tile row; dbu sums the dh
//     kernel's per-tile f32 column sums of dz1, in tile order.
//   - Every product stages BK-deep chunks of both operands in shared memory
//     with 16-byte loads, fetching the next chunk into registers while the
//     current one is multiplied (fused_head_ce.cu's staging). bf16: WMMA
//     16x16x16 on the tensor cores, f32 accumulation (a bf16 x bf16 product
//     is exact in f32); 128 x 128 tiles, 8 warps of 64 x 32. f32: CUDA cores
//     in true f32, 64 x 64 tiles, 4 x 4 per thread. Transposed operands
//     (Wd^T, Wu^T, x^T, h^T) are staged as stored and read through
//     col-major fragments.
//
// Bound. The ExpertParallel 1 x 1 path of recipe 8 at GPT-2-small width
// (batch 32, S 512, E 8, top-1, capacity factor 1.25) runs C = 80 rows per
// (expert, batch row): M = 20480 rows, D 768, F 3072, bf16. The forward is
// 2 products, 4 M D F = 193.3 GFLOP: 0.195 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 138.5 MB (xs, y, the 75.5 MB bank; 0.041 ms at
// 3.35 TB/s). The backward is 4 products, 386.5 GFLOP: 0.391 ms, against
// 478 MB (xs, g, y, h, the bank, dx, the f32 dW; 0.143 ms). Operations
// bound both. One decode tick of MoE serving (16 rows) reads the bank of
// every expert it routes to, at most 75.5 MB: bytes bound it (0.023 ms).
// Not done yet: wgmma, TMA, a persistent schedule, and one kernel for dWu
// and dWd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxExperts = 32;     // tpukit's _MAX_VMEM_EXPERTS
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// Tile shapes per compute dtype: output BM x BN, reduction chunk BK, and the
// row padding of the staged operands (16 bytes).
template <typename T> struct Tiles;
template <> struct Tiles<bf16> {
  static constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
};
template <> struct Tiles<float> {
  static constexpr int BM = 64, BN = 64, BK = 16, PAD = 4;
};

__host__ __device__ constexpr size_t round128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Shared memory of a block: the schedule (offsets and first tiles, E + 1
// ints each), the f32 output tile, and the staged A and B chunks. AT: A is
// staged [BK][BM] (a transposed operand); BT: B is staged [BN][BK].
template <typename T, bool AT, bool BT>
struct Smem {
  using TT = Tiles<T>;
  static constexpr int lda = AT ? TT::BM + TT::PAD : TT::BK + TT::PAD;
  static constexpr int ldb = BT ? TT::BK + TT::PAD : TT::BN + TT::PAD;
  static constexpr int ldc = TT::BN + 4;
  static constexpr int a_elems = AT ? TT::BK * lda : TT::BM * lda;
  static constexpr int b_elems = BT ? TT::BN * ldb : TT::BK * ldb;
  static constexpr size_t bytes = 2 * round128(4 * (kMaxExperts + 1)) +
                                  round128(4 * TT::BM * ldc) + round128(sizeof(T) * a_elems) +
                                  round128(sizeof(T) * b_elems);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Carve shared memory: `n` elements of E at `*cursor`, the cursor moved on
// by a multiple of 128 bytes (WMMA wants 32-byte aligned tiles).
template <typename E>
__device__ __forceinline__ E* carve(unsigned char*& cursor, size_t n) {
  E* out = reinterpret_cast<E*>(cursor);
  cursor += round128(n * sizeof(E));
  return out;
}

// 16 bytes of row gr, columns [gc, gc + 16 / sizeof(T)) of a row-major
// matrix (ld columns; zeros outside rows [0, R) and columns [0, Cn)): one
// 16-byte load where the run is whole and aligned, element by element
// otherwise.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ src, int ld, int gr, int gc,
                                          int R, int Cn) {
  constexpr int kVec = 16 / sizeof(T);
  const T* p = src + static_cast<size_t>(gr) * ld + gc;
  if (gr < R && gc + kVec <= Cn && reinterpret_cast<uintptr_t>(p) % 16 == 0)
    return *reinterpret_cast<const uint4*>(p);
  T o[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) o[k] = (gr < R && gc + k < Cn) ? p[k] : from_f32<T>(0.f);
  uint4 out;
  memcpy(&out, o, sizeof(out));  // not a cast: T and uint4 may not alias
  return out;
}

// x where m > 0, else 0, element by element (dz2 = g where y > 0).
template <typename T>
__device__ __forceinline__ uint4 keep_where_positive(uint4 x, uint4 m) {
  constexpr int kVec = 16 / sizeof(T);
  T xv[kVec], mv[kVec];
  memcpy(xv, &x, sizeof(x));
  memcpy(mv, &m, sizeof(m));
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (!(to_f32(mv[k]) > 0.f)) xv[k] = from_f32<T>(0.f);
  memcpy(&x, xv, sizeof(x));
  return x;
}

// An R x C block of a row-major matrix, staged into shared memory in two
// steps so the next chunk's loads are in flight while the current one is
// multiplied: `fetch(k0)` loads the chunk at reduction offset k0 into
// registers (KROWS: k runs along the matrix's rows, else along its
// columns), `put` writes it to shared memory (row stride lds). MASKED: the
// block is src where msk > 0 (msk has src's layout).
template <typename T, int R, int C, bool KROWS, bool MASKED>
struct Stage {
  static constexpr int kVec = 16 / sizeof(T);
  static_assert(C % kVec == 0, "whole 16-byte runs");
  static constexpr int kVecs = R * C / kVec;
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  const T* src;
  const T* msk;
  int ld, r0, c0, rows, cols;
  uint4 v[kPer];
  uint4 m[MASKED ? kPer : 1];

  __device__ __forceinline__ Stage(const T* s, const T* mk, int ld_, int r0_, int c0_,
                                   int rows_, int cols_)
      : src(s), msk(mk), ld(ld_), r0(r0_), c0(c0_), rows(rows_), cols(cols_) {}

  __device__ __forceinline__ void fetch(int k0) {
    const int rb = r0 + (KROWS ? k0 : 0), cb = c0 + (KROWS ? 0 : k0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kVecs) {
        const int rr = e / (C / kVec), cc = e % (C / kVec) * kVec;
        v[i] = load_vec(src, ld, rb + rr, cb + cc, rows, cols);
        if constexpr (MASKED) m[i] = load_vec(msk, ld, rb + rr, cb + cc, rows, cols);
      }
    }
  }

  __device__ __forceinline__ void put(T* S, int lds) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kVecs) {
        const int rr = e / (C / kVec), cc = e % (C / kVec) * kVec;
        uint4 x = v[i];
        if constexpr (MASKED) x = keep_where_positive<T>(x, m[i]);
        *reinterpret_cast<uint4*>(S + rr * lds + cc) = x;
      }
    }
  }
};

struct NoHook {
  template <typename P>
  __device__ __forceinline__ void operator()(const P*, int) const {}
};

// C[BM][ldc] (f32, shared) = A . B over a reduction of K, A and B streamed
// by their Stages in BK chunks through As and Bs. `hook(Bs, ldb)` sees each
// staged B chunk. Ends with a barrier: C is complete for every thread.
template <typename T, bool AT, bool BT, class SA, class SB, class Hook>
__device__ __forceinline__ void gemm(float* C, T* As, T* Bs, SA& sa, SB& sb, int K, Hook hook) {
  using TT = Tiles<T>;
  using L = Smem<T, AT, BT>;
  constexpr int BM = TT::BM, BN = TT::BN, BK = TT::BK;
  constexpr int lda = L::lda, ldb = L::ldb, ldc = L::ldc;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int WC = 4, PR = BM / 16 / 2, PC = BN / 16 / WC;  // 8 warps: 2 x 4
    using LA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
    const int fr0 = (warp / WC) * PR, fc0 = (warp % WC) * PC;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PR][PC];
#pragma unroll
    for (int i = 0; i < PR; ++i)
#pragma unroll
      for (int j = 0; j < PC; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    sa.fetch(0);
    sb.fetch(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // the previous chunk is no longer read
      sa.put(As, lda);
      sb.put(Bs, ldb);
      __syncthreads();
      hook(Bs, ldb);
      if (k0 + BK < K) {
        sa.fetch(k0 + BK);
        sb.fetch(k0 + BK);
      }
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a[PR];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[PC];
#pragma unroll
        for (int i = 0; i < PR; ++i)
          wmma::load_matrix_sync(
              a[i], AT ? As + ks * lda + (fr0 + i) * 16 : As + (fr0 + i) * 16 * lda + ks, lda);
#pragma unroll
        for (int j = 0; j < PC; ++j)
          wmma::load_matrix_sync(
              b[j], BT ? Bs + (fc0 + j) * 16 * ldb + ks : Bs + ks * ldb + (fc0 + j) * 16, ldb);
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
  } else {
    constexpr int TM = BM / 16, TN = BN / 16;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[TM][TN] = {};
    sa.fetch(0);
    sb.fetch(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // the previous chunk is no longer read
      sa.put(As, lda);
      sb.put(Bs, ldb);
      __syncthreads();
      hook(Bs, ldb);
      if (k0 + BK < K) {
        sa.fetch(k0 + BK);
        sb.fetch(k0 + BK);
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = ty + 16 * i;
          a[i] = AT ? As[kk * lda + m] : As[m * lda + kk];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tx + 16 * j;
          b[j] = BT ? Bs[n * ldb + kk] : Bs[kk * ldb + n];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
}

// Thread 0 reads the segment offsets into s_off and the first row tile of
// each expert into s_cum (E + 1 entries each; segment e has ceil(n_e / BM)
// tiles); then every thread may read them.
__device__ __forceinline__ void plan_tiles(const int32_t* __restrict__ offsets, int E, int BM,
                                           int* s_off, int* s_cum) {
  if (threadIdx.x == 0) {
    for (int e = 0; e <= E; ++e) s_off[e] = offsets[e];
    int cum = 0;
    for (int e = 0; e < E; ++e) {
      s_cum[e] = cum;
      const int n = s_off[e + 1] - s_off[e];
      cum += n > 0 ? (n + BM - 1) / BM : 0;
    }
    s_cum[E] = cum;
  }
  __syncthreads();
}

struct RowTile {
  int e, r0, r1;
};

// Row tile t: its expert and rows [r0, r1). False past the last tile.
__device__ __forceinline__ bool find_tile(int t, int E, int BM, const int* s_off,
                                          const int* s_cum, RowTile& rt) {
  if (t >= s_cum[E]) return false;
  int e = 0;
  while (t >= s_cum[e + 1]) ++e;
  rt.e = e;
  rt.r0 = s_off[e] + (t - s_cum[e]) * BM;
  rt.r1 = min(rt.r0 + BM, s_off[e + 1]);
  return true;
}

// The row kernels' epilogues.
enum Epilogue { kBiasRelu = 0, kDz1 = 1, kRound = 2 };

// out[row, n0 ..] for the rows of one expert's row tile, over a reduction
// of K: grid (ceil(M / BM) + E, ceil(N / BN)), kThreads threads.
//   kBiasRelu (up, down): out = round(relu(a . w[e] + bias[e])), w[e] [K, N];
//   kDz1 (dh): A = a where a_mask > 0 (g where y > 0), w[e] [N, K] read as
//     its transpose; dz1 = A . w[e]^T where h > 0; out = round(dz1) and
//     part[t, n] = the tile's column sums of the f32 dz1;
//   kRound (dx): out = round(a . w[e]^T), w[e] [N, K].
template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
moe_rows_kernel(const T* __restrict__ a, const T* __restrict__ a_mask, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ h,
                const int32_t* __restrict__ offsets, T* __restrict__ out,
                float* __restrict__ part, int N, int K, int E) {
  using TT = Tiles<T>;
  constexpr int BM = TT::BM, BN = TT::BN, BK = TT::BK;
  constexpr bool BT = EPI != kBiasRelu, MASKED = EPI == kDz1;
  using L = Smem<T, false, BT>;
  extern __shared__ __align__(128) float smem[];
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  int* s_off = carve<int>(cur, kMaxExperts + 1);
  int* s_cum = carve<int>(cur, kMaxExperts + 1);
  float* C = carve<float>(cur, BM * L::ldc);
  T* As = carve<T>(cur, L::a_elems);
  T* Bs = carve<T>(cur, L::b_elems);
  plan_tiles(offsets, E, BM, s_off, s_cum);
  RowTile rt;
  if (!find_tile(blockIdx.x, E, BM, s_off, s_cum, rt)) return;
  const int n0 = blockIdx.y * BN;
  const T* we = w + static_cast<size_t>(rt.e) * N * K;
  Stage<T, BM, BK, false, MASKED> sa(a, a_mask, K, rt.r0, 0, rt.r1, K);
  if constexpr (BT) {
    Stage<T, BN, BK, false, false> sb(we, nullptr, K, n0, 0, N, K);
    gemm<T, false, true>(C, As, Bs, sa, sb, K, NoHook{});
  } else {
    Stage<T, BK, BN, true, false> sb(we, nullptr, N, 0, n0, K, N);
    gemm<T, false, false>(C, As, Bs, sa, sb, K, NoHook{});
  }
  constexpr int ldc = L::ldc;
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN, row = rt.r0 + r, col = n0 + c;
    const bool in = row < rt.r1 && col < N;
    const size_t at = static_cast<size_t>(row) * N + col;
    if constexpr (EPI == kBiasRelu) {
      if (in) out[at] = from_f32<T>(fmaxf(C[r * ldc + c] + to_f32(bias[rt.e * N + col]), 0.f));
    } else if constexpr (EPI == kRound) {
      if (in) out[at] = from_f32<T>(C[r * ldc + c]);
    } else {
      float v = 0.f;
      if (in) {
        v = to_f32(h[at]) > 0.f ? C[r * ldc + c] : 0.f;
        out[at] = from_f32<T>(v);
      }
      C[r * ldc + c] = v;
    }
  }
  if constexpr (EPI == kDz1) {
    __syncthreads();
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      const int col = n0 + c;
      if (col >= N) continue;
      float s = 0.f;
      for (int r = 0; r < rt.r1 - rt.r0; ++r) s += C[r * ldc + c];
      part[static_cast<size_t>(blockIdx.x) * N + col] = s;
    }
  }
}

// dW[e] [Mo, N] = a^T . b over the rows of segment e, in row order, and the
// bias gradient db[e] [N] from the blocks of the first tile row: grid
// (ceil(N / BN), ceil(Mo / BM), E), kThreads threads. a [M, Mo], b [M, N].
//   DBD (dWd, dbd): b is g where b_mask (y) > 0; db sums the staged b.
//   else (dWu, dbu): b is round(dz1); db sums `part` (the dh kernel's f32
//   column sums of dz1 per row tile) over the expert's tiles in order.
template <typename T, bool DBD>
__global__ void __launch_bounds__(kThreads)
moe_dw_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ b_mask,
              const int32_t* __restrict__ offsets, const float* __restrict__ part,
              float* __restrict__ dw, float* __restrict__ db, int Mo, int N, int E) {
  using TT = Tiles<T>;
  constexpr int BM = TT::BM, BN = TT::BN, BK = TT::BK;
  using L = Smem<T, true, false>;
  extern __shared__ __align__(128) float smem[];
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  int* s_off = carve<int>(cur, kMaxExperts + 1);
  int* s_cum = carve<int>(cur, kMaxExperts + 1);
  float* C = carve<float>(cur, BM * L::ldc);
  T* As = carve<T>(cur, L::a_elems);
  T* Bs = carve<T>(cur, L::b_elems);
  plan_tiles(offsets, E, TT::BM, s_off, s_cum);  // the row kernels' tiles, for dbu
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int seg0 = s_off[e], seg1 = s_off[e + 1];
  const bool sums = blockIdx.y == 0;
  Stage<T, BK, BM, true, false> sa(a, nullptr, Mo, seg0, m0, seg1, Mo);
  Stage<T, BK, BN, true, DBD> sb(b, b_mask, N, seg0, n0, seg1, N);
  const int tid = threadIdx.x;
  float colsum = 0.f;  // thread c < BN: column n0 + c of the staged b
  auto hook = [&](const T* S, int lds) {
    if (DBD && sums && tid < BN)
      for (int kk = 0; kk < BK; ++kk) colsum += to_f32(S[kk * lds + tid]);
  };
  gemm<T, true, false>(C, As, Bs, sa, sb, seg1 > seg0 ? seg1 - seg0 : 0, hook);
  float* dwe = dw + static_cast<size_t>(e) * Mo * N;
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN, m = m0 + r, n = n0 + c;
    if (m < Mo && n < N) dwe[static_cast<size_t>(m) * N + n] = C[r * L::ldc + c];
  }
  if (sums && tid < BN && n0 + tid < N) {
    const int col = n0 + tid;
    if constexpr (!DBD) {
      for (int t = s_cum[e]; t < s_cum[e + 1]; ++t) colsum += part[static_cast<size_t>(t) * N + col];
    }
    db[static_cast<size_t>(e) * N + col] = colsum;
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

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
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

constexpr unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T>
int forward(const void* xs, const void* wu, const void* bu, const void* wd, const void* bd,
            const void* offsets, void* h, void* y, int M, int D, int F, int E, cudaStream_t s) {
  using TT = Tiles<T>;
  const T* null = nullptr;
  static const int allowed = allow_smem(moe_rows_kernel<T, kBiasRelu>);
  const size_t smem = Smem<T, false, false>::bytes;
  const unsigned tiles = cdiv(M, TT::BM) + E;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  int code = launch(allowed, moe_rows_kernel<T, kBiasRelu>, dim3(tiles, cdiv(F, TT::BN)), smem,
                    s, static_cast<const T*>(xs), null, static_cast<const T*>(wu),
                    static_cast<const T*>(bu), null, off, static_cast<T*>(h),
                    static_cast<float*>(nullptr), F, D, E);
  if (code != 0) return code;
  return launch(allowed, moe_rows_kernel<T, kBiasRelu>, dim3(tiles, cdiv(D, TT::BN)), smem, s,
                static_cast<const T*>(h), null, static_cast<const T*>(wd),
                static_cast<const T*>(bd), null, off, static_cast<T*>(y),
                static_cast<float*>(nullptr), D, F, E);
}

template <typename T>
int backward(const void* xs, const void* g, const void* y, const void* h, const void* wu,
             const void* wd, const void* offsets, void* dz1, void* part, void* dx, void* dwu,
             void* dbu, void* dwd, void* dbd, int M, int D, int F, int E, cudaStream_t s) {
  using TT = Tiles<T>;
  const T* null = nullptr;
  static const int a_dh = allow_smem(moe_rows_kernel<T, kDz1>);
  static const int a_dx = allow_smem(moe_rows_kernel<T, kRound>);
  static const int a_dwu = allow_smem(moe_dw_kernel<T, false>);
  static const int a_dwd = allow_smem(moe_dw_kernel<T, true>);
  const size_t rows_smem = Smem<T, false, true>::bytes, dw_smem = Smem<T, true, false>::bytes;
  const unsigned tiles = cdiv(M, TT::BM) + E;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  int code = launch(a_dh, moe_rows_kernel<T, kDz1>, dim3(tiles, cdiv(F, TT::BN)), rows_smem, s,
                    static_cast<const T*>(g), static_cast<const T*>(y),
                    static_cast<const T*>(wd), null, static_cast<const T*>(h), off,
                    static_cast<T*>(dz1), static_cast<float*>(part), F, D, E);
  if (code != 0) return code;
  code = launch(a_dx, moe_rows_kernel<T, kRound>, dim3(tiles, cdiv(D, TT::BN)), rows_smem, s,
                static_cast<const T*>(dz1), null, static_cast<const T*>(wu), null, null, off,
                static_cast<T*>(dx), static_cast<float*>(nullptr), D, F, E);
  if (code != 0) return code;
  code = launch(a_dwu, moe_dw_kernel<T, false>, dim3(cdiv(F, TT::BN), cdiv(D, TT::BM), E),
                dw_smem, s, static_cast<const T*>(xs), static_cast<const T*>(dz1), null, off,
                static_cast<const float*>(part), static_cast<float*>(dwu),
                static_cast<float*>(dbu), D, F, E);
  if (code != 0) return code;
  return launch(a_dwd, moe_dw_kernel<T, true>, dim3(cdiv(D, TT::BN), cdiv(F, TT::BM), E),
                dw_smem, s, static_cast<const T*>(h), static_cast<const T*>(g),
                static_cast<const T*>(y), off, static_cast<const float*>(nullptr),
                static_cast<float*>(dwd), static_cast<float*>(dbd), F, D, E);
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 bf16 (the dtype of the rows and the bank). Each returns
// cudaGetLastError() after its launches (stopping at the first failure),
// -1 for an unknown kind, -2 for more than 32 experts.
int tk_moe_fwd(int kind, const void* xs, const void* wu, const void* bu, const void* wd,
               const void* bd, const void* offsets, void* h, void* y, int M, int D, int F,
               int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > kMaxExperts) return -2;
  if (kind == 0) return forward<float>(xs, wu, bu, wd, bd, offsets, h, y, M, D, F, E, s);
  if (kind == 1) return forward<bf16>(xs, wu, bu, wd, bd, offsets, h, y, M, D, F, E, s);
  return -1;
}

int tk_moe_bwd(int kind, const void* xs, const void* g, const void* y, const void* h,
               const void* wu, const void* wd, const void* offsets, void* dz1, void* part,
               void* dx, void* dwu, void* dbu, void* dwd, void* dbd, int M, int D, int F, int E,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > kMaxExperts) return -2;
  if (kind == 0)
    return backward<float>(xs, g, y, h, wu, wd, offsets, dz1, part, dx, dwu, dbu, dwd, dbd, M, D,
                           F, E, s);
  if (kind == 1)
    return backward<bf16>(xs, g, y, h, wu, wd, offsets, dz1, part, dx, dwu, dbu, dwd, dbd, M, D,
                          F, E, s);
  return -1;
}

// Rows of the row kernels' tiles (BM) for a kind; the caller sizes the dh
// kernel's per-tile column sums, ceil(M / BM) + E rows, from it.
int tk_moe_row_tile(int kind) {
  if (kind == 0) return Tiles<float>::BM;
  if (kind == 1) return Tiles<bf16>::BM;
  return -1;
}

const char* tk_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
