// The grouped-expert FFN for Hopper (sm_90a), over rows sorted by expert.
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
// an f32 h below bf16's smallest subnormal. No atomics: every run gives the
// same bits.
//
// Bound. The ExpertParallel 1 x 1 path of recipe 8 at GPT-2-small width
// (batch 32, S 512, E 8, top-1, capacity factor 1.25) runs C = 80 rows per
// (expert, batch row): M = 20480 rows, D 768, F 3072, bf16. The forward is
// 2 products, 4 M D F = 193.3 GFLOP: 0.195 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 138.5 MB (xs, y, the 75.5 MB bank; 0.041 ms at
// 3.35 TB/s). The backward is 4 products, 386.5 GFLOP: 0.391 ms, against
// 478 MB (xs, g, y, h, the bank, dx, the f32 dW; 0.143 ms). Operations
// bound both. One decode tick of MoE serving (16 rows, top-1 over 8
// experts) reads the bank of every expert it routes to, at most 75.5 MB:
// bytes bound it (0.023 ms).
//
// bf16 design: every product runs the persistent wgmma/TMA mainloop of
// tk_gemm.cuh (shared with fused_head_ce.cu) under a policy that walks the
// expert segments, with no host sync:
//   - Work list. Each block's thread 0 reads `offsets` and plans one-expert
//     row tiles: BM rows from a segment's first row on (a segment's last
//     tile partial; empty experts get none). A unit is (row tile, 256
//     output columns[, k split]); the grid is launched at the bound of
//     (ceil(M / BM) + E) row tiles, and units past the plan are idle. TMA
//     boxes start at any row; rows past the segment are loaded, multiplied
//     and never stored.
//   - The bank through rank-3 tensor maps: Wu as [E, D, F] and Wd as
//     [E, F, D], the expert the outermost coordinate, so a box past D or F
//     reads zeros, not the next expert's weights (one expert's non-finite
//     weights stay in that expert's rows).
//   - Forward (`moe_rows_wgmma_kernel`): up = xs (K-major) x Wu[e]
//     (MN-major), the epilogue adds bu, applies relu, rounds and writes h;
//     down = h x Wd[e] the same way into y. 128 x 256 tiles, two consumer
//     warpgroups.
//   - Decode (a second tile policy the wrapper picks from M, `fwd_plan`):
//     where 128-row tiles would leave SMs idle, 64-row tiles (one consumer
//     warpgroup) and the k-blocks split over S ranges, each split's f32
//     partial to its own buffer; `moe_combine_kernel` sums them in split
//     order, adds the bias, applies relu and rounds. The splits aim at two
//     units an SM for the row tiles of min(M, E) segments: at 16 rows, 3
//     splits of the up product's 12 k-blocks and 10 of the down's 48, so
//     six routed experts give 216 up and 180 down units on 132 SMs.
//   - Backward: `moe_dz2_kernel` forms dz2 = g where y > 0 (bf16, exact;
//     TMA cannot mask on load) and per-row-tile f32 column sums of dz2;
//     dh = dz2 (K-major) x Wd[e] read K-major (= Wd[e]^T), the epilogue
//     applies the h > 0 mask, writes round(dz1) and per-row-tile f32 column
//     sums of the unrounded dz1; dx = round(dz1) x Wu[e] read K-major,
//     rounded. One launch of `moe_dw_wgmma_kernel` computes both weight
//     products (dWu[e] = xs^T round(dz1), dWd[e] = h^T dz2; both operands
//     MN-major, k an expert's rows, f32 out) over one unit list of both
//     outputs' tiles; the units of each output's first tile row also sum
//     db from the column sums, in row-tile order. A segment's last k-block
//     holds rows of the next expert: the consumers zero them in A's stage
//     before its products (tk_gemm.cuh).
// f32 instance (`--disable_amp`): CUDA cores in true f32 (not TF32): 64 x
// 64 tiles, 4 x 4 per thread, BK-deep chunks of both operands staged in
// shared memory with 16-byte loads; a block per one-expert row tile (row
// kernels) or per (expert, tile of dW) looping over the expert's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "tk_gemm.cuh"
#include "tk_hopper.cuh"
#include "tk_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxExperts = 32;     // tpukit's _MAX_VMEM_EXPERTS
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kSmallThreads = 128;  // the dz2 and combine kernels

// ---------------------------------------------------------------------------
// The segments' row tiles, planned by each block from `offsets`.
// ---------------------------------------------------------------------------

// Thread 0 writes the plan: the segment offsets (E + 1 ints) and the first
// row tile of each expert (E + 1 ints; segment e has ceil(n_e / BM) tiles,
// the last entry the total). The caller's barrier makes it visible.
__device__ __forceinline__ void plan_segments(const int32_t* __restrict__ offsets, int E, int BM,
                                              int* plan) {
  if (threadIdx.x != 0) return;
  int* off = plan;
  int* cum = plan + E + 1;
  for (int e = 0; e <= E; ++e) off[e] = offsets[e];
  int c = 0;
  for (int e = 0; e < E; ++e) {
    cum[e] = c;
    const int n = off[e + 1] - off[e];
    c += n > 0 ? (n + BM - 1) / BM : 0;
  }
  cum[E] = c;
}

__device__ __forceinline__ int planned_tiles(const int* plan, int E) { return plan[2 * E + 1]; }

struct RowTile {
  int e, r0, r1;
};

// Row tile t of the plan: its expert and rows [r0, r1). False past the last
// tile. The expert is the last one whose first tile is <= t (an empty
// expert's first tile equals the next one's, so it is passed over).
__device__ __forceinline__ bool find_row_tile(int t, int E, int BM, const int* plan,
                                              RowTile& rt) {
  const int* off = plan;
  const int* cum = plan + E + 1;
  if (t >= cum[E]) return false;
  int e = 0;
  for (int j = 1; j < E; ++j) e += t >= cum[j] ? 1 : 0;
  rt.e = e;
  rt.r0 = off[e] + (t - cum[e]) * BM;
  rt.r1 = min(rt.r0 + BM, off[e + 1]);
  return true;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ---------------------------------------------------------------------------
// bf16: the row products on the shared mainloop.
// ---------------------------------------------------------------------------

// The row products' epilogues.
enum Epilogue { kBiasRelu = 0, kDz1 = 1, kRound = 2, kPartial = 3 };

// The epilogues' stores go through shared memory: each consumer warp owns
// 16 rows of the tile and stages them in its scratch (gemm_scratch), 64
// columns at a time in bf16 or 32 in f32, rows kLd16 / kLd32 words apart
// (padded so that neither the fragment-order writes nor the row reads meet
// on a bank), then moves whole rows as 16-byte chunks, 8 lanes to a row's
// 128 bytes; the relu mask of h is read the same way. Stored in fragment
// order, 16 bytes a row per quad, they took more than half the forward
// (`moe_ablation.py`). The scratch's last 1024 bytes keep the warp's
// column sums of dz1.
constexpr int kLd16 = 36, kLd32 = 40;  // words per staged row, bf16 / f32
constexpr int kSumsAt = 2560;          // byte offset of a warp's column sums
static_assert(16 * kLd32 * 4 <= kSumsAt && kSumsAt + kBN * 4 <= kWarpScratch,
              "a consumer warp's epilogue scratch");

// out[row, n0 ..] = epilogue(a[rows of one expert's row tile] . b[e]) for
// N output columns over K = k_blocks * 64:
//   kBiasRelu (up, down): b[e] [K, N] MN-major; out = round(relu(acc +
//     bias[e])).
//   kDz1 (dh): b[e] [N, K] read K-major (its transpose); dz1 = acc where
//     h > 0; out = round(dz1), part[t, n] = row tile t's column sums of
//     the f32 dz1.
//   kRound (dx): b[e] [N, K] read K-major; out = round(acc).
//   kPartial (the decode policy, up and down): b[e] [K, N] MN-major, the
//     k-blocks cut into `splits` runs of per_split; part[s, row, n] = split
//     s's f32 sum (moe_combine_kernel finishes it).
// Unit u = (split, row tile t, column tile), the column tile fastest.
template <int EPI, int C>
struct RowsPolicy {
  static constexpr int kConsumers = C, kAMajor = 0, kBBank = 1;
  static constexpr int kBMajor = (EPI == kDz1 || EPI == kRound) ? 0 : 1;
  static constexpr int kBM = GemmCfg<C>::kBM;
  using State = NoState;
  const int32_t* offsets;
  const bf16* bias;  // kBiasRelu: [E, N]
  const bf16* h;     // kDz1: the forward's h [M, N]
  bf16* out;         // [M, N] (not kPartial)
  float* part;       // kDz1: [tiles_bound, N]; kPartial: [splits, M, N]
  int M, N, E, n_tiles, tiles_bound, per_split, k_blocks, units;

  __device__ __forceinline__ void setup() const { plan_segments(offsets, E, kBM, gemm_plan()); }
  __device__ __forceinline__ int row_tile(int u) const { return (u / n_tiles) % tiles_bound; }
  __device__ __forceinline__ int tiles(int u) const {
    return row_tile(u) < planned_tiles(gemm_plan(), E) ? 1 : 0;
  }
  __device__ __forceinline__ Tile tile(int u, int) const {
    RowTile rt;
    find_row_tile(row_tile(u), E, kBM, gemm_plan(), rt);
    const int kb0 = (u / (n_tiles * tiles_bound)) * per_split;
    return Tile{rt.r0, (u % n_tiles) * kBN, kb0, min(k_blocks, kb0 + per_split), rt.e, 0,
                INT_MAX, rt.r1, 0};
  }
  __device__ __forceinline__ void begin(State&, int, int) const {}
  __device__ __forceinline__ void end(State&, int, int) const {}

  __device__ __forceinline__ void tile_done(State&, float (&acc)[128], int u, const Tile& t,
                                            int cw) const {
    const Frag f(t, cw);
    if constexpr (EPI == kPartial) {
      float* out_s = part + static_cast<size_t>(u / (n_tiles * tiles_bound)) * M * N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = f.col0 + 8 * j;  // even; N is a multiple of 8
        if (col >= N) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (f.row0 + 8 * hh >= t.m_end) continue;
          float* p = out_s + static_cast<size_t>(f.row0 + 8 * hh) * N + col;
          p[0] = acc[4 * j + 2 * hh];
          p[1] = acc[4 * j + 2 * hh + 1];
        }
      }
      return;
    }
    const int lane = threadIdx.x % 32, wrow = f.row0 - lane / 4;
    const int warp = (static_cast<int>(threadIdx.x) - 128) / 32;
    unsigned char* sc = gemm_scratch(warp);
    float* sums = reinterpret_cast<float*>(sc + kSumsAt);
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int c0 = t.n0 + 64 * qq;
      if constexpr (EPI == kDz1) {  // h's 16 x 64 block, zeros past the segment or N
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane + 32 * i, row = wrow + c / 8, col = c0 + 8 * (c % 8);
          uint4 v{};
          if (row < t.m_end && col < N) v = ld_b128(h + static_cast<size_t>(row) * N + col);
          st_b128(sc + 4 * ((c / 8) * kLd16 + 4 * (c % 8)), v);
        }
        __syncwarp();
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * qq + jj, col = f.col0 + 8 * j;
        float b0 = 0.f, b1 = 0.f;
        if constexpr (EPI == kBiasRelu) {
          if (col < N) {
            const uint32_t bw = ld_b32(bias + static_cast<size_t>(t.e) * N + col);
            b0 = bf16_lo(bw);
            b1 = bf16_hi(bw);
          }
        }
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          unsigned char* slot = sc + 4 * ((lane / 4 + 8 * hh) * kLd16 + 4 * jj + f.q);
          float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
          if constexpr (EPI == kBiasRelu) {
            v0 = fmaxf(v0 + b0, 0.f);
            v1 = fmaxf(v1 + b1, 0.f);
          }
          if constexpr (EPI == kDz1) {
            const uint32_t hw = ld_b32(slot);
            v0 = bf16_lo(hw) > 0.f ? v0 : 0.f;
            v1 = bf16_hi(hw) > 0.f ? v1 : 0.f;
            s0 += v0;
            s1 += v1;
          }
          st_b32(slot, pack_bf16x2(v0, v1));
        }
        if constexpr (EPI == kDz1) {  // the warp's 16 rows, summed over its 8 row groups
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if (lane < 4) {
            sums[8 * j + 2 * f.q] = s0;
            sums[8 * j + 2 * f.q + 1] = s1;
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i, row = wrow + c / 8, col = c0 + 8 * (c % 8);
        if (row < t.m_end && col < N)
          st_b128(out + static_cast<size_t>(row) * N + col,
                  ld_b128(sc + 4 * ((c / 8) * kLd16 + 4 * (c % 8))));
      }
      __syncwarp();  // the scratch is free for the next 64 columns
    }
    if constexpr (EPI == kDz1) {  // the tile's column sums: the warps' in order
      named_barrier_sync(3, 128 * C);
      for (int c = static_cast<int>(threadIdx.x) - 128; c < kBN; c += 128 * C) {
        if (t.n0 + c >= N) continue;
        float s = 0.f;
        for (int w = 0; w < 4 * C; ++w) s += reinterpret_cast<const float*>(gemm_scratch(w) + kSumsAt)[c];
        part[static_cast<size_t>(row_tile(u)) * N + t.n0 + c] = s;
      }
      named_barrier_sync(3, 128 * C);  // the sums are free for the next tile
    }
  }
};

// dWu[e] = xs^T round(dz1) ([D, F]) and dWd[e] = h^T dz2 ([F, D]), f32, over
// the rows of segment e (k = rows, from the segment's first row; the last
// k-block's rows past it zeroed in A). Units: every (expert, tile) of dWu,
// then every one of dWd (tensor-map pair 0: xs, dz1; pair 1: h, dz2), the
// column tile fastest. The units of tile row 0 also write db[e] (dbu: the
// dh epilogue's column sums of dz1; dbd: the dz2 kernel's of dz2), summed
// over the expert's row tiles in order.
struct DwPolicy {
  static constexpr int kConsumers = 2, kAMajor = 1, kBMajor = 1, kBBank = 0;
  using State = NoState;
  const int32_t* offsets;
  const float* part_u;  // [row tiles, F]
  const float* part_d;  // [row tiles, D]
  float *dwu, *dbu, *dwd, *dbd;
  int D, F, E, nu, tu, nd, td, units;  // column tiles and tiles per expert of dWu, dWd

  __device__ __forceinline__ void setup() const { plan_segments(offsets, E, kBM, gemm_plan()); }
  __device__ __forceinline__ int tiles(int) const { return 1; }
  __device__ __forceinline__ Tile tile(int u, int) const {
    const int which = u >= E * tu ? 1 : 0;
    const int r = which ? u - E * tu : u, per = which ? td : tu, nt = which ? nd : nu;
    const int e = r / per, rr = r % per;
    const int* off = gemm_plan();
    const int seg0 = off[e], seg1 = off[e + 1];
    return Tile{(rr / nt) * kBM, (rr % nt) * kBN, 0, (seg1 - seg0 + kBK - 1) / kBK, e, seg0, seg1,
                INT_MAX, which};
  }
  __device__ __forceinline__ void begin(State&, int, int) const {}
  __device__ __forceinline__ void end(State&, int, int) const {}
  __device__ __forceinline__ void tile_done(State&, float (&acc)[128], int, const Tile& t,
                                            int cw) const {
    const Frag f(t, cw);
    const int mo = t.map ? F : D, no = t.map ? D : F;  // no is a multiple of 8
    float* dw = (t.map ? dwd : dwu) + static_cast<size_t>(t.e) * mo * no;
    const int lane = threadIdx.x % 32, wrow = f.row0 - lane / 4;
    unsigned char* sc = gemm_scratch((static_cast<int>(threadIdx.x) - 128) / 32);
#pragma unroll
    for (int qq = 0; qq < 8; ++qq) {  // 32 columns at a time
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * qq + jj;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* slot = reinterpret_cast<float*>(sc) + (lane / 4 + 8 * hh) * kLd32 + 8 * jj +
                        2 * f.q;
          slot[0] = acc[4 * j + 2 * hh];
          slot[1] = acc[4 * j + 2 * hh + 1];
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i, row = wrow + c / 8, col = t.n0 + 32 * qq + 4 * (c % 8);
        if (row < mo && col < no)
          st_b128(dw + static_cast<size_t>(row) * no + col,
                  ld_b128(sc + 4 * ((c / 8) * kLd32 + 4 * (c % 8))));
      }
      __syncwarp();  // the scratch is free for the next 32 columns
    }
    if (t.m0 == 0) {
      const int col = t.n0 + static_cast<int>(threadIdx.x) - 128;  // 256 consumer threads
      if (col < no) {
        const int* cum = gemm_plan() + E + 1;
        const float* part = t.map ? part_d : part_u;
        float s = 0.f;
        for (int rt = cum[t.e]; rt < cum[t.e + 1]; ++rt) s += part[static_cast<size_t>(rt) * no + col];
        (t.map ? dbd : dbu)[static_cast<size_t>(t.e) * no + col] = s;
      }
    }
  }
};

template <int EPI, int C>
__global__ void __launch_bounds__(GemmCfg<C>::kThreads, 1)
moe_rows_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                      const __grid_constant__ CUtensorMap mb, const RowsPolicy<EPI, C> p) {
  gemm_body(&ma, &mb, p);
}

struct DwMaps {
  CUtensorMap a[2], b[2];
};

__global__ void __launch_bounds__(kGemmThreads, 1)
moe_dw_wgmma_kernel(const __grid_constant__ DwMaps maps, const DwPolicy p) {
  gemm_body(maps.a, maps.b, p);
}

// dz2 = g where y > 0 over the rows of one 128-row tile of the plan, and
// the tile's f32 column sums of dz2: grid (ceil(M / 128) + E, ceil(D /
// 256)), kSmallThreads threads, two columns a thread.
__global__ void __launch_bounds__(kSmallThreads)
moe_dz2_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
               const int32_t* __restrict__ offsets, bf16* __restrict__ dz2,
               float* __restrict__ part, int D, int E) {
  extern __shared__ __align__(128) float smem[];
  int* plan = reinterpret_cast<int*>(smem);
  plan_segments(offsets, E, kBM, plan);
  __syncthreads();
  RowTile rt;
  if (!find_row_tile(blockIdx.x, E, kBM, plan, rt)) return;
  const int col = 2 * (blockIdx.y * kSmallThreads + threadIdx.x);
  if (col >= D) return;
  float s0 = 0.f, s1 = 0.f;
  for (int r = rt.r0; r < rt.r1; ++r) {
    const size_t at = static_cast<size_t>(r) * D + col;
    const uint32_t gw = ld_b32(g + at), yw = ld_b32(y + at);
    const uint32_t lo = bf16_lo(yw) > 0.f ? (gw & 0xffffu) : 0u;
    const uint32_t hi = bf16_hi(yw) > 0.f ? (gw & 0xffff0000u) : 0u;
    st_b32(dz2 + at, lo | hi);
    s0 += bf16_lo(lo);
    s1 += bf16_hi(hi);
  }
  part[static_cast<size_t>(blockIdx.x) * D + col] = s0;
  part[static_cast<size_t>(blockIdx.x) * D + col + 1] = s1;
}

// The decode policy's finish: out[row, n] = round(relu(sum over the splits,
// in order, of part[s, row, n] + bias[e, n])), e the row's expert. Grid
// (ceil(N / kSmallThreads), M), kSmallThreads threads, a column a thread.
__global__ void __launch_bounds__(kSmallThreads)
moe_combine_kernel(const float* __restrict__ part, const bf16* __restrict__ bias,
                   const int32_t* __restrict__ offsets, bf16* __restrict__ out, int M, int N,
                   int E, int splits) {
  const int row = blockIdx.y, c = blockIdx.x * kSmallThreads + threadIdx.x;
  if (c >= N) return;
  int e = 0;
  while (e + 1 < E && offsets[e + 1] <= row) ++e;
  const float* p = part + static_cast<size_t>(row) * N + c;
  float s = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) s += p[static_cast<size_t>(sp) * M * N];
  out[static_cast<size_t>(row) * N + c] =
      __float2bfloat16_rn(fmaxf(s + __bfloat162float(bias[static_cast<size_t>(e) * N + c]), 0.f));
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // f32 kernels: a 16 x 16 grid, tx = tid % 16, ty = tid / 16
constexpr int kFM = 64, kFN = 64, kFK = 16, kPad = 4;  // output tile, reduction chunk, row pad

__host__ __device__ constexpr size_t round128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Shared memory of an f32 block: the plan, the f32 output tile, and the
// staged A and B chunks. AT: A is staged [kFK][kFM] (a transposed operand);
// BT: B is staged [kFN][kFK].
template <bool AT, bool BT>
struct Smem {
  static constexpr int lda = AT ? kFM + kPad : kFK + kPad;
  static constexpr int ldb = BT ? kFK + kPad : kFN + kPad;
  static constexpr int ldc = kFN + 4;
  static constexpr int a_elems = AT ? kFK * lda : kFM * lda;
  static constexpr int b_elems = BT ? kFN * ldb : kFK * ldb;
  static constexpr size_t bytes = round128(4 * 2 * (kMaxExperts + 1)) + round128(4 * kFM * ldc) +
                                  round128(4 * a_elems) + round128(4 * b_elems);
};

// Carve shared memory: `n` elements of E at `*cursor`, the cursor moved on
// by a multiple of 128 bytes.
template <typename E>
__device__ __forceinline__ E* carve(unsigned char*& cursor, size_t n) {
  E* out = reinterpret_cast<E*>(cursor);
  cursor += round128(n * sizeof(E));
  return out;
}

// 16 bytes (4 floats) of row gr, columns [gc, gc + 4) of a row-major matrix
// (ld columns; zeros outside rows [0, R) and columns [0, Cn)): one 16-byte
// load where the run is whole and aligned, element by element otherwise.
__device__ __forceinline__ uint4 load_vec(const float* __restrict__ src, int ld, int gr, int gc,
                                          int R, int Cn) {
  const float* p = src + static_cast<size_t>(gr) * ld + gc;
  if (gr < R && gc + 4 <= Cn && reinterpret_cast<uintptr_t>(p) % 16 == 0)
    return *reinterpret_cast<const uint4*>(p);
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = (gr < R && gc + k < Cn) ? p[k] : 0.f;
  uint4 out;
  memcpy(&out, o, sizeof(out));  // not a cast: float and uint4 may not alias
  return out;
}

// x where m > 0, else 0, element by element (dz2 = g where y > 0).
__device__ __forceinline__ uint4 keep_where_positive(uint4 x, uint4 m) {
  float xv[4], mv[4];
  memcpy(xv, &x, sizeof(x));
  memcpy(mv, &m, sizeof(m));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (!(mv[k] > 0.f)) xv[k] = 0.f;
  memcpy(&x, xv, sizeof(x));
  return x;
}

// An R x C block of a row-major matrix, staged into shared memory in two
// steps so the next chunk's loads are in flight while the current one is
// multiplied: `fetch(k0)` loads the chunk at reduction offset k0 into
// registers (KROWS: k runs along the matrix's rows, else along its
// columns), `put` writes it to shared memory (row stride lds). MASKED: the
// block is src where msk > 0 (msk has src's layout).
template <int R, int C, bool KROWS, bool MASKED>
struct Stage {
  static constexpr int kVecs = R * C / 4;
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  const float* src;
  const float* msk;
  int ld, r0, c0, rows, cols;
  uint4 v[kPer];
  uint4 m[MASKED ? kPer : 1];

  __device__ __forceinline__ Stage(const float* s, const float* mk, int ld_, int r0_, int c0_,
                                   int rows_, int cols_)
      : src(s), msk(mk), ld(ld_), r0(r0_), c0(c0_), rows(rows_), cols(cols_) {}

  __device__ __forceinline__ void fetch(int k0) {
    const int rb = r0 + (KROWS ? k0 : 0), cb = c0 + (KROWS ? 0 : k0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kVecs) {
        const int rr = e / (C / 4), cc = e % (C / 4) * 4;
        v[i] = load_vec(src, ld, rb + rr, cb + cc, rows, cols);
        if constexpr (MASKED) m[i] = load_vec(msk, ld, rb + rr, cb + cc, rows, cols);
      }
    }
  }

  __device__ __forceinline__ void put(float* S, int lds) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kVecs) {
        const int rr = e / (C / 4), cc = e % (C / 4) * 4;
        uint4 x = v[i];
        if constexpr (MASKED) x = keep_where_positive(x, m[i]);
        memcpy(S + rr * lds + cc, &x, sizeof(x));
      }
    }
  }
};

struct NoHook {
  __device__ __forceinline__ void operator()(const float*, int) const {}
};

// C[kFM][ldc] (f32, shared) = A . B over a reduction of K, A and B streamed
// by their Stages in kFK chunks through As and Bs. `hook(Bs, ldb)` sees each
// staged B chunk. Ends with a barrier: C is complete for every thread.
template <bool AT, bool BT, class SA, class SB, class Hook>
__device__ __forceinline__ void gemm_f32(float* C, float* As, float* Bs, SA& sa, SB& sb, int K,
                                         Hook hook) {
  using L = Smem<AT, BT>;
  constexpr int lda = L::lda, ldb = L::ldb, ldc = L::ldc;
  constexpr int TM = kFM / 16, TN = kFN / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[TM][TN] = {};
  sa.fetch(0);
  sb.fetch(0);
  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();  // the previous chunk is no longer read
    sa.put(As, lda);
    sb.put(Bs, ldb);
    __syncthreads();
    hook(Bs, ldb);
    if (k0 + kFK < K) {
      sa.fetch(k0 + kFK);
      sb.fetch(k0 + kFK);
    }
#pragma unroll 4
    for (int kk = 0; kk < kFK; ++kk) {
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
  __syncthreads();
}

// out[row, n0 ..] for the rows of one expert's kFM-row tile, over a
// reduction of K: grid (ceil(M / kFM) + E, ceil(N / kFN)), kThreads threads.
//   kBiasRelu (up, down): out = relu(a . w[e] + bias[e]), w[e] [K, N];
//   kDz1 (dh): A = a where a_mask > 0 (g where y > 0), w[e] [N, K] read as
//     its transpose; dz1 = A . w[e]^T where h > 0; out = dz1 and
//     part[t, n] = the tile's column sums of dz1;
//   kRound (dx): out = a . w[e]^T, w[e] [N, K].
template <int EPI>
__global__ void __launch_bounds__(kThreads)
moe_rows_kernel(const float* __restrict__ a, const float* __restrict__ a_mask,
                const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ h, const int32_t* __restrict__ offsets,
                float* __restrict__ out, float* __restrict__ part, int N, int K, int E) {
  constexpr bool BT = EPI != kBiasRelu, MASKED = EPI == kDz1;
  using L = Smem<false, BT>;
  extern __shared__ __align__(128) float smem[];
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  int* plan = carve<int>(cur, 2 * (kMaxExperts + 1));
  float* C = carve<float>(cur, kFM * L::ldc);
  float* As = carve<float>(cur, L::a_elems);
  float* Bs = carve<float>(cur, L::b_elems);
  plan_segments(offsets, E, kFM, plan);
  __syncthreads();
  RowTile rt;
  if (!find_row_tile(blockIdx.x, E, kFM, plan, rt)) return;
  const int n0 = blockIdx.y * kFN;
  const float* we = w + static_cast<size_t>(rt.e) * N * K;
  Stage<kFM, kFK, false, MASKED> sa(a, a_mask, K, rt.r0, 0, rt.r1, K);
  if constexpr (BT) {
    Stage<kFN, kFK, false, false> sb(we, nullptr, K, n0, 0, N, K);
    gemm_f32<false, true>(C, As, Bs, sa, sb, K, NoHook{});
  } else {
    Stage<kFK, kFN, true, false> sb(we, nullptr, N, 0, n0, K, N);
    gemm_f32<false, false>(C, As, Bs, sa, sb, K, NoHook{});
  }
  constexpr int ldc = L::ldc;
  for (int idx = threadIdx.x; idx < kFM * kFN; idx += kThreads) {
    const int r = idx / kFN, c = idx % kFN, row = rt.r0 + r, col = n0 + c;
    const bool in = row < rt.r1 && col < N;
    const size_t at = static_cast<size_t>(row) * N + col;
    if constexpr (EPI == kBiasRelu) {
      if (in) out[at] = fmaxf(C[r * ldc + c] + bias[rt.e * N + col], 0.f);
    } else if constexpr (EPI == kRound) {
      if (in) out[at] = C[r * ldc + c];
    } else {
      float v = 0.f;
      if (in) {
        v = h[at] > 0.f ? C[r * ldc + c] : 0.f;
        out[at] = v;
      }
      C[r * ldc + c] = v;
    }
  }
  if constexpr (EPI == kDz1) {
    __syncthreads();
    for (int c = threadIdx.x; c < kFN; c += kThreads) {
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
// (ceil(N / kFN), ceil(Mo / kFM), E), kThreads threads. a [M, Mo], b [M, N].
//   DBD (dWd, dbd): b is g where b_mask (y) > 0; db sums the staged b.
//   else (dWu, dbu): b is dz1; db sums `part` (the dh kernel's column sums
//   of dz1 per row tile) over the expert's tiles in order.
template <bool DBD>
__global__ void __launch_bounds__(kThreads)
moe_dw_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ b_mask, const int32_t* __restrict__ offsets,
              const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
              int Mo, int N, int E) {
  using L = Smem<true, false>;
  extern __shared__ __align__(128) float smem[];
  unsigned char* cur = reinterpret_cast<unsigned char*>(smem);
  int* plan = carve<int>(cur, 2 * (kMaxExperts + 1));
  float* C = carve<float>(cur, kFM * L::ldc);
  float* As = carve<float>(cur, L::a_elems);
  float* Bs = carve<float>(cur, L::b_elems);
  plan_segments(offsets, E, kFM, plan);  // the row kernels' tiles, for dbu
  __syncthreads();
  const int e = blockIdx.z, m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int seg0 = plan[e], seg1 = plan[e + 1];
  const int* cum = plan + E + 1;
  const bool sums = blockIdx.y == 0;
  Stage<kFK, kFM, true, false> sa(a, nullptr, Mo, seg0, m0, seg1, Mo);
  Stage<kFK, kFN, true, DBD> sb(b, b_mask, N, seg0, n0, seg1, N);
  const int tid = threadIdx.x;
  float colsum = 0.f;  // thread c < kFN: column n0 + c of the staged b
  auto hook = [&](const float* S, int lds) {
    if (DBD && sums && tid < kFN)
      for (int kk = 0; kk < kFK; ++kk) colsum += S[kk * lds + tid];
  };
  gemm_f32<true, false>(C, As, Bs, sa, sb, seg1 > seg0 ? seg1 - seg0 : 0, hook);
  float* dwe = dw + static_cast<size_t>(e) * Mo * N;
  for (int idx = threadIdx.x; idx < kFM * kFN; idx += kThreads) {
    const int r = idx / kFN, c = idx % kFN, m = m0 + r, n = n0 + c;
    if (m < Mo && n < N) dwe[static_cast<size_t>(m) * N + n] = C[r * L::ldc + c];
  }
  if (sums && tid < kFN && n0 + tid < N) {
    const int col = n0 + tid;
    if constexpr (!DBD) {
      for (int t = cum[e]; t < cum[e + 1]; ++t) colsum += part[static_cast<size_t>(t) * N + col];
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
int launch(int allowed, Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (allowed != 0) return allowed;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(long a, long b) { return static_cast<int>((a + b - 1) / b); }

int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

int grid_for(int units) { return std::max(1, std::min(units, num_sms())); }

// `blocks` cut into `splits` runs of `per_split` blocks: runs that would get
// no block are dropped, so the returned split count is the one launched.
int cut(int blocks, int splits, int* per_split) {
  *per_split = std::max(1, cdiv(blocks, splits));
  return std::max(1, cdiv(blocks, *per_split));
}

// The bf16 forward's tile policy for M rows: the 128-row tiles of training
// where the down product's row tiles fill the SMs; else (decode, small
// prefills) 64-row tiles with the k-blocks split so that the row tiles a
// routing of M rows over E experts gives at most (min(M, E) segments) make
// at least twice the SMs' units in each product.
struct FwdPlan {
  int small, split_up, per_up, split_down, per_down;
};

FwdPlan fwd_plan(int M, int D, int F, int E) {
  const int sms = num_sms();
  FwdPlan fp{0, 1, cdiv(D, kBK), 1, cdiv(F, kBK)};
  if (static_cast<long>(cdiv(M, kBM)) * cdiv(D, kBN) >= sms) return fp;
  fp.small = 1;
  const long rows = cdiv(M, GemmCfg<1>::kBM) + std::min(M, E) - 1;
  const int want_up = cdiv(2l * sms, std::max(1l, rows * cdiv(F, kBN)));
  const int want_down = cdiv(2l * sms, std::max(1l, rows * cdiv(D, kBN)));
  fp.split_up = cut(cdiv(D, kBK), want_up, &fp.per_up);
  fp.split_down = cut(cdiv(F, kBK), want_down, &fp.per_down);
  return fp;
}

using I32 = int32_t;

template <int EPI, int C>
int launch_rows(const CUtensorMap& ma, const CUtensorMap& mb, const RowsPolicy<EPI, C>& p,
                cudaStream_t s) {
  static const int allowed = allow_smem(moe_rows_wgmma_kernel<EPI, C>);
  return launch(allowed, moe_rows_wgmma_kernel<EPI, C>, dim3(grid_for(p.units)),
                GemmCfg<C>::kThreads, GemmCfg<C>::kSmem, s, ma, mb, p);
}

int forward_bf16(const void* xs, const void* wu, const void* bu, const void* wd, const void* bd,
                 const void* offsets, void* h, void* y, void* part, int M, int D, int F, int E,
                 cudaStream_t s) {
  if (D % 8 != 0 || F % 8 != 0) return -5;
  const FwdPlan fp = fwd_plan(M, D, F, E);
  const int bm = fp.small ? GemmCfg<1>::kBM : kBM;
  const int tiles = cdiv(M, bm) + E;
  CUtensorMap a_x, b_wu, a_h, b_wd;
  int err = make_tensor_map(&a_x, xs, M, D, D, bm);
  if (err == 0) err = make_tensor_map_3d(&b_wu, wu, E, D, F, F, kBK);
  if (err == 0) err = make_tensor_map(&a_h, h, M, F, F, bm);
  if (err == 0) err = make_tensor_map_3d(&b_wd, wd, E, F, D, D, kBK);
  if (err != 0) return err;
  const auto* off = static_cast<const I32*>(offsets);
  const auto* bub = static_cast<const bf16*>(bu);
  const auto* bdb = static_cast<const bf16*>(bd);
  auto* hb = static_cast<bf16*>(h);
  auto* yb = static_cast<bf16*>(y);
  if (!fp.small) {
    const int nu = cdiv(F, kBN), nd = cdiv(D, kBN);
    const RowsPolicy<kBiasRelu, 2> up{off, bub, nullptr, hb, nullptr, M, F, E, nu, tiles,
                                      fp.per_up, cdiv(D, kBK), tiles * nu};
    err = launch_rows(a_x, b_wu, up, s);
    if (err != 0) return err;
    const RowsPolicy<kBiasRelu, 2> down{off, bdb, nullptr, yb, nullptr, M, D, E, nd, tiles,
                                        fp.per_down, cdiv(F, kBK), tiles * nd};
    return launch_rows(a_h, b_wd, down, s);
  }
  float* pf = static_cast<float*>(part);
  const int nu = cdiv(F, kBN), nd = cdiv(D, kBN);
  const RowsPolicy<kPartial, 1> up{off, nullptr, nullptr, nullptr, pf, M, F, E, nu, tiles,
                                   fp.per_up, cdiv(D, kBK), tiles * nu * fp.split_up};
  err = launch_rows(a_x, b_wu, up, s);
  if (err == 0)
    err = launch(0, moe_combine_kernel, dim3(cdiv(F, kSmallThreads), M), kSmallThreads, 0, s,
                 static_cast<const float*>(pf), bub, off, hb, M, F, E, fp.split_up);
  if (err != 0) return err;
  const RowsPolicy<kPartial, 1> down{off, nullptr, nullptr, nullptr, pf, M, D, E, nd, tiles,
                                     fp.per_down, cdiv(F, kBK), tiles * nd * fp.split_down};
  err = launch_rows(a_h, b_wd, down, s);
  if (err != 0) return err;
  return launch(0, moe_combine_kernel, dim3(cdiv(D, kSmallThreads), M), kSmallThreads, 0, s,
                static_cast<const float*>(pf), bdb, off, yb, M, D, E, fp.split_down);
}

int backward_bf16(const void* xs, const void* g, const void* y, const void* h, const void* wu,
                  const void* wd, const void* offsets, void* dz2, void* dz1, void* part_u,
                  void* part_d, void* dx, void* dwu, void* dbu, void* dwd, void* dbd, int M,
                  int D, int F, int E, cudaStream_t s) {
  if (D % 8 != 0 || F % 8 != 0) return -5;
  const int tiles = cdiv(M, kBM) + E;
  const auto* off = static_cast<const I32*>(offsets);
  int err = launch(0, moe_dz2_kernel, dim3(tiles, cdiv(D, 2 * kSmallThreads)), kSmallThreads,
                   kPlanBytes, s, static_cast<const bf16*>(g), static_cast<const bf16*>(y), off,
                   static_cast<bf16*>(dz2), static_cast<float*>(part_d), D, E);
  if (err != 0) return err;
  CUtensorMap a_dz2, b_wd, a_dz1, b_wu;
  DwMaps dm;
  err = make_tensor_map(&a_dz2, dz2, M, D, D, kBM);
  if (err == 0) err = make_tensor_map_3d(&b_wd, wd, E, F, D, D, kBN);
  if (err == 0) err = make_tensor_map(&a_dz1, dz1, M, F, F, kBM);
  if (err == 0) err = make_tensor_map_3d(&b_wu, wu, E, D, F, F, kBN);
  if (err == 0) err = make_tensor_map(&dm.a[0], xs, M, D, D, kBK);
  if (err == 0) err = make_tensor_map(&dm.b[0], dz1, M, F, F, kBK);
  if (err == 0) err = make_tensor_map(&dm.a[1], h, M, F, F, kBK);
  if (err == 0) err = make_tensor_map(&dm.b[1], dz2, M, D, D, kBK);
  if (err != 0) return err;
  const int nf = cdiv(F, kBN), nd = cdiv(D, kBN);
  const RowsPolicy<kDz1, 2> ph{off, nullptr, static_cast<const bf16*>(h), static_cast<bf16*>(dz1),
                               static_cast<float*>(part_u), M, F, E, nf, tiles, cdiv(D, kBK),
                               cdiv(D, kBK), tiles * nf};
  err = launch_rows(a_dz2, b_wd, ph, s);
  if (err != 0) return err;
  const RowsPolicy<kRound, 2> px{off, nullptr, nullptr, static_cast<bf16*>(dx), nullptr, M, D, E,
                                 nd, tiles, cdiv(F, kBK), cdiv(F, kBK), tiles * nd};
  err = launch_rows(a_dz1, b_wu, px, s);
  if (err != 0) return err;
  const int tu = cdiv(D, kBM) * nf, td = cdiv(F, kBM) * nd;
  const DwPolicy pw{off, static_cast<const float*>(part_u), static_cast<const float*>(part_d),
                    static_cast<float*>(dwu), static_cast<float*>(dbu), static_cast<float*>(dwd),
                    static_cast<float*>(dbd), D, F, E, nf, tu, nd, td, E * (tu + td)};
  static const int allowed = allow_smem(moe_dw_wgmma_kernel);
  return launch(allowed, moe_dw_wgmma_kernel, dim3(grid_for(pw.units)), kGemmThreads, kGemmSmem,
                s, dm, pw);
}

int forward_f32(const void* xs, const void* wu, const void* bu, const void* wd, const void* bd,
                const void* offsets, void* h, void* y, int M, int D, int F, int E,
                cudaStream_t s) {
  const float* null = nullptr;
  static const int allowed = allow_smem(moe_rows_kernel<kBiasRelu>);
  const size_t smem = Smem<false, false>::bytes;
  const unsigned tiles = cdiv(M, kFM) + E;
  const auto* off = static_cast<const I32*>(offsets);
  int code = launch(allowed, moe_rows_kernel<kBiasRelu>, dim3(tiles, cdiv(F, kFN)), kThreads,
                    smem, s, static_cast<const float*>(xs), null, static_cast<const float*>(wu),
                    static_cast<const float*>(bu), null, off, static_cast<float*>(h),
                    static_cast<float*>(nullptr), F, D, E);
  if (code != 0) return code;
  return launch(allowed, moe_rows_kernel<kBiasRelu>, dim3(tiles, cdiv(D, kFN)), kThreads, smem,
                s, static_cast<const float*>(h), null, static_cast<const float*>(wd),
                static_cast<const float*>(bd), null, off, static_cast<float*>(y),
                static_cast<float*>(nullptr), D, F, E);
}

int backward_f32(const void* xs, const void* g, const void* y, const void* h, const void* wu,
                 const void* wd, const void* offsets, void* dz1, void* part, void* dx,
                 void* dwu, void* dbu, void* dwd, void* dbd, int M, int D, int F, int E,
                 cudaStream_t s) {
  const float* null = nullptr;
  static const int a_dh = allow_smem(moe_rows_kernel<kDz1>);
  static const int a_dx = allow_smem(moe_rows_kernel<kRound>);
  static const int a_dwu = allow_smem(moe_dw_kernel<false>);
  static const int a_dwd = allow_smem(moe_dw_kernel<true>);
  const size_t rows_smem = Smem<false, true>::bytes, dw_smem = Smem<true, false>::bytes;
  const unsigned tiles = cdiv(M, kFM) + E;
  const auto* off = static_cast<const I32*>(offsets);
  int code = launch(a_dh, moe_rows_kernel<kDz1>, dim3(tiles, cdiv(F, kFN)), kThreads, rows_smem,
                    s, static_cast<const float*>(g), static_cast<const float*>(y),
                    static_cast<const float*>(wd), null, static_cast<const float*>(h), off,
                    static_cast<float*>(dz1), static_cast<float*>(part), F, D, E);
  if (code != 0) return code;
  code = launch(a_dx, moe_rows_kernel<kRound>, dim3(tiles, cdiv(D, kFN)), kThreads, rows_smem, s,
                static_cast<const float*>(dz1), null, static_cast<const float*>(wu), null, null,
                off, static_cast<float*>(dx), static_cast<float*>(nullptr), D, F, E);
  if (code != 0) return code;
  code = launch(a_dwu, moe_dw_kernel<false>, dim3(cdiv(F, kFN), cdiv(D, kFM), E), kThreads,
                dw_smem, s, static_cast<const float*>(xs), static_cast<const float*>(dz1), null,
                off, static_cast<const float*>(part), static_cast<float*>(dwu),
                static_cast<float*>(dbu), D, F, E);
  if (code != 0) return code;
  return launch(a_dwd, moe_dw_kernel<true>, dim3(cdiv(D, kFN), cdiv(F, kFM), E), kThreads,
                dw_smem, s, static_cast<const float*>(h), static_cast<const float*>(g),
                static_cast<const float*>(y), off, static_cast<const float*>(nullptr),
                static_cast<float*>(dwd), static_cast<float*>(dbd), F, D, E);
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 bf16 (the dtype of the rows and the bank). Each launcher
// returns cudaGetLastError() after its launches (stopping at the first
// failure), -1 for an unknown kind, -2 for more than 32 experts, -3 when the
// driver has no cuTensorMapEncodeTiled, -4 when a tensor map cannot be made,
// -5 when D or F is no multiple of 8 (bf16: TMA's 16-byte strides).

// The forward's plan: out = {decode policy (0 / 1), k splits of the up and
// the down product, f32 elements of the partial buffer `part`}.
int tk_moe_fwd_plan(int kind, int M, int D, int F, int E, int* out) {
  if (kind != 1) {
    out[0] = 0;
    out[1] = out[2] = 1;
    out[3] = 0;
    return kind == 0 ? 0 : -1;
  }
  const FwdPlan fp = fwd_plan(M, D, F, E);
  out[0] = fp.small;
  out[1] = fp.split_up;
  out[2] = fp.split_down;
  out[3] = fp.small ? std::max(fp.split_up * F, fp.split_down * D) * M : 0;
  return 0;
}

// part: as tk_moe_fwd_plan says (unused in f32).
int tk_moe_fwd(int kind, const void* xs, const void* wu, const void* bu, const void* wd,
               const void* bd, const void* offsets, void* h, void* y, void* part, int M, int D,
               int F, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > kMaxExperts) return -2;
  if (kind == 0) return forward_f32(xs, wu, bu, wd, bd, offsets, h, y, M, D, F, E, s);
  if (kind == 1) return forward_bf16(xs, wu, bu, wd, bd, offsets, h, y, part, M, D, F, E, s);
  return -1;
}

// Scratch: dz1 [M, F] in the compute dtype; part_u [row tiles, F] f32; in
// bf16 also dz2 [M, D] and part_d [row tiles, D] f32 (row tiles as
// tk_moe_row_tile says; unused in f32).
int tk_moe_bwd(int kind, const void* xs, const void* g, const void* y, const void* h,
               const void* wu, const void* wd, const void* offsets, void* dz2, void* dz1,
               void* part_u, void* part_d, void* dx, void* dwu, void* dbu, void* dwd, void* dbd,
               int M, int D, int F, int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > kMaxExperts) return -2;
  if (kind == 0)
    return backward_f32(xs, g, y, h, wu, wd, offsets, dz1, part_u, dx, dwu, dbu, dwd, dbd, M, D,
                        F, E, s);
  if (kind == 1)
    return backward_bf16(xs, g, y, h, wu, wd, offsets, dz2, dz1, part_u, part_d, dx, dwu, dbu,
                         dwd, dbd, M, D, F, E, s);
  return -1;
}

// Rows of the backward's row tiles (BM) for a kind; the caller sizes the
// per-tile column sums, ceil(M / BM) + E rows, from it.
int tk_moe_row_tile(int kind) {
  if (kind == 0) return kFM;
  if (kind == 1) return kBM;
  return -1;
}

const char* tk_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
