// The port's persistent wgmma/TMA GEMM mainloop for Hopper (sm_90a), shared
// by the bf16 kernels of fused_head_ce.cu and moe_gemm.cu. It holds no
// launch: each source launches its own kernels.
//
// Shape. One block an SM walks work units b, b + gridDim.x, ... (a
// persistent grid). Warpgroup 0 is the producer: one thread keeps TMA loads
// in flight into a ring of kStages stages, each an A tile of kBM = 64 C rows
// and a B tile of kBN = 256 columns, kBK = 64 deep, 128B-swizzled bf16.
// Warpgroups 1 .. C are the consumers (C = P::kConsumers, 1 or 2): each
// runs m64n256k16 products on 64 rows of the output tile straight from the
// stages, f32 accumulators in 128 registers a thread, one k-block's
// products in flight while the next is issued; with C = 2, `setmaxnreg`
// moves registers from the producer to the consumers. Operands are read as
// they lie in memory, K- or MN-major (P::kAMajor, P::kBMajor: 0 K-major,
// 1 MN-major) through the descriptor's transpose bit.
//
// The policy P names the work: `units`, `tiles(u)` and `tile(u, i)` (a Tile
// below: its rows, columns, k-blocks, and for grouped products its expert,
// k offset and k limit, and which of the kernel's tensor-map pairs it
// reads), `setup()` (run by every thread before the block's first barrier;
// thread 0 may write a per-block plan to gemm_plan()), and the consumers'
// epilogue on a per-thread State (`begin`, `tile_done`, `end`). With
// P::kBBank, B is a bank of matrices read through a rank-3 tensor map whose
// outermost coordinate is the Tile's expert: a box past the matrix's own
// rows or columns reads zeros, not the next matrix.
//
// A k limit (Tile::k_end) for an MN-major A: a k-block that runs past it
// (a grouped product whose k is an expert's rows, where TMA cannot stop at
// the segment) has its k rows from k_end on zeroed in the consumer's own A
// box before its products. A k row of an MN-major box is one 128-byte
// swizzle row, so whole rows zero without regard to the swizzle; the
// writes go through the generic proxy, so each thread fences them to the
// async proxy (wgmma's) and the warpgroup meets at a named barrier first.
//
// Shared memory: the policy's plan (kPlanBytes) and an epilogue scratch of
// kWarpScratch bytes for each consumer warp first, then the ring at the
// next 1024-byte boundary (the 128B swizzle's period), then the full/empty
// mbarriers of each stage.
//
// Everything here sits in the unnamed namespace of the source that
// includes it, beside that source's own `extern __shared__ float smem[]`.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tk_hopper.cuh"

namespace {

constexpr int kBN = 256, kBK = 64;       // output tile columns; k-block
constexpr int kStages = 4;               // the ring of shared-memory stages
constexpr int kBox = 64 * kBK * 2;       // one 64 x 64 MN-major box, 8 KB
constexpr int kStageB = kBK * kBN * 2;   // 32 KB
constexpr int kPlanBytes = 512;          // a policy's per-block plan (ints)
constexpr int kWarpScratch = 3584;       // the epilogue scratch of each consumer warp
constexpr int kScratchBytes = 8 * kWarpScratch;

// Tile shape, block size and shared memory of a mainloop with C consumer
// warpgroups.
template <int C>
struct GemmCfg {
  static constexpr int kBM = 64 * C;
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kStageA = kBM * kBK * 2;
  static constexpr int kStageBytes = kStageA + kStageB;
  static constexpr size_t kSmem = kPlanBytes + kScratchBytes + 1024 +
                                  kStages * static_cast<size_t>(kStageBytes) +
                                  2 * kStages * sizeof(uint64_t);
};

// The two-consumer mainloop's: 128 x 256 tiles, 384 threads, 48 KB stages.
constexpr int kBM = GemmCfg<2>::kBM;
constexpr int kGemmThreads = GemmCfg<2>::kThreads;
constexpr size_t kGemmSmem = GemmCfg<2>::kSmem;

// One output tile: rows [m0, m0 + kBM), columns [n0, n0 + kBN), over the
// k-blocks [kb0, kb1), k-block kb starting at element k0 + kb * kBK. A
// grouped product also gives the expert e (the outermost coordinate of a
// banked B), the k limit k_end (see the head comment), the end m_end of the
// rows its epilogue stores, and the tensor-map pair `map` it reads.
struct Tile {
  int m0, n0, kb0, kb1;
  int e = 0;
  int k0 = 0;
  int k_end = INT_MAX;
  int m_end = INT_MAX;
  int map = 0;
};

struct NoState {};

// A consumer thread's place in its warpgroup's 64 x 256 part of a tile:
// register i = 4 j + 2 h + e holds row `row0 + 8 h`, column `col0 + 8 j + e`
// (tk_hopper.cuh's accumulator layout).
struct Frag {
  int row0, col0, q;
  __device__ __forceinline__ Frag(const Tile& t, int cw) {
    const int tid = threadIdx.x % 128, lane = tid % 32;
    row0 = t.m0 + 64 * cw + 16 * (tid / 32) + lane / 4;
    q = lane % 4;
    col0 = t.n0 + 2 * q;
  }
};

// Reductions over the 4 threads (a quad) that share a row of a fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ int quad_min(int v) {
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return min(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ unsigned char* gemm_smem() {
  extern __shared__ __align__(128) float smem[];
  return reinterpret_cast<unsigned char*>(smem);
}
// The policy's per-block plan, and the epilogue scratch of consumer warp
// w (0 .. 4 C - 1).
__device__ __forceinline__ int* gemm_plan() { return reinterpret_cast<int*>(gemm_smem()); }
__device__ __forceinline__ unsigned char* gemm_scratch(int w) {
  return gemm_smem() + kPlanBytes + w * kWarpScratch;
}

// k rows [r, 64) of the 64 x 64 MN-major box at `box` set to zero by the
// 128 threads of consumer warpgroup cw, made visible to its products.
__device__ __forceinline__ void zero_k_rows(unsigned char* box, int r, int cw) {
  for (int c = 8 * r + static_cast<int>(threadIdx.x % 128); c < 8 * 64; c += 128)
    st_shared_zero16(box + 16 * c);
  fence_proxy_async();
  named_barrier_sync(1 + cw, 128);
}

// The mainloop: `ma[t.map]` and `mb[t.map]` are the tensor maps of A and B.
// The producer and the consumers walk the same sequence of tiles and
// k-blocks, meeting at the `full` (TMA bytes landed) and `empty` (every
// consumer thread done with the stage) barriers of each stage.
template <class P>
__device__ __forceinline__ void gemm_body(const CUtensorMap* ma, const CUtensorMap* mb,
                                          const P& p) {
  using G = GemmCfg<P::kConsumers>;
  unsigned char* ring = gemm_smem() + kPlanBytes + kScratchBytes;
  ring += (1024 - smem_addr(ring) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * G::kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G::kThreads - 128);
    }
    mbar_fence_init();
  }
  p.setup();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (P::kConsumers == 2) setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int n = p.tiles(u);
      for (int i = 0; i < n; ++i) {
        const Tile t = p.tile(u, i);
        const CUtensorMap* a_map = ma + t.map;
        const CUtensorMap* b_map = mb + t.map;
        for (int kb = t.kb0; kb < t.kb1; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = ring + stage * G::kStageBytes;
          unsigned char* b = a + G::kStageA;
          mbar_arrive_expect_tx(&full[stage], G::kStageBytes);
          const int k0 = t.k0 + kb * kBK;
          if (P::kAMajor == 0) {
            tma_load_2d(a, a_map, &full[stage], k0, t.m0);
          } else {
            for (int x = 0; x < G::kBM / 64; ++x)
              tma_load_2d(a + x * kBox, a_map, &full[stage], t.m0 + 64 * x, k0);
          }
          if (P::kBMajor == 0) {
            if (P::kBBank)
              tma_load_3d(b, b_map, &full[stage], k0, t.n0, t.e);
            else
              tma_load_2d(b, b_map, &full[stage], k0, t.n0);
          } else {
            for (int x = 0; x < kBN / 64; ++x) {
              if (P::kBBank)
                tma_load_3d(b + x * kBox, b_map, &full[stage], t.n0 + 64 * x, k0, t.e);
              else
                tma_load_2d(b + x * kBox, b_map, &full[stage], t.n0 + 64 * x, k0);
            }
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if constexpr (P::kConsumers == 2) setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
    // k-slice kk of a stage: K-major operands step 32 bytes along the
    // 128-byte rows, MN-major ones 16 k rows (2048 bytes); the second
    // consumer's A rows start one 64-row (K-major) or 64-column (MN-major)
    // block, 8 KB, in
    constexpr int kStepA = P::kAMajor ? 2048 : 32, kStepB = P::kBMajor ? 2048 : 32;
    constexpr uint32_t kLboA = P::kAMajor ? kBox : 16, kLboB = P::kBMajor ? kBox : 16;
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    typename P::State st;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      p.begin(st, u, cw);
      const int n = p.tiles(u);
      for (int i = 0; i < n; ++i) {
        const Tile t = p.tile(u, i);
        if (t.kb1 <= t.kb0) {  // an empty reduction: the products give 0
#pragma unroll
          for (int r = 0; r < 128; ++r) acc[r] = 0.f;
        }
        int held = -1;  // the stage whose products are still in flight
        for (int kb = t.kb0; kb < t.kb1; ++kb) {
          mbar_wait(&full[stage], phase);
          unsigned char* a = ring + stage * G::kStageBytes + cw * kBox;
          const unsigned char* b = ring + stage * G::kStageBytes + G::kStageA;
          if (P::kAMajor == 1) {
            const int k0 = t.k0 + kb * kBK;
            if (k0 + kBK > t.k_end) zero_k_rows(a, max(t.k_end - k0, 0), cw);
          }
          wgmma_fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_m64n256k16<P::kAMajor, P::kBMajor>(
                acc, wgmma_desc(a + kk * kStepA, kLboA, 1024),
                wgmma_desc(b + kk * kStepB, kLboB, 1024), (kb > t.kb0 || kk > 0) ? 1 : 0);
          wgmma_commit();
          wgmma_fence_regs(acc);
          wgmma_wait<1>();  // the previous k-block's products are done
          if (held >= 0) mbar_arrive(&empty[held]);
          held = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        wgmma_fence_regs(acc);
        if (held >= 0) mbar_arrive(&empty[held]);
        p.tile_done(st, acc, u, t, cw);
      }
      p.end(st, u, cw);
    }
  }
}

}  // namespace
