// Paged-attention decode for Hopper (sm_90a), one query token per slot.
//
// Replaces the Pallas TPU kernel `_paged_kernel` launched by `paged_attend`
// (tpukit/ops/paged_attention.py:105, :174). For every (slot n, head h):
//   1. walk the slot's block table: position j lives in page bt[n, j / P] at
//      offset j % P; int8 pages dequantize per 256-element block of the
//      (page, head) row, scale index ((j % P) * D + d) / 256;
//   2. the fresh k/v of this tick stands at idx = min(start, W - 1);
//   3. scores q.k accumulate in f32, are rounded to the compute dtype, times
//      1/sqrt(D) in that dtype, then widened to f32;
//   4. softmax over the whole window in f32 (max, exp, sum), then
//      probs = p / l rounded to the compute dtype (divide before the dot);
//   5. o[d] = sum_j probs_j * v_j[d] in f32, rounded to the compute dtype.
// K/V values are rounded to the compute dtype before they are used, as the
// gathered view of the reference does (`gather_view(..., compute dtype)`).
// The pool write-back stays outside, in `serve.paged.write_token`.
//
// Positions after `start` never enter a score or a sum (a split's last page
// row is fetched whole, so some may be copied with it). The TPU kernel
// computes them, masks them to -1e9 and gets exp(-1e9 - m) == 0 exactly in
// f32, so leaving them out changes no bit of the result.
//
// Bound: device-memory bytes. A call must read
//   sum_n start_n * H * D * 2 * itemsize(pool)   (K and V window, minus the
//                                                 fresh token)
//   + the int8 scale blocks those positions touch + the block-table entries
//   + q, k_new, v_new and the output, N * H * D * itemsize(compute) each,
// against 4 * sum_n (start_n + 1) * H * D operations, far below the card's
// arithmetic rate. The design reads every K/V element once and keeps the
// card's SMs busy at any batch:
//   - Work units of (slot, head, split): a split is a run of `pps`
//     consecutive block-table pages (at least kMinSplitPages), chosen on the
//     host from static shapes (N, H, MP, the SM count) for up to
//     kUnitsPerSm units an SM (`tk_paged_plan`; the caller passes it to
//     `tk_paged_attend`). The grid is launched at the bound MP; a unit
//     that starts past its slot's cursor returns at once. The cursor is read
//     on the device only, so a call needs no host sync and can be captured
//     in a CUDA graph.
//   - A (page, head) row is P * D contiguous elements. Warp w of a block
//     owns every kWarps-th page of its split and its own stages of a
//     shared-memory ring; its lane 0 copies whole rows with the bulk copy
//     engine (`bulk_copy_g2s`, 1-D TMA, completing on an mbarrier) and
//     refills a stage as soon as the warp is done with it, so the warps run
//     apart, with no block barrier per page. A split reads its block-table
//     entries once. Where a position's row (D * itemsize) is no multiple of
//     16 bytes, or the pool is not 16-byte aligned, the warp copies the row
//     with byte loads into a padded layout instead (same arithmetic, no
//     asynchrony).
//   - Scores: 1-16 lanes a position (2 at P 16), each reading 16-byte
//     chunks of K from shared memory, starting at a rotation by the position
//     so the lanes of a load phase hit distinct banks; 0-4 shuffle steps.
//   - Three kernels, no atomics (the same bits every run):
//       scores: the rounded, scaled scores of its split into an f32 scratch
//               [N, H, W], and the split's max into [N, H, splits];
//       values: the window max (the max of the split maxes: exact), l =
//               sum_j exp(s_j - m) over the whole window's scores (4 bytes
//               a position from L2, against 2 * D * itemsize of K and V),
//               round(p / l) for its split's positions, then V streamed as
//               K was, a partial output in f32 [N, H, splits, D];
//       combine: the partials summed in split order, rounded.
//     The values and combine kernels are launched with programmatic stream
//     serialization: each starts while the kernel before it finishes,
//     reads its block table and issues its V copies, and waits
//     (`grid_dependency_wait`) only before it reads that kernel's output.
//     Shared memory holds one split's probabilities (at most kMaxSplitPos
//     positions), not the window's scores, so the window has no cap of its
//     own: a longer window gets more splits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tk_hopper.cuh"  // mbarriers, bulk_copy_g2s (and tk_mma.cuh's ld_b128)

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQuantBlock = 256;
constexpr int kMaxWarpStages = 2;        // ring stages a warp owns
constexpr int kStageBudget = 32 * 1024;  // bytes of page rows a block keeps in flight
constexpr int kMaxSplitPos = 2048;       // positions of one split (its probabilities)
constexpr int kUnitsPerSm = 8;
constexpr int kMinSplitPages = 4;        // a shorter split costs more in set-up than it saves
constexpr int kMaxAcc = 16;              // f32 output sums a lane of the values kernel holds
constexpr bool kChained = true;          // the values and combine kernels start early (PDL)
constexpr int kSmemLimit = 232448;       // the most dynamic shared memory a block may use

struct Params {
  const void* pool_k;
  const void* pool_v;
  const float* scale_k;
  const float* scale_v;
  const int32_t* bt;
  const int32_t* start;
  const void* q;
  const void* k_new;
  const void* v_new;
  void* out;
  float* scores;  // [N, H, W]
  float* smax;    // [N, H, splits]
  float* part;    // [N, H, splits, D]
  int N, H, P, D, MP, nb;
  int Dp;      // D padded to whole 16-byte chunks (the stage's position stride)
  int pps;     // pages per split
  int splits;  // splits per window
  int stages;  // ring stages, kWarps x the stages a warp owns
  int bulk;    // 1: stages filled by bulk copies; 0: by byte loads
  float scale;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offsets of a block's shared memory. pass 0: scores, 1: values.
struct Smem {
  int stage, stage_bytes, sc, bt, x, red, grp, total;
};

__host__ __device__ inline Smem smem_layout(const Params& p, int isz, int pass) {
  Smem s;
  s.stage = 128;  // after kWarps * kMaxWarpStages mbarriers
  s.stage_bytes = round_up(p.P * p.Dp * isz, 128);
  s.sc = s.stage + p.stages * s.stage_bytes;
  s.bt = s.sc + round_up(4 * p.stages * p.nb, 16);
  s.x = s.bt + round_up(4 * p.pps, 16);
  const int xn = pass == 0 ? p.Dp : p.pps * p.P;  // the query, or the split's probabilities
  s.red = s.x + round_up(4 * xn, 16);
  s.grp = s.red + round_up(4 * (kWarps + 1), 16);
  const int chunks = p.Dp * isz / 16;
  const int groups = kWarps * (32 / (chunks < 32 ? chunks : 32));  // the values kernel's sums
  s.total = s.grp + (pass == 0 ? 0 : 4 * groups * p.Dp);
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round an f32 value to the compute dtype TC and widen it back.
template <typename TC> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename TC> __device__ __forceinline__ TC from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The 16/sizeof(TP) elements of a 16-byte chunk in shared memory, as f32.
template <typename TP> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const void* p, float (&v)[E]) {
    const uint4 u = ld_b128(p);
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const void* p, float (&v)[E]) {
    const uint4 u = ld_b128(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<int8_t> {
  static constexpr int E = 16;
  __device__ static void unpack(const void* p, float (&v)[E]) {
    const uint4 u = ld_b128(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
};

// The K/V values of chunk `c` of stage position `jj`, as the compute dtype
// rounds them (int8: times the row's block scale from `sc`); 0 past D.
template <typename TP, typename TC>
__device__ __forceinline__ void load_values(const unsigned char* stage, const float* sc,
                                            int jj, int c, int D, int Dp,
                                            float (&v)[Chunk<TP>::E]) {
  constexpr int E = Chunk<TP>::E;
  Chunk<TP>::unpack(stage + (static_cast<size_t>(jj) * Dp + c * E) * sizeof(TP), v);
  if constexpr (sizeof(TP) == 1) {
    const int first = jj * D + c * E;
    if (D % E == 0) {  // the chunk lies in one quant block
      const float scale = sc[first / kQuantBlock];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = round_to<TC>(v[e] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = c * E + e < D ? round_to<TC>(v[e] * sc[(first + e) / kQuantBlock]) : 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = round_to<TC>(v[e]);  // a padded layout's pad is 0
  }
}

// The query's chunk `c` (E f32 values) from shared memory.
template <int E>
__device__ __forceinline__ void load_query(const float* q_s, int c, float (&qv)[E]) {
#pragma unroll
  for (int t = 0; t < E / 4; ++t) {
    float v[4];
    Chunk<float>::unpack(q_s + c * E + 4 * t, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[4 * t + i] = v[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction; every thread gets the result. `red` holds at least
// kWarps + 1 floats and may be reused once this returns.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? red[lane] : (kMax ? -INFINITY : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[kWarps] = w;
  }
  __syncthreads();
  const float out = red[kWarps];
  __syncthreads();
  return out;
}

// One unit's view of its window and the ring of page rows it streams. Warp
// w owns pages w, w + kWarps, ... of the split and stages [w * sw, (w + 1)
// * sw) of the ring: its t-th page (page i = t * kWarps + w) goes to stage
// w * sw + t % sw, and with bulk copies waits for parity (t / sw) & 1 of
// that stage's mbarrier. A warp refills a stage as soon as its own lanes
// are done with it, so no barrier of the block is needed per page.
template <typename TP>
struct Unit {
  int n, h, split, lim, j0, npool, npg, fresh;
  int H, P, D, Dp, MP, nb, pps, sw, bulk, stage_bytes;
  const TP* pool;
  const float* scales;  // int8 block scales of the pool, else null
  const int32_t* bt;
  unsigned char* ring;  // [kWarps * sw][stage_bytes] page rows
  float* sc;            // [kWarps * sw][nb] the block scales of each stage's row
  int32_t* bt_s;        // the split's block-table entries
  uint64_t* bars;       // [kWarps * sw] mbarriers (bulk copies)

  __device__ Unit(const Params& prm, const void* pool_, const float* scales_, unsigned char* base,
                  const Smem& s)
      : H(prm.H), P(prm.P), D(prm.D), Dp(prm.Dp), MP(prm.MP), nb(prm.nb), pps(prm.pps),
        sw(prm.stages / kWarps), bulk(prm.bulk), stage_bytes(s.stage_bytes) {
    split = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
    const int span = pps * P;
    lim = min(prm.start[n], MP * P - 1);  // window 0..lim; lim holds the fresh token
    j0 = split * span;
    fresh = lim < j0 + span;              // this split holds the fresh position
    npool = min(j0 + span, lim) - j0;     // pool positions j0 .. j0 + npool - 1
    npg = npool > 0 ? (npool + P - 1) / P : 0;
    pool = static_cast<const TP*>(pool_);
    scales = scales_;
    bt = prm.bt;
    bars = reinterpret_cast<uint64_t*>(base);
    ring = base + s.stage;
    sc = reinterpret_cast<float*>(base + s.sc);
    bt_s = reinterpret_cast<int32_t*>(base + s.bt);
  }

  // Before the block's first barrier: the block-table entries, the
  // mbarriers.
  __device__ void setup() {
    const int32_t* row = bt + static_cast<size_t>(n) * MP + split * pps;
    for (int i = threadIdx.x; i < npg; i += kThreads) bt_s[i] = row[i];
    if (threadIdx.x == 0 && bulk) {
      for (int s = 0; s < kWarps * sw; ++s) mbar_init(&bars[s], 1);
      mbar_fence_init();
    }
  }

  __device__ size_t row_of(int i) const { return static_cast<size_t>(bt_s[i]) * H + h; }
  __device__ int slot(int i) const { return (i % kWarps) * sw + (i / kWarps) % sw; }
  __device__ unsigned char* stage(int i) const { return ring + slot(i) * stage_bytes; }
  __device__ const float* stage_scales(int i) const { return sc + slot(i) * nb; }

  // The owning warp's lanes: page i's block scales into its stage's slot.
  __device__ void load_scales(int i) const {
    if (scales == nullptr) return;
    float* dst = sc + slot(i) * nb;
    for (int b = threadIdx.x & 31; b < nb; b += 32) dst[b] = scales[row_of(i) * nb + b];
  }

  // Bulk mode, the owning warp: page i's row into its stage (lane 0), its
  // scales (generic stores, seen by the warp once `acquire` returns).
  __device__ void issue(int i) const {
    if ((threadIdx.x & 31) == 0) {
      const uint32_t bytes = static_cast<uint32_t>(P * D * sizeof(TP));
      mbar_arrive_expect_tx(&bars[slot(i)], bytes);
      bulk_copy_g2s(stage(i), pool + row_of(i) * P * D, bytes, &bars[slot(i)]);
    }
    load_scales(i);
  }

  // After the block's first barrier, each warp: its first pages' copies.
  __device__ void begin() const {
    const int w = threadIdx.x >> 5;
    if (bulk)
      for (int i = w; i < min(kWarps * sw, npg); i += kWarps) issue(i);
    __syncwarp();
  }

  // The owning warp: page i is in its stage once this returns.
  __device__ void acquire(int i) const {
    if (bulk) {
      mbar_wait(&bars[slot(i)], (i / kWarps / sw) & 1);
      if constexpr (sizeof(TP) == 1) __syncwarp();  // the scales the lanes stored in `issue`
      return;
    }
    // byte loads into the padded layout: position jj at jj * Dp elements
    const int rb = D * static_cast<int>(sizeof(TP)), sb = Dp * static_cast<int>(sizeof(TP));
    const auto* src = reinterpret_cast<const unsigned char*>(pool + row_of(i) * P * D);
    unsigned char* dst = stage(i);
    for (int b = threadIdx.x & 31; b < P * sb; b += 32) {
      const int jj = b / sb, o = b % sb;
      dst[b] = o < rb ? src[jj * rb + o] : 0;
    }
    load_scales(i);
    __syncwarp();
  }

  // The owning warp is done with page i: its stage takes the warp's page
  // kWarps * sw further on.
  __device__ void release(int i) const {
    __syncwarp();
    if (bulk && i + kWarps * sw < npg) issue(i + kWarps * sw);
  }

  __device__ int count(int i) const { return min(P, npool - i * P); }
};

// Grid (splits, H, N), kThreads threads. The rounded, scaled scores of the
// unit's positions into p.scores and its max into p.smax.
template <typename TP, typename TC>
__global__ void __launch_bounds__(kThreads) paged_scores_kernel(const Params p) {
  extern __shared__ __align__(128) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const Smem lay = smem_layout(p, sizeof(TP), 0);
  grid_launch_dependents();  // the values kernel may start its V copies
  Unit<TP> u(p, p.pool_k, p.scale_k, base, lay);
  if (u.j0 > u.lim) return;
  constexpr int E = Chunk<TP>::E;
  float* q_s = reinterpret_cast<float*>(base + lay.x);
  float* red = reinterpret_cast<float*>(base + lay.red);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, W = p.MP * p.P;
  const size_t vec = (static_cast<size_t>(u.n) * p.H + u.h) * D;
  const TC* q = static_cast<const TC*>(p.q);
  float* srow = p.scores + (static_cast<size_t>(u.n) * p.H + u.h) * W;
  const float scale_c = round_to<TC>(p.scale);

  u.setup();
  for (int d = tid; d < p.Dp; d += kThreads) q_s[d] = d < D ? to_f32(q[vec + d]) : 0.f;
  __syncthreads();
  u.begin();

  // LP lanes a position (a power of two): as few as cover a page's
  // positions in one round of the warp (2 at P 16), no more than the row's
  // 16-byte chunks; lane `lig` of a position sums chunks lig, lig + LP, ...
  // starting at a rotation by the position, so the lanes of a load phase
  // read distinct banks
  const int chunks = p.Dp / E;
  int LP = 32;
  while (LP > 1 && 32 / LP < p.P) LP >>= 1;
  while (LP > 1 && LP / 2 >= chunks) LP >>= 1;
  const int per = 32 / LP, lig = lane % LP;
  const int nk = (chunks + LP - 1) / LP;

  float mx = -INFINITY;
  if (u.fresh && warp == 0) {  // the fresh token at lim
    const TC* kn = static_cast<const TC*>(p.k_new);
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += q_s[d] * to_f32(kn[vec + d]);
    acc = warp_sum(acc);
    const float s = round_to<TC>(round_to<TC>(acc) * scale_c);
    if (lane == 0) srow[u.lim] = s;
    mx = s;
  }
  for (int i = warp; i < u.npg; i += kWarps) {
    u.acquire(i);
    const unsigned char* st = u.stage(i);
    const float* sc = u.stage_scales(i);
    const int cnt = u.count(i);
    for (int b0 = 0; b0 < cnt; b0 += per) {  // warp-uniform: every lane shuffles
      const int jj = b0 + lane / LP;
      float acc = 0.f;
      if (jj < cnt) {
        int kk = jj % nk;  // the rotation; then kk + 1 .. nk - 1, 0 .. kk - 1
#pragma unroll 4
        for (int k = 0; k < nk; ++k) {
          const int c = lig + LP * kk;
          kk = kk + 1 == nk ? 0 : kk + 1;
          if (c < chunks) {
            float v[E], qv[E];
            load_values<TP, TC>(st, sc, jj, c, D, p.Dp, v);
            load_query<E>(q_s, c, qv);
#pragma unroll
            for (int e = 0; e < E; ++e) acc += qv[e] * v[e];
          }
        }
      }
      for (int o = LP / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lig == 0 && jj < cnt) {
        const float s = round_to<TC>(round_to<TC>(acc) * scale_c);
        srow[u.j0 + i * p.P + jj] = s;
        mx = fmaxf(mx, s);
      }
    }
    u.release(i);
  }
  mx = block_reduce<true>(mx, red);
  if (tid == 0) p.smax[(static_cast<size_t>(u.n) * p.H + u.h) * p.splits + u.split] = mx;
}

// Grid (splits, H, N), kThreads threads. The window's max and l, the
// split's probabilities, then its share of the output into p.part.
template <typename TP, typename TC>
__global__ void __launch_bounds__(kThreads) paged_values_kernel(const Params p) {
  extern __shared__ __align__(128) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const Smem lay = smem_layout(p, sizeof(TP), 1);
  grid_launch_dependents();  // the combine may launch and wait
  Unit<TP> u(p, p.pool_v, p.scale_v, base, lay);
  if (u.j0 > u.lim) return;
  constexpr int E = Chunk<TP>::E;
  constexpr int KV = kMaxAcc / E;
  float* pr = reinterpret_cast<float*>(base + lay.x);
  float* red = reinterpret_cast<float*>(base + lay.red);
  float* grp = reinterpret_cast<float*>(base + lay.grp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, W = p.MP * p.P;
  const size_t hrow = static_cast<size_t>(u.n) * p.H + u.h;
  const float* srow = p.scores + hrow * W;

  u.setup();
  __syncthreads();
  u.begin();  // the V rows are in flight while the softmax terms are formed
  grid_dependency_wait();  // the scores kernel's scores and maxes

  // the window max: the max of the split maxes (exact); l over the window
  float m = -INFINITY;
  const int active = u.lim / (p.pps * p.P) + 1;
  for (int s = 0; s < active; ++s) m = fmaxf(m, p.smax[hrow * p.splits + s]);
  float l = 0.f;
  for (int j = tid; j <= u.lim; j += kThreads) l += expf(srow[j] - m);
  l = block_reduce<false>(l, red);
  const int nprob = u.npool + u.fresh;  // positions j0 .. j0 + nprob - 1
  for (int jj = tid; jj < nprob; jj += kThreads)
    pr[jj] = round_to<TC>(expf(srow[u.j0 + jj] - m) / l);
  __syncthreads();

  // lane (g, cl) of its warp: chunks cl, cl + CL, ... of positions g, g + G,
  // ... of each of the warp's pages
  const int chunks = p.Dp / E, CL = min(chunks, 32), G = 32 / CL;
  const int g = lane / CL, cl = lane % CL;
  float acc[KV][E];
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.f;
  for (int i = warp; i < u.npg; i += kWarps) {
    u.acquire(i);
    if (g < G) {
      const unsigned char* st = u.stage(i);
      const float* sc = u.stage_scales(i);
      const int cnt = u.count(i);
      for (int jj = g; jj < cnt; jj += G) {
        const float pj = pr[i * p.P + jj];
#pragma unroll
        for (int k = 0; k < KV; ++k) {
          const int c = cl + CL * k;
          if (c < chunks) {
            float v[E];
            load_values<TP, TC>(st, sc, jj, c, D, p.Dp, v);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[k][e] += pj * v[e];
          }
        }
      }
    }
    u.release(i);
  }
  if (u.fresh && warp == 0 && g == 0) {
    const TC* vn = static_cast<const TC*>(p.v_new);
    const float pj = pr[u.npool];
#pragma unroll
    for (int k = 0; k < KV; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (cl + CL * k) * E + e;
        if (cl + CL * k < chunks && d < D) acc[k][e] += pj * to_f32(vn[hrow * D + d]);
      }
  }
  if (g < G) {
    float* row = grp + (warp * G + g) * p.Dp;
#pragma unroll
    for (int k = 0; k < KV; ++k)
      if (cl + CL * k < chunks)
#pragma unroll
        for (int e = 0; e < E; ++e) row[(cl + CL * k) * E + e] = acc[k][e];
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
    for (int r = 0; r < kWarps * G; ++r) o += grp[r * p.Dp + d];
    p.part[(hrow * p.splits + u.split) * D + d] = o;
  }
}

// One thread per output element: the active splits' partials summed in
// split order, rounded to the compute dtype.
template <typename TC>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(const Params p) {
  grid_dependency_wait();  // the values kernel's partials
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(p.N) * p.H * p.D) return;
  const size_t hrow = idx / p.D;
  const int d = static_cast<int>(idx % p.D);
  const int n = static_cast<int>(hrow / p.H);
  const int lim = min(p.start[n], p.MP * p.P - 1);
  const int active = lim / (p.pps * p.P) + 1;
  float o = 0.f;
  for (int s = 0; s < active; ++s) o += p.part[(hrow * p.splits + s) * p.D + d];
  static_cast<TC*>(p.out)[idx] = from_f32<TC>(o);
}

// ---------------------------------------------------------------------------

int cdiv(long a, long b) { return static_cast<int>((a + b - 1) / b); }

int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Pages per split from static shapes: enough (slot, head, split) units for
// kUnitsPerSm an SM, at least kMinSplitPages pages and at most kMaxSplitPos
// positions a split.
int pages_per_split(int N, int H, int P, int MP) {
  const long rows = std::max(1l, static_cast<long>(N) * H);
  const int want = std::max(1, std::min(MP, cdiv(static_cast<long>(kUnitsPerSm) * num_sms(),
                                                 rows)));
  return std::min(std::max(kMinSplitPages, cdiv(MP, want)), std::max(1, kMaxSplitPos / P));
}

// The rest of the plan from p.pps: splits, Dp, the ring's stages.
void plan(Params& p, int isz) {
  p.splits = cdiv(p.MP, p.pps);
  p.Dp = round_up(p.D * isz, 16) / isz;
  const int stage_bytes = round_up(p.P * p.Dp * isz, 128);
  p.stages = kWarps * std::max(1, std::min(kMaxWarpStages, kStageBudget / (kWarps * stage_bytes)));
}

// Raise a kernel's dynamic shared-memory cap once per instance (a
// function-local static in the caller), so no runtime configuration call
// lands inside a CUDA-graph capture.
template <typename Kernel>
int allow_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
}

// Every kernel of the file launches here. A `chained` kernel is launched
// with programmatic stream serialization: it may start while the kernel
// before it runs, and waits for it in `grid_dependency_wait`.
template <typename Kernel, typename... Args>
int launch(int allowed, bool chained, Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  if (allowed != 0) return allowed;
  if (smem > static_cast<size_t>(kSmemLimit)) return -2;
  if (!chained) {
    kernel<<<grid, kThreads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, args...));
}

template <typename TP, typename TC>
int run(const Params& p, cudaStream_t s) {
  static const int allowed_scores = allow_smem(paged_scores_kernel<TP, TC>);
  static const int allowed_values = allow_smem(paged_values_kernel<TP, TC>);
  const dim3 grid(p.splits, p.H, p.N);
  int err = launch(allowed_scores, false, paged_scores_kernel<TP, TC>, grid,
                   smem_layout(p, sizeof(TP), 0).total, s, p);
  if (err == 0)
    err = launch(allowed_values, kChained, paged_values_kernel<TP, TC>, grid,
                 smem_layout(p, sizeof(TP), 1).total, s, p);
  if (err == 0)
    err = launch(0, kChained, paged_combine_kernel<TC>,
                 dim3(cdiv(static_cast<long>(p.N) * p.H * p.D, kThreads)), 0, s, p);
  return err;
}

const int kItemSize[3] = {4, 2, 1};

}  // namespace

extern "C" {

// The plan at these shapes (pool_kind: 0 f32, 1 bf16, 2 int8): out = pages
// per split, splits, ring stages, f32 scratch elements, bulk copies (1) or
// byte loads (0) for a 16-byte aligned pool, the larger block's shared
// memory in bytes. Returns 0, or -1 for an unknown kind.
int tk_paged_plan(int pool_kind, int N, int H, int P, int D, int MP, int* out) {
  if (pool_kind < 0 || pool_kind > 2) return -1;
  const int isz = kItemSize[pool_kind];
  Params p{};
  p.N = N, p.H = H, p.P = P, p.D = D, p.MP = MP;
  p.nb = pool_kind == 2 ? P * D / kQuantBlock : 0;
  p.pps = pages_per_split(N, H, P, MP);
  plan(p, isz);
  const long rows = static_cast<long>(N) * H;
  out[0] = p.pps;
  out[1] = p.splits;
  out[2] = p.stages;
  out[3] = static_cast<int>(rows * MP * P + rows * p.splits + rows * p.splits * D);
  out[4] = (D * isz) % 16 == 0;
  out[5] = std::max(smem_layout(p, isz, 0).total, smem_layout(p, isz, 1).total);
  return 0;
}

// pool_kind as tk_paged_plan; compute_kind: 0 f32, 1 bf16. `pps` and
// `scratch` (its f32 elements) are tk_paged_plan's at these shapes. Returns cudaGetLastError() after the
// launches, -1 for a kind this library has no instance of, -2 when a
// block's shared memory is over the limit.
int tk_paged_attend(int pool_kind, int compute_kind, const void* pool_k,
                    const void* pool_v, const void* scale_k, const void* scale_v,
                    const void* bt, const void* start, const void* q,
                    const void* k_new, const void* v_new, void* out, void* scratch, int N,
                    int H, int P, int D, int MP, int nb, int pps, float scale,
                    void* stream) {
  if (pool_kind < 0 || pool_kind > 2 || compute_kind < 0 || compute_kind > 1 || pps < 1)
    return -1;
  const int isz = kItemSize[pool_kind];
  Params p{};
  p.pool_k = pool_k, p.pool_v = pool_v;
  p.scale_k = static_cast<const float*>(scale_k), p.scale_v = static_cast<const float*>(scale_v);
  p.bt = static_cast<const int32_t*>(bt), p.start = static_cast<const int32_t*>(start);
  p.q = q, p.k_new = k_new, p.v_new = v_new, p.out = out;
  p.N = N, p.H = H, p.P = P, p.D = D, p.MP = MP, p.nb = nb, p.pps = pps, p.scale = scale;
  plan(p, isz);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  p.bulk = (D * isz) % 16 == 0 && aligned(pool_k) && aligned(pool_v);
  const long rows = static_cast<long>(N) * H;
  p.scores = static_cast<float*>(scratch);
  p.smax = p.scores + rows * MP * P;
  p.part = p.smax + rows * p.splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_kind * 2 + compute_kind) {
    case 0: return run<float, float>(p, s);
    case 1: return run<float, __nv_bfloat16>(p, s);
    case 2: return run<__nv_bfloat16, float>(p, s);
    case 3: return run<__nv_bfloat16, __nv_bfloat16>(p, s);
    case 4: return run<int8_t, float>(p, s);
    default: return run<int8_t, __nv_bfloat16>(p, s);
  }
}

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
