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
//   4. softmax over the window in f32 (one block: max, exp, sum), then
//      probs = p / l rounded to the compute dtype (divide before the dot);
//   5. o[d] = sum_j probs_j * v_j[d] in f32, rounded to the compute dtype.
// K/V values are rounded to the compute dtype before they are used, as the
// gathered view of the reference does (`gather_view(..., compute dtype)`).
// The pool write-back stays outside, in `serve.paged.write_token`.
//
// Positions after `start` are skipped. The TPU kernel computes them, masks
// them to -1e9 and gets exp(-1e9 - m) == 0 exactly in f32, so skipping them
// changes no bit of the result and saves their bytes.
//
// Bound: device-memory bytes. A call must read
//   sum_n start_n * H * D * 2 * itemsize(pool)   (K and V window, minus the
//                                                 fresh token)
//   + the int8 scale blocks those positions touch + the block-table entries
//   + q, k_new, v_new and the output, N * H * D * itemsize(compute) each,
// against 4 * sum_n (start_n + 1) * H * D operations, far below the card's
// arithmetic rate. The design reads every needed K/V element exactly once:
// one block per (slot, head) keeps its scores and probabilities in shared
// memory (4 * W bytes), so pass 2 re-reads no key. Neighbouring lanes read
// neighbouring head_dim elements (coalesced rows). Not done yet: 16-byte
// vector loads, cp.async/TMA prefetch of the next page, and splitting long
// windows across blocks; with N * H blocks of 256 threads the card holds
// too few loads in flight to reach its memory rate at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuantBlock = 256;

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

// Element `e` of (page, head) row `row` of a pool, as f32; int8 pools
// dequantize with the row's block scale.
template <typename TP>
__device__ __forceinline__ float load_pool(const TP* __restrict__ pool,
                                           const float* __restrict__ scales,
                                           size_t row, int e, int row_elems, int nb) {
  return to_f32(pool[row * row_elems + e]);
}
template <>
__device__ __forceinline__ float load_pool<int8_t>(const int8_t* __restrict__ pool,
                                                   const float* __restrict__ scales,
                                                   size_t row, int e, int row_elems, int nb) {
  return static_cast<float>(pool[row * row_elems + e]) * scales[row * nb + e / kQuantBlock];
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

// Grid (N, H), kThreads threads. Dynamic shared memory: D + W + kThreads floats.
template <typename TP, typename TC>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const TP* __restrict__ pool_k, const TP* __restrict__ pool_v,
                    const float* __restrict__ scale_k, const float* __restrict__ scale_v,
                    const int32_t* __restrict__ bt, const int32_t* __restrict__ start,
                    const TC* __restrict__ q, const TC* __restrict__ k_new,
                    const TC* __restrict__ v_new, TC* __restrict__ out,
                    int H, int P, int D, int MP, int nb, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, h = blockIdx.y;
  const int W = MP * P;
  const int row_elems = P * D;
  float* q_s = smem;      // [D]   the query, widened
  float* s = q_s + D;     // [W]   scores, then probabilities
  float* red = s + W;     // [kThreads] reduction scratch and pass-2 partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t vec = (static_cast<size_t>(n) * H + h) * D;
  const int lim = min(start[n], W - 1);  // window is 0..lim; lim holds the fresh token
  const int32_t* bt_row = bt + static_cast<size_t>(n) * MP;
  const float scale_c = round_to<TC>(scale);

  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f32(q[vec + d]);
  __syncthreads();

  // pass 1: scores, one warp per position, lanes across head_dim
  for (int j = warp; j <= lim; j += kWarps) {
    float acc = 0.f;
    if (j == lim) {
      for (int d = lane; d < D; d += 32) acc += q_s[d] * to_f32(k_new[vec + d]);
    } else {
      const size_t row = static_cast<size_t>(bt_row[j / P]) * H + h;
      const int base = (j % P) * D;
      for (int d = lane; d < D; d += 32)
        acc += q_s[d] * round_to<TC>(load_pool(pool_k, scale_k, row, base + d, row_elems, nb));
    }
    acc = warp_sum(acc);
    if (lane == 0) s[j] = round_to<TC>(round_to<TC>(acc) * scale_c);
  }
  __syncthreads();

  // one softmax block: max, exp and sum in f32, divide before the value dot
  float m = -INFINITY;
  for (int j = tid; j <= lim; j += kThreads) m = fmaxf(m, s[j]);
  m = block_reduce<true>(m, red);
  float l = 0.f;
  for (int j = tid; j <= lim; j += kThreads) {
    const float p = expf(s[j] - m);
    s[j] = p;
    l += p;
  }
  l = block_reduce<false>(l, red);
  for (int j = tid; j <= lim; j += kThreads) s[j] = round_to<TC>(s[j] / l);
  __syncthreads();

  // pass 2: values; thread (g, d) sums positions g, g + G, ... for column d
  const int G = kThreads / D;  // D <= kThreads, checked by the wrapper
  const int d = tid % D, g = tid / D;
  float acc = 0.f;
  if (g < G) {
    for (int j = g; j <= lim; j += G) {
      float v;
      if (j == lim) {
        v = to_f32(v_new[vec + d]);
      } else {
        const size_t row = static_cast<size_t>(bt_row[j / P]) * H + h;
        v = round_to<TC>(load_pool(pool_v, scale_v, row, (j % P) * D + d, row_elems, nb));
      }
      acc += s[j] * v;
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
    for (int gg = 0; gg < G; ++gg) o += red[gg * D + tid];
    out[vec + tid] = from_f32<TC>(o);
  }
}

template <typename TP, typename TC>
void launch(const void* pool_k, const void* pool_v, const float* scale_k,
            const float* scale_v, const int32_t* bt, const int32_t* start,
            const void* q, const void* k_new, const void* v_new, void* out,
            int N, int H, int P, int D, int MP, int nb, float scale,
            cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) + MP * P + kThreads);
  paged_attend_kernel<TP, TC><<<dim3(N, H), kThreads, smem, stream>>>(
      static_cast<const TP*>(pool_k), static_cast<const TP*>(pool_v), scale_k, scale_v,
      bt, start, static_cast<const TC*>(q), static_cast<const TC*>(k_new),
      static_cast<const TC*>(v_new), static_cast<TC*>(out), H, P, D, MP, nb, scale);
}

}  // namespace

extern "C" {

// pool_kind: 0 f32, 1 bf16, 2 int8 (scales required). compute_kind: 0 f32,
// 1 bf16. Returns cudaGetLastError() after the launch, or -1 for a kind
// this library has no instance of.
int tk_paged_attend(int pool_kind, int compute_kind, const void* pool_k,
                    const void* pool_v, const void* scale_k, const void* scale_v,
                    const void* bt, const void* start, const void* q,
                    const void* k_new, const void* v_new, void* out, int N, int H,
                    int P, int D, int MP, int nb, float scale, void* stream) {
  const float* sk = static_cast<const float*>(scale_k);
  const float* sv = static_cast<const float*>(scale_v);
  const int32_t* b = static_cast<const int32_t*>(bt);
  const int32_t* st = static_cast<const int32_t*>(start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_kind * 2 + compute_kind) {
    case 0: launch<float, float>(pool_k, pool_v, sk, sv, b, st, q, k_new, v_new, out, N, H, P, D, MP, nb, scale, s); break;
    case 1: launch<float, __nv_bfloat16>(pool_k, pool_v, sk, sv, b, st, q, k_new, v_new, out, N, H, P, D, MP, nb, scale, s); break;
    case 2: launch<__nv_bfloat16, float>(pool_k, pool_v, sk, sv, b, st, q, k_new, v_new, out, N, H, P, D, MP, nb, scale, s); break;
    case 3: launch<__nv_bfloat16, __nv_bfloat16>(pool_k, pool_v, sk, sv, b, st, q, k_new, v_new, out, N, H, P, D, MP, nb, scale, s); break;
    case 4: launch<int8_t, float>(pool_k, pool_v, sk, sv, b, st, q, k_new, v_new, out, N, H, P, D, MP, nb, scale, s); break;
    case 5: launch<int8_t, __nv_bfloat16>(pool_k, pool_v, sk, sv, b, st, q, k_new, v_new, out, N, H, P, D, MP, nb, scale, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
