// Host emulation of the warp matrix functions of mma.h (nvcuda::wmma) that
// the port's kernels use: 16x16x16 bf16 fragments with f32 accumulators.
// Every lane of the emulated warp holds the whole tile (the card spreads it
// over the lanes in an unspecified layout, which code that only loads,
// multiplies and stores fragments cannot see). Loads and stores are
// warp-collective: the warp's lanes meet at a barrier before each, and one
// lane writes a stored tile. Products are exact in f32 and summed in k order.
#pragma once

#include <type_traits>

#include "cuda_bf16.h"

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
enum layout_t { mem_row_major, mem_col_major };

template <typename Use, int M, int N, int K, typename T, typename Layout = void>
struct fragment {
  static constexpr int rows = std::is_same<Use, matrix_b>::value ? K : M;
  static constexpr int cols = std::is_same<Use, matrix_a>::value ? K : N;
  static constexpr int num_elements = rows * cols;
  T x[rows * cols];  // row-major, the whole tile
};

inline float widen(float v) { return v; }
inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename Use, int M, int N, int K, typename T, typename Layout>
inline void fill_fragment(fragment<Use, M, N, K, T, Layout>& f, const T& v) {
  for (int i = 0; i < f.num_elements; ++i) f.x[i] = v;
}

template <typename Use, int M, int N, int K, typename T, typename Layout>
inline void load_matrix_sync(fragment<Use, M, N, K, T, Layout>& f, const T* p, unsigned ldm) {
  using F = fragment<Use, M, N, K, T, Layout>;
  tk_emu::warp_sync();
  for (int r = 0; r < F::rows; ++r)
    for (int c = 0; c < F::cols; ++c)
      f.x[r * F::cols + c] =
          std::is_same<Layout, col_major>::value ? p[r + c * ldm] : p[r * ldm + c];
}

template <int M, int N, int K>
inline void load_matrix_sync(fragment<accumulator, M, N, K, float>& f, const float* p,
                             unsigned ldm, layout_t layout) {
  tk_emu::warp_sync();
  for (int r = 0; r < M; ++r)
    for (int c = 0; c < N; ++c)
      f.x[r * N + c] = layout == mem_col_major ? p[r + c * ldm] : p[r * ldm + c];
}

template <int M, int N, int K>
inline void store_matrix_sync(float* p, const fragment<accumulator, M, N, K, float>& f,
                              unsigned ldm, layout_t layout) {
  tk_emu::warp_sync();
  if (threadIdx.x % 32 == 0)
    for (int r = 0; r < M; ++r)
      for (int c = 0; c < N; ++c)
        (layout == mem_col_major ? p[r + c * ldm] : p[r * ldm + c]) = f.x[r * N + c];
  tk_emu::warp_sync();
}

template <int M, int N, int K, typename TA, typename LA, typename TB, typename LB>
inline void mma_sync(fragment<accumulator, M, N, K, float>& d,
                     const fragment<matrix_a, M, N, K, TA, LA>& a,
                     const fragment<matrix_b, M, N, K, TB, LB>& b,
                     const fragment<accumulator, M, N, K, float>& c) {
  float out[M * N];
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < N; ++j) {
      float s = c.x[i * N + j];
      for (int k = 0; k < K; ++k) s += widen(a.x[i * K + k]) * widen(b.x[k * N + j]);
      out[i * N + j] = s;
    }
  for (int i = 0; i < M * N; ++i) d.x[i] = out[i];
}

}  // namespace wmma
}  // namespace nvcuda
