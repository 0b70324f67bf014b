// Host emulation of tpukit_torch/csrc/tk_mma.cuh: the same functions with the
// PTX ISA's per-lane fragment layouts (see that file's head comment), so a
// kernel that gets a layout wrong computes the wrong product here as on the
// card. The warp-collective functions work as the emulated warp shuffles do:
// each lane publishes what it holds (fragment registers, a row address) to a
// per-block array, the warp meets at a barrier, each lane gathers what the
// layout gives it, and the warp meets again before the array is reused.
// Products of two bf16 are exact in f32 and are summed in k order onto the
// accumulator. The loads and stores, and the cp.async copies, are plain byte
// copies (cp.async's finish at once, so `commit` and `wait` have nothing to
// do).
#pragma once

#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace tk_emu {

constexpr int kMaxThreads = 1024;
inline uint32_t frag_regs[kMaxThreads][6];  // a0..a3, b0, b1 of each thread
inline const void* row_addr[kMaxThreads];   // ldmatrix row addresses

inline float bf16_bits_to_f32(uint32_t bits16) {
  const uint32_t u = bits16 << 16;
  float out;
  std::memcpy(&out, &u, sizeof(out));
  return out;
}

// element `half` (0: low, 1: high) of register `reg` of lane `lane` of the warp at `base`
inline float frag_elem(unsigned base, unsigned lane, int reg, int half) {
  return bf16_bits_to_f32((frag_regs[base + lane][reg] >> (16 * half)) & 0xffffu);
}

}  // namespace tk_emu

inline void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  using namespace tk_emu;
  const unsigned tid = threadIdx.x, lane = tid % 32, base = tid - lane;
  for (int i = 0; i < 4; ++i) frag_regs[tid][i] = a[i];
  frag_regs[tid][4] = b0;
  frag_regs[tid][5] = b1;
  warp_sync();
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = 2 * t + (i & 1);
    float sum = d[i];
    for (int k = 0; k < 16; ++k) {
      // A (row, k): lane 4 (row % 8) + (k % 8) / 2, register (row >= 8) + 2 (k >= 8)
      const float av = frag_elem(base, 4 * (row % 8) + (k % 8) / 2, (row >= 8) + 2 * (k >= 8),
                                 k % 2);
      // B (k, col): lane 4 col + (k % 8) / 2, register 4 + (k >= 8)
      const float bv = frag_elem(base, 4 * col + (k % 8) / 2, 4 + (k >= 8), k % 2);
      sum += av * bv;
    }
    out[i] = sum;
  }
  warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

namespace tk_emu {

template <bool TRANS>
inline void ldmatrix(uint32_t (&r)[4], const void* row) {
  const unsigned tid = threadIdx.x, lane = tid % 32, base = tid - lane;
  row_addr[tid] = row;
  warp_sync();
  const int g = lane / 4, t = lane % 4;
  for (int j = 0; j < 4; ++j) {
    uint16_t lo, hi;
    if (!TRANS) {  // row g of matrix j, columns 2t, 2t + 1
      const auto* p = static_cast<const unsigned char*>(row_addr[base + 8 * j + g]);
      std::memcpy(&lo, p + 2 * (2 * t), 2);
      std::memcpy(&hi, p + 2 * (2 * t + 1), 2);
    } else {  // column g of matrix j, rows 2t, 2t + 1
      std::memcpy(&lo, static_cast<const unsigned char*>(row_addr[base + 8 * j + 2 * t]) + 2 * g,
                  2);
      std::memcpy(&hi,
                  static_cast<const unsigned char*>(row_addr[base + 8 * j + 2 * t + 1]) + 2 * g, 2);
    }
    r[j] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
  warp_sync();
}

}  // namespace tk_emu

inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) { tk_emu::ldmatrix<false>(r, row); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  tk_emu::ldmatrix<true>(r, row);
}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__float2bfloat16_rn(lo).bits) |
         (static_cast<uint32_t>(__float2bfloat16_rn(hi).bits) << 16);
}

inline uint4 ld_b128(const void* p) {
  uint4 v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}
inline void st_b128(void* p, uint4 v) { std::memcpy(p, &v, sizeof(v)); }
inline uint32_t ld_b32(const void* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}
inline void st_b32(void* p, uint32_t v) { std::memcpy(p, &v, sizeof(v)); }

inline void cp_async_16(void* dst, const void* src, bool pred) {
  if (pred)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}

inline void cp_async_4(void* dst, const void* src, bool pred) {
  if (pred)
    std::memcpy(dst, src, 4);
  else
    std::memset(dst, 0, 4);
}

inline void cp_async_commit() {}

template <int N>
inline void cp_async_wait() {}
