// Host emulation of cuda_bf16.h: the bf16 type, the two conversions the
// port's kernels use (round to nearest even, as __float2bfloat16_rn does) and
// the reinterpretations to and from its 16 bits.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16_rn(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof(u));
  __nv_bfloat16 out;
  if (std::isnan(x)) {
    out.bits = static_cast<uint16_t>((u >> 16) | 0x40);
    return out;
  }
  const uint32_t rounding = 0x7fff + ((u >> 16) & 1);
  out.bits = static_cast<uint16_t>((u + rounding) >> 16);
  return out;
}

inline float __bfloat162float(__nv_bfloat16 x) {
  const uint32_t u = static_cast<uint32_t>(x.bits) << 16;
  float out;
  std::memcpy(&out, &u, sizeof(out));
  return out;
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 x) { return x.bits; }

inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short u) {
  __nv_bfloat16 out;
  out.bits = u;
  return out;
}
