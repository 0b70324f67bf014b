// Host emulation of the part of cuda.h (the driver API's types) that the
// port's kernels use: the tensor map of TMA and the enums of
// cuTensorMapEncodeTiled. The emulated encoder (`tk_emu::encode_tensor_map`,
// reached through cudaGetDriverEntryPoint in cuda_runtime.h) makes the same
// checks the driver documents and keeps what `tma_load_2d` and
// `tma_load_3d` need.
#pragma once

#include <cstdint>

typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;

enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B
};
enum CUtensorMapL2promotion {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
  CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_256B
};
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

// What the emulated TMA reads: a rank-2 or rank-3 bf16 tensor (dims
// innermost first, the outer dimensions' strides in bytes) and the box.
struct alignas(64) CUtensorMap {
  const unsigned char* base;
  uint64_t dims[3];
  uint64_t stride[2];
  uint32_t box[3];
  uint32_t rank;
  int swizzle;
};

namespace tk_emu {

inline CUresult encode_tensor_map(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                  void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                  const cuuint32_t* box, const cuuint32_t* elem_strides,
                                  CUtensorMapInterleave, CUtensorMapSwizzle swizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  // the driver's rules (cuTensorMapEncodeTiled): a 16-byte aligned base,
  // strides multiples of 16 bytes, box extents 1..256, and with the 128B
  // swizzle an inner box extent of at most 128 bytes; ranks 2 and 3 here
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank < 2 || rank > 3 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (swizzle == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * 2 > 128))
    return CUDA_ERROR_INVALID_VALUE;
  for (cuuint32_t i = 0; i < rank; ++i)
    if (box[i] == 0 || box[i] > 256 || elem_strides[i] != 1 || dims[i] == 0)
      return CUDA_ERROR_INVALID_VALUE;
  for (cuuint32_t i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return CUDA_ERROR_INVALID_VALUE;
  map->base = static_cast<const unsigned char*>(base);
  map->rank = rank;
  for (cuuint32_t i = 0; i < 3; ++i) {
    map->dims[i] = i < rank ? dims[i] : 1;
    map->box[i] = i < rank ? box[i] : 1;
  }
  map->stride[0] = strides[0];
  map->stride[1] = rank == 3 ? strides[1] : 0;
  map->swizzle = swizzle;
  return CUDA_SUCCESS;
}

}  // namespace tk_emu
