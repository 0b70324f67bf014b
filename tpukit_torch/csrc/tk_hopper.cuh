// The Hopper (sm_90a) PTX instructions of the port's wgmma/TMA kernels, each
// behind one small named function, as `tk_mma.cuh` does for mma.sync; the host
// emulation (`host_emu/tk_hopper.cuh`, same names) implements each from the
// PTX ISA so the CPU tests run the real kernels.
//
// Shared memory tiles use the 128-byte swizzle: a tile is rows of 128 bytes
// (64 bf16), and the 16-byte chunk c of the row at address bits [7, 10) = r
// is stored at chunk c ^ r (address bits [4, 7) ^= bits [7, 10)). TMA writes
// a box that way (CU_TENSOR_MAP_SWIZZLE_128B, the box's inner extent 128
// bytes) and wgmma reads it that way (descriptor layout type 1); a tile's
// base is 1024-byte aligned, so the pattern is the same relative to it.
//
// wgmma matrix descriptor (64 bits): start address >> 4 in bits [0, 14),
// leading byte offset (LBO) >> 4 in [16, 30), stride byte offset (SBO) >> 4
// in [32, 46), base offset 0 in [49, 52), layout type in [62, 64) (1: 128B
// swizzle). The canonical layouts it describes (PTX ISA "Shared Memory
// Matrix Layout", CUTLASS's make_gmma_desc), for 16-bit elements, T = 8
// elements (16 bytes):
//   K-major  ((8, m), (T, 2)) : ((8T, SBO), (1, T)): row i of a group of
//     8 at 128 i bytes, groups of 8 rows SBO apart, the 16 k of one
//     instruction 32 contiguous bytes (so the k-slice j of a 64-wide row
//     starts 32 j bytes in); LBO unused (set to 16 bytes);
//   MN-major ((T, 8, m), (8, k)) : ((1, T, LBO), (8T, SBO)): 64 contiguous
//     MN elements (128 bytes) per k row, k rows 128 bytes apart, groups of 8
//     k rows SBO apart, blocks of 64 MN elements LBO apart.
// The instruction's transpose immediates say which: 0 K-major, 1 MN-major.
//
// wgmma accumulator layout (m64nNk16, f32, N / 2 registers a thread): thread
// t of the warpgroup (warp w = t / 32, lane l, g = l / 4, q = l % 4) holds
// register i at row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 q + i % 2.
//
// mbarrier: `init` with an arrival count, phase 0; `arrive` counts one
// arrival, `arrive_expect_tx` adds bytes to the transaction count first; a
// TMA load's (or bulk copy's) bytes count down on completion; the phase completes (its
// parity flips) when both reach 0. `wait(parity)` returns once the phase of
// that parity has completed.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "tk_mma.cuh"  // smem_addr

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the
// other threads; after the inits, before the block's barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- TMA -------------------------------------------------------------------

// The box at element coordinates (c0 innermost, c1) of the tensor map into
// shared memory `dst` (1024-byte aligned for the 128B swizzle); its bytes
// count down `bar`'s transaction count. Out-of-bounds elements are zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same from a rank-3 tensor map: the box at (c0 innermost, c1, c2). A
// box that runs past dimension 0 or 1 reads zeros there, whatever lies
// beyond in memory (the next matrix of a bank, c2 the bank's index).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from device memory `src` to shared memory `dst`,
// both 16-byte aligned, by the bulk copy engine (a 1-D TMA copy: no tensor
// map, no swizzle); the bytes count down `bar`'s transaction count when
// they land.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- programmatic dependent launch ------------------------------------------

// In a grid launched with programmatic stream serialization: wait until
// the grids before it in the stream have completed and their writes are
// visible (a no-op in a grid launched without it).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let the next grid in the stream, if launched with programmatic stream
// serialization, start once every block of this grid has said so (or
// exited); it still waits in `grid_dependency_wait` for this grid's end.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---- generic writes that an asynchronous-proxy read (wgmma) will see -------

// 16 zero bytes at shared address `p` (16-byte aligned), a generic-proxy
// store: wgmma reads shared memory through the async proxy, so it sees the
// store only after `fence_proxy_async` (and a barrier, for other threads'
// products).
__device__ __forceinline__ void st_shared_zero16(void* p) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_addr(p)), "r"(0u),
               "r"(0u), "r"(0u), "r"(0u)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `count` threads (a multiple of 32) on barrier `id` (1..15; 0
// is __syncthreads').
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- register reallocation between warpgroups --------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// The descriptor of a 128B-swizzled operand tile starting at `p`.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes the accumulator registers' values visible to ordinary code (and
// the reverse) around the asynchronous products.
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n256k16, bf16 operands from shared memory through the
// descriptors, f32 accumulators; `accumulate` 0 overwrites d. TA / TB: 0
// K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---- host: the tensor map encoder, reached through the runtime -------------

using TensorMapEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                       const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                       const cuuint32_t*, CUtensorMapInterleave,
                                       CUtensorMapSwizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda; null if the driver does not have it.
inline TensorMapEncodeFn tensor_map_encoder() {
  static const TensorMapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<TensorMapEncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a row-major bf16 matrix [rows][cols] (row stride
// `ld` elements, a multiple of 8: TMA wants 16-byte strides) with boxes of
// 64 columns (128 bytes, the swizzle's row) by `box_rows` rows, 128B swizzle,
// zeros out of bounds. Returns 0, -3 when the driver has no
// cuTensorMapEncodeTiled, -4 when it refuses the map.
inline int make_tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                           int box_rows) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return -3;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64u, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}

// A rank-3 tensor map over `outer` row-major bf16 matrices [rows][cols]
// laid end to end (row stride `ld` elements, a multiple of 8; matrix stride
// rows x ld), boxes of 64 columns by `box_rows` rows of one matrix, 128B
// swizzle, zeros out of bounds in every dimension. Returns as
// make_tensor_map.
inline int make_tensor_map_3d(CUtensorMap* map, const void* base, int outer, int rows, int cols,
                              int ld, int box_rows) {
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return -3;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {64u, static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -4;
}
