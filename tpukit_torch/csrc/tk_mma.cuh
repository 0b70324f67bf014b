// The PTX instructions of the port's tensor-core kernels, each behind one
// small named function, so that a kernel source names what it does and the
// host emulation (`host_emu/tk_mma.cuh`, same names, same per-lane layouts)
// can stand in for it on the CPU.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" and
// "ldmatrix"), lane = 4 * g + t (g = lane / 4, t = lane % 4); a 32-bit
// register holds two bf16, the lower-indexed element in its low half:
//   A 16 x 16 (row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//     a3 (g + 8, 2t + 8..);
//   B 16 x 8 ("col": k runs down a column): b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g);
//   C, D 16 x 8 f32: c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1).
// So the accumulators of two neighbouring n8 tiles, rounded and packed in
// pairs, are an A fragment: a product's result feeds the next product from
// registers.
//   ldmatrix .x4: lanes 8j .. 8j + 7 give the row addresses (16 bytes each)
//     of 8 x 8 matrix j; register j of a lane is row g of matrix j, columns
//     2t..2t+1; with .trans, column g, rows 2t..2t+1.
//   pack_bf16x2: two f32 values rounded to bf16 into one register.
//   ld_b128 / st_b128 / ld_b32 / st_b32: plain 16- and 4-byte loads and
//     stores (the address aligned to their size), in one place so the host
//     emulation can do them as byte copies.
//   cp.async: a 16- or 4-byte copy from device to shared memory that does
//     not hold up the thread; with `pred` false it writes zeros. `commit`
//     closes a group of copies, `wait<N>` waits until at most N groups are
//     in flight; the copies are then visible to the thread that started them
//     (and to the block after a __syncthreads).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// d += a b, one m16n8k16 product of bf16 in f32 (d is read and written).
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; `row` is this lane's row
// address (see the head comment).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Two f32 values rounded to bf16 (nearest even) in one register, `lo` in
// the low half (cvt.rn.bf16x2.f32 takes the high half's value first).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint4 ld_b128(const void* p) { return *static_cast<const uint4*>(p); }
__device__ __forceinline__ void st_b128(void* p, uint4 v) { *static_cast<uint4*>(p) = v; }
__device__ __forceinline__ uint32_t ld_b32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st_b32(void* p, uint32_t v) { *static_cast<uint32_t*>(p) = v; }

// 16 bytes from device memory `src` to shared memory `dst` (both 16-byte
// aligned), or 16 zero bytes when `pred` is false (`src` is then not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes, as cp_async_16 (both 4-byte aligned).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
