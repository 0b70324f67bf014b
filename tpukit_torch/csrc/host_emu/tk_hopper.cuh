// Host emulation of tpukit_torch/csrc/tk_hopper.cuh, from the PTX ISA (see
// that file's head comment for the layouts):
//   - mbarrier: its 8 bytes in shared memory hold the pending arrivals, the
//     arrival count, the phase bit and the transaction count; every change
//     and every wait goes through one lock and condition variable, and a
//     wait that outlasts 60 s aborts (a kernel whose pipeline deadlocks
//     must fail, not hang);
//   - bulk copies (`bulk_copy_g2s`) wait on their mbarrier and land, all at
//     once, when a thread first waits on (or tests) that barrier: as late as
//     the card may land them, so a kernel that reads a stage without waiting
//     for its barrier reads what was there before (and a copy nobody waited
//     for aborts when its barrier's shared memory is initialised again);
//   - TMA: `tma_load_2d` / `tma_load_3d` copy the box through the emulated
//     tensor map (cuda.h; its rank must match the load's) at once, zeros
//     where a coordinate leaves its dimension, into the 128B-swizzled
//     layout (address bits [4, 7) ^= bits [7, 10), relative to the
//     1024-aligned shared memory), then count the box's bytes down on the
//     barrier;
//   - a generic-proxy store (`st_shared_zero16`) waits in its thread's
//     queue until that thread's `fence_proxy_async`, so a wgmma that reads
//     before the fence sees the old bytes; `named_barrier_sync` is a
//     barrier of `count` threads per id (cuda_runtime.h);
//   - wgmma: each thread queues its products, `commit` closes a group and
//     `wait<N>` runs every product of all but the newest N groups, each
//     thread computing its own accumulator registers (the layout of the
//     head comment) from shared memory read through the descriptors: start
//     address, LBO, SBO, 128B swizzle, K- or MN-major by the transpose flag.
//     So shared memory is read as late as the card may read it: a stage
//     released before its products were waited on gets overwritten first.
//     Products of two bf16 are exact in f32 and are summed in k order;
//   - the other fences, setmaxnreg and the programmatic-launch controls
//     have nothing to do here (emulated grids run one after another).
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include "cuda.h"
#include "cuda_bf16.h"
#include "cuda_runtime.h"
#include "tk_mma.cuh"

namespace tk_emu {

inline std::mutex mbar_lock;
inline std::condition_variable mbar_cv;

// bits [0, 11) pending arrivals, [11, 22) arrival count, 22 phase,
// [32, 64) transaction count (signed)
struct MbarState {
  uint32_t pending, count, phase;
  int32_t tx;
};

inline MbarState mbar_load(const uint64_t* bar) {
  uint64_t v;
  std::memcpy(&v, bar, 8);
  return MbarState{static_cast<uint32_t>(v & 0x7FF), static_cast<uint32_t>((v >> 11) & 0x7FF),
                   static_cast<uint32_t>((v >> 22) & 1), static_cast<int32_t>(v >> 32)};
}

inline void mbar_store(uint64_t* bar, MbarState s) {
  const uint64_t v = s.pending | (static_cast<uint64_t>(s.count) << 11) |
                     (static_cast<uint64_t>(s.phase) << 22) |
                     (static_cast<uint64_t>(static_cast<uint32_t>(s.tx)) << 32);
  std::memcpy(bar, &v, 8);
}

// under the lock: one arrival and/or a change of the transaction count
inline void mbar_update(uint64_t* bar, int arrivals, int32_t tx) {
  MbarState s = mbar_load(bar);
  if (arrivals > static_cast<int>(s.pending)) {
    std::fprintf(stderr, "tk_emu: mbarrier arrival past its count\n");
    std::abort();
  }
  s.pending -= arrivals;
  s.tx += tx;
  if (s.pending == 0 && s.tx == 0) {
    s.phase ^= 1;
    s.pending = s.count;
  }
  mbar_store(bar, s);
  mbar_cv.notify_all();
}

inline uint32_t smem_offset(const void* p) {
  const auto* c = static_cast<const unsigned char*>(p);
  const auto* base = reinterpret_cast<const unsigned char*>(smem);
  if (c < base || c >= base + sizeof(smem)) {
    std::fprintf(stderr, "tk_emu: a shared-memory operand outside shared memory\n");
    std::abort();
  }
  return static_cast<uint32_t>(c - base);
}

inline unsigned char* smem_bytes() { return reinterpret_cast<unsigned char*>(smem); }

// the 128B swizzle of a shared-memory byte offset
inline uint32_t swizzle128(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

struct WgmmaOp {
  float* d;
  uint64_t da, db;
  int accumulate, ta, tb;
  long group;
};
inline thread_local std::vector<WgmmaOp> wgmma_queue;
inline thread_local long wgmma_groups = 0;  // groups committed by this thread

// byte offset of element (mn, k) of a 16-bit operand through descriptor
// `desc`, K-major (tnsp 0) or MN-major (tnsp 1)
inline uint32_t operand_offset(uint64_t desc, int tnsp, int mn, int k) {
  if ((desc >> 62) != 1 || ((desc >> 49) & 7) != 0) {
    std::fprintf(stderr, "tk_emu: wgmma descriptor not 128B-swizzled or with a base offset\n");
    std::abort();
  }
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  const uint32_t canonical =
      tnsp == 0 ? start + (mn % 8) * 128 + (mn / 8) * sbo + k * 2
                : start + (mn % 64) * 2 + (mn / 64) * lbo + (k % 8) * 128 + (k / 8) * sbo;
  return swizzle128(canonical);
}

inline float smem_bf16(uint32_t off) {
  uint16_t bits;
  std::memcpy(&bits, smem_bytes() + off, 2);
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

inline void wgmma_run(const WgmmaOp& op) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  float a[2][16];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 16; ++k)
      a[h][k] = smem_bf16(operand_offset(op.da, op.ta, 16 * w + g + 8 * h, k));
  for (int i = 0; i < 128; ++i) {
    const int h = (i / 2) % 2, col = 8 * (i / 4) + 2 * q + i % 2;
    float sum = op.accumulate ? op.d[i] : 0.f;
    for (int k = 0; k < 16; ++k) sum += a[h][k] * smem_bf16(operand_offset(op.db, op.tb, col, k));
    op.d[i] = sum;
  }
}

// bulk copies issued and not yet landed, under mbar_lock
struct BulkCopy {
  uint64_t* bar;
  unsigned char* dst;
  const unsigned char* src;
  uint32_t bytes;
};
inline std::vector<BulkCopy> bulk_pending;

// under the lock: land every pending bulk copy of `bar`
inline void bulk_land(uint64_t* bar) {
  std::vector<BulkCopy> kept;
  for (const BulkCopy& c : bulk_pending) {
    if (c.bar != bar) {
      kept.push_back(c);
      continue;
    }
    std::memcpy(c.dst, c.src, c.bytes);
    mbar_update(bar, 0, -static_cast<int32_t>(c.bytes));
  }
  bulk_pending.swap(kept);
}

}  // namespace tk_emu

inline uint32_t smem_addr(const void* p) { return tk_emu::smem_offset(p); }

inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(tk_emu::mbar_lock);
  for (const tk_emu::BulkCopy& c : tk_emu::bulk_pending)
    if (c.bar == bar) {  // an earlier block issued it and never waited
      std::fprintf(stderr, "tk_emu: a bulk copy was never waited on\n");
      std::abort();
    }
  tk_emu::mbar_store(bar, tk_emu::MbarState{count, count, 0, 0});
}

inline void mbar_fence_init() {}

inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(tk_emu::mbar_lock);
  tk_emu::mbar_update(bar, 1, 0);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(tk_emu::mbar_lock);
  tk_emu::mbar_update(bar, 0, static_cast<int32_t>(bytes));
  tk_emu::mbar_update(bar, 1, 0);
}

inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::lock_guard<std::mutex> lock(tk_emu::mbar_lock);
  tk_emu::bulk_land(bar);
  return tk_emu::mbar_load(bar).phase != (parity & 1);
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(tk_emu::mbar_lock);
  const bool done = tk_emu::mbar_cv.wait_for(lock, std::chrono::seconds(60), [&] {
    tk_emu::bulk_land(bar);  // copies issued while this thread waits land too
    return tk_emu::mbar_load(bar).phase != (parity & 1);
  });
  if (!done) {
    std::fprintf(stderr, "tk_emu: mbarrier wait (parity %u) deadlocked\n", parity);
    std::abort();
  }
}

namespace tk_emu {

// The box of `map` at (c0, c1, c2) into shared memory at dst, swizzled;
// zeros where a coordinate falls outside its dimension.
inline void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, uint32_t rank, int c0,
                     int c1, int c2) {
  const uint32_t base = smem_offset(dst);
  if (base % 1024 != 0 || map->swizzle != CU_TENSOR_MAP_SWIZZLE_128B || map->box[0] != 64) {
    std::fprintf(stderr, "tk_emu: TMA box not 1024-aligned or not a 128B-swizzled 64-wide box\n");
    std::abort();
  }
  if (map->rank != rank) {
    std::fprintf(stderr, "tk_emu: a rank-%u tensor map in a %uD TMA load\n", map->rank, rank);
    std::abort();
  }
  const auto in = [](int64_t x, uint64_t n) { return x >= 0 && static_cast<uint64_t>(x) < n; };
  for (uint32_t z = 0; z < map->box[2]; ++z)
    for (uint32_t r = 0; r < map->box[1]; ++r)
      for (uint32_t c = 0; c < 64; ++c) {
        const int64_t plane = static_cast<int64_t>(c2) + z, row = static_cast<int64_t>(c1) + r,
                      col = static_cast<int64_t>(c0) + c;
        uint16_t v = 0;
        if (in(plane, map->dims[2]) && in(row, map->dims[1]) && in(col, map->dims[0]))
          std::memcpy(&v, map->base + plane * map->stride[1] + row * map->stride[0] + col * 2, 2);
        const uint32_t at = base + (z * map->box[1] + r) * 128 + c * 2;
        std::memcpy(smem_bytes() + swizzle128(at), &v, 2);
      }
  std::lock_guard<std::mutex> lock(mbar_lock);
  mbar_update(bar, 0, -static_cast<int32_t>(128 * map->box[1] * map->box[2]));
}

// generic-proxy stores not yet made visible to the async proxy, per thread
inline thread_local std::vector<uint32_t> pending_zero16;

}  // namespace tk_emu

inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  tk_emu::tma_load(dst, map, bar, 2, c0, c1, 0);
}

inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                        int c2) {
  tk_emu::tma_load(dst, map, bar, 3, c0, c1, c2);
}

inline void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t off = tk_emu::smem_offset(dst);
  tk_emu::smem_offset(static_cast<unsigned char*>(dst) + bytes - 1);  // the end in smem too
  if (off % 16 != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0 || bytes % 16 != 0 ||
      bytes == 0) {
    std::fprintf(stderr, "tk_emu: bulk copy not 16-byte aligned or sized\n");
    std::abort();
  }
  std::lock_guard<std::mutex> lock(tk_emu::mbar_lock);
  tk_emu::bulk_pending.push_back(tk_emu::BulkCopy{bar, static_cast<unsigned char*>(dst),
                                                  static_cast<const unsigned char*>(src), bytes});
  tk_emu::mbar_cv.notify_all();
}

// Emulated launches run one after another, so a grid's predecessors have
// always ended.
inline void grid_dependency_wait() {}
inline void grid_launch_dependents() {}

// A generic-proxy store waits in the thread's queue until its
// fence_proxy_async, so an async-proxy read (wgmma) before the fence sees
// the old bytes, as the card may.
inline void st_shared_zero16(void* p) {
  const uint32_t off = tk_emu::smem_offset(p);
  if (off % 16 != 0) {
    std::fprintf(stderr, "tk_emu: st_shared_zero16 at an address not 16-byte aligned\n");
    std::abort();
  }
  tk_emu::pending_zero16.push_back(off);
}

inline void fence_proxy_async() {
  for (uint32_t off : tk_emu::pending_zero16) std::memset(tk_emu::smem_bytes() + off, 0, 16);
  tk_emu::pending_zero16.clear();
}

inline void named_barrier_sync(int id, int count) { tk_emu::named_sync(id, count); }

template <int N>
inline void setmaxnreg_dec() {}
template <int N>
inline void setmaxnreg_inc() {}

inline uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

inline void wgmma_fence() {}
inline void wgmma_fence_regs(float (&)[128]) {}

inline void wgmma_commit() {
  ++tk_emu::wgmma_groups;
  for (auto& op : tk_emu::wgmma_queue)
    if (op.group < 0) op.group = tk_emu::wgmma_groups;
}

template <int N>
inline void wgmma_wait() {
  auto& queue = tk_emu::wgmma_queue;
  std::vector<tk_emu::WgmmaOp> kept;
  for (const auto& op : queue) {
    if (op.group >= 0 && op.group <= tk_emu::wgmma_groups - N)
      tk_emu::wgmma_run(op);
    else
      kept.push_back(op);
  }
  queue.swap(kept);
}

template <int TA, int TB>
inline void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  tk_emu::wgmma_queue.push_back(tk_emu::WgmmaOp{d, da, db, accumulate, TA, TB, -1});
}

using TensorMapEncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                       const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                       const cuuint32_t*, CUtensorMapInterleave,
                                       CUtensorMapSwizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill);

inline TensorMapEncodeFn tensor_map_encoder() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess)
    return nullptr;
  return reinterpret_cast<TensorMapEncodeFn>(p);
}

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
