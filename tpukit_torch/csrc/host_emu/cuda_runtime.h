// Host emulation of the part of the CUDA runtime and device language that the
// port's kernels (tpukit_torch/csrc/*.cu) use, so that g++ can build them for
// the CPU tests. Every thread of a block is a std::thread; blocks run one
// after another and share one dynamic shared-memory buffer; __syncthreads is
// a barrier over the block's threads; warp shuffles exchange through a
// per-block array between two barriers of the warp; a per-warp barrier also
// orders the warp matrix functions of mma.h and tk_mma.cuh. Launch statements are rewritten by
// the test (`kernel<<<grid, threads, smem, stream>>>(args)` becomes
// `tk_emu::launch(kernel, grid, threads, smem, stream, args)`).
//
// It checks the kernels' arithmetic, indexing and synchronisation logic; it
// says nothing of their speed, and it cannot catch what only nvcc or the
// card would refuse.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

struct alignas(16) uint4 {
  unsigned int x, y, z, w;
};

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) { return cudaSuccess; }

inline int min(int a, int b) { return a < b ? a : b; }
inline float __expf(float x) { return std::exp(x); }
inline float __uint_as_float(unsigned int u) {
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
}
inline unsigned int __float_as_uint(float f) {
  unsigned int u;
  std::memcpy(&u, &f, sizeof(u));
  return u;
}
inline int max(int a, int b) { return a > b ? a : b; }

// The kernels declare `extern __shared__ float smem[];` inside functions of
// the source's unnamed namespace; this is that namespace's definition.
namespace {
constexpr size_t kEmuSmemFloats = 232448 / sizeof(float);
alignas(128) float smem[kEmuSmemFloats];
}  // namespace

namespace tk_emu {

inline std::barrier<>* block_barrier = nullptr;
inline std::vector<std::barrier<>*> warp_barriers;
inline std::vector<uint64_t> exchange;

inline void sync() { block_barrier->arrive_and_wait(); }
inline void warp_sync() { warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }

template <typename T>
T shfl_xor(T v, int o) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "shuffle of a wide type");
  const unsigned tid = threadIdx.x;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  exchange[tid] = bits;
  warp_sync();
  bits = exchange[tid ^ static_cast<unsigned>(o)];
  warp_sync();
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, dim3 grid, int threads, size_t smem_bytes, cudaStream_t,
            Args... args) {
  if (smem_bytes > sizeof(float) * kEmuSmemFloats || threads % 32 != 0) {
    std::fprintf(stderr, "tk_emu: launch refused (%zu B shared, %d threads)\n", smem_bytes,
                 threads);
    std::abort();
  }
  blockDim = dim3(threads);
  gridDim = grid;
  exchange.assign(threads, 0);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        // garbage, not zeros: a kernel that reads shared memory it did not
        // write must not pass by luck
        for (size_t i = 0; i < kEmuSmemFloats; ++i) smem[i] = std::nanf("");
        std::barrier<> bar(threads);
        block_barrier = &bar;
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        warp_barriers.clear();
        for (int w = 0; w < threads / 32; ++w) {
          warps.push_back(std::make_unique<std::barrier<>>(32));
          warp_barriers.push_back(warps.back().get());
        }
        std::vector<std::thread> pool;
        pool.reserve(threads);
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([=] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
          });
        for (auto& th : pool) th.join();
        block_barrier = nullptr;
      }
}

}  // namespace tk_emu

inline void __syncthreads() { tk_emu::sync(); }
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int o) { return tk_emu::shfl_xor(v, o); }
