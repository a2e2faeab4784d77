// Host stand-ins for the CUDA built-ins that the kernels of
// mccortex_tpu_torch/csrc use, so that g++ can compile a kernel and a CPU
// can run it: one host thread per CUDA thread, the blocks of a grid one
// after another.  __syncthreads is a barrier over the block; a warp
// shuffle, ballot or any is an exchange buffer per warp between two
// barriers over its 32 threads; __shared__ is static (one block at a time);
// __threadfence is a sequentially consistent fence; atomicAdd is a
// std::atomic_ref add.  Because blocks run in
// order, a block that waits on an earlier block's published state (the
// look-back of a single-pass scan) always finds it there: such waits are
// checked by reading the code, not here.
// Slow (thousands of futex waits per tile), so for logic, not for speed.
// See emulate.py for how a .cu is rewritten to include this.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
using std::max;
using std::min;

struct EmuDim { int x = 0, y = 0, z = 0; };
inline thread_local EmuDim threadIdx, blockIdx, blockDim, gridDim;
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }

namespace emu {
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barrier;
inline uint64_t exchange[64][32];        // per warp, per lane
alignas(16) inline uint32_t dynamic_shared[64 * 1024];
inline int warp() { return threadIdx.x >> 5; }
inline int lane() { return threadIdx.x & 31; }
inline void warp_sync() { warp_barrier[warp()]->arrive_and_wait(); }

// kernel<<<grid, block>>>(args) becomes launch(grid, block, [=] {...})
template <class F>
void launch(int grid, int block, F body) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    block_barrier = &bar;
    warp_barrier.clear();
    for (int w = 0; w < (block + 31) / 32; ++w) {
      warp_barrier.emplace_back(
          new std::barrier<>(std::min(32, block - 32 * w)));
    }
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = block;
        gridDim.x = grid;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
}
}  // namespace emu

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_sync(); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 8);
  uint64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  emu::exchange[emu::warp()][emu::lane()] = raw;
  emu::warp_sync();
  raw = emu::exchange[emu::warp()][src & 31];
  emu::warp_sync();
  T out;
  std::memcpy(&out, &raw, sizeof(T));
  return out;
}

template <class T>
T __shfl_xor_sync(unsigned mask, T v, int d) {
  return __shfl_sync(mask, v, emu::lane() ^ d);
}

// a lane whose source lies outside the warp keeps its own value
template <class T>
T __shfl_up_sync(unsigned mask, T v, unsigned d) {
  const int src = emu::lane() - (int)d;
  return __shfl_sync(mask, v, src < 0 ? emu::lane() : src);
}

template <class T>
T __shfl_down_sync(unsigned mask, T v, unsigned d) {
  const int src = emu::lane() + (int)d;
  return __shfl_sync(mask, v, src > 31 ? emu::lane() : src);
}

inline unsigned __ballot_sync(unsigned, bool pred) {
  emu::exchange[emu::warp()][emu::lane()] = pred;
  emu::warp_sync();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) {
    bits |= (unsigned)(emu::exchange[emu::warp()][i] != 0) << i;
  }
  emu::warp_sync();
  return bits;
}

inline bool __any_sync(unsigned mask, bool pred) {
  return __ballot_sync(mask, pred) != 0;
}

// a 16-byte cp.async: the card faults on an address that is not a multiple
// of 16, so the stand-in stops there too
inline void emu_copy16(uint4* dst, const uint4* src) {
  if ((((uintptr_t)dst) | ((uintptr_t)src)) & 15) abort();
  std::memcpy((void*)dst, (const void*)src, 16);
}

template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
// the upper / lower 32 bits of the 64-bit hi:lo shifted by shift & 31
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t x = ((uint64_t)hi << 32) | lo;
  return (unsigned)((x << (shift & 31)) >> 32);
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t x = ((uint64_t)hi << 32) | lo;
  return (unsigned)(x >> (shift & 31));
}
