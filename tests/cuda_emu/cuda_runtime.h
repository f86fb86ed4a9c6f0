// CPU stand-in for the CUDA runtime, just enough to run
// ops/cuda/poa_dp.cu's kernel on the host for tests: one std::thread per
// CUDA thread of a block, a block-wide barrier for __syncthreads and a
// per-warp barrier pair around each shuffle.  Blocks run one at a time.
#pragma once
#include <barrier>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static  // one block at a time: statics are its shared memory

struct EmuDim3 {
  unsigned x, y, z;
};
inline thread_local EmuDim3 threadIdx, blockIdx;
inline EmuDim3 blockDim;

typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
const cudaError_t cudaSuccess = 0;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }

inline std::unique_ptr<std::barrier<>> emu_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline float emu_lanes[32][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline float __shfl_up_sync(unsigned, float x, int off) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_lanes[w][l] = x;
  emu_warp_barriers[w]->arrive_and_wait();
  const float y = l >= off ? emu_lanes[w][l - off] : x;
  emu_warp_barriers[w]->arrive_and_wait();
  return y;
}

// Runs kernel(args...) as `blocks` blocks of `threads` threads.
template <typename Kernel, typename... Args>
void emu_launch(Kernel kernel, int blocks, int threads, Args... args) {
  blockDim = {unsigned(threads), 1, 1};
  for (int b = 0; b < blocks; ++b) {
    emu_block_barrier = std::make_unique<std::barrier<>>(threads);
    emu_warp_barriers.clear();
    for (int w = 0; w < threads / 32; ++w) {
      emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([=]() {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(b), 0, 0};
        kernel(args...);
      });
    }
    for (auto& th : pool) th.join();
  }
}
