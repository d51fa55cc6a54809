// Shared by every kernel library of the port: each .cu includes this once,
// so each shared library exports its own copy of the error-string lookup
// that the Python side (kernels/_build.py) calls after a non-zero launch
// return code.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Sum of `v` over the block, valid in thread 0 only. `scratch` holds one
// int per warp; the caller syncs before reusing it.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFullMask, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    total = __reduce_add_sync(kFullMask, lane < n_warps ? scratch[lane] : 0);
  }
  return total;
}

// Signed max of `v` over the block, valid in thread 0 only (INT32_MIN for
// an empty reduction). Same scratch contract as block_sum.
__device__ __forceinline__ int block_max(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_max_sync(kFullMask, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = INT32_MIN;
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    total = __reduce_max_sync(kFullMask,
                              lane < n_warps ? scratch[lane] : INT32_MIN);
  }
  return total;
}

}  // namespace repro
