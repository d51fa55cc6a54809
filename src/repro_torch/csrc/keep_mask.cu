// Compaction keep mask: ts (C,) int32 -> keep (C,) int32 = (ts > cutoff),
// plus counts (n_tiles,) int32, the survivors of each tile of `tile` cells.
// VersionedStore.compact() uses the mask to pick the cells that outlive the
// horizon.
//
// Replaces the TPU kernel src/repro/kernels/compact_rewrite.py:35
// (_keep_mask_kernel).
//
// Bound on this card: bytes. It reads C*4 bytes and writes C*4 + n_tiles*4
// bytes, with one compare per cell.
//
// Design: one block per tile; thread i of the block handles cells
// i, i + blockDim, i + 2*blockDim, ... of the tile, so every load and store
// of a warp covers 128 contiguous bytes; the count is a warp reduction plus
// one shared int per warp. The ragged last tile is masked in the kernel.
#include "common.cuh"

namespace {

constexpr int kItems = 4;

__global__ void keep_mask_kernel(const int32_t* __restrict__ ts, long long c,
                                 int32_t cutoff, int32_t* __restrict__ keep,
                                 int32_t* __restrict__ counts) {
  __shared__ int scratch[32];
  const long long base =
      static_cast<long long>(blockIdx.x) * blockDim.x * kItems + threadIdx.x;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + static_cast<long long>(k) * blockDim.x;
    if (i < c) {
      const int m = __ldg(ts + i) > cutoff;
      keep[i] = m;
      s += m;
    }
  }
  const int total = repro::block_sum(s, scratch);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

}  // namespace

// ts, keep: (c,) int32; counts: (n_tiles,) int32, n_tiles = ceil(c / (block * 4)).
extern "C" int keep_mask_launch(const int32_t* ts, long long c, int cutoff,
                                int32_t* keep, int32_t* counts, int n_tiles,
                                int block, void* stream) {
  if (c > 0)
    keep_mask_kernel<<<n_tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
        ts, c, cutoff, keep, counts);
  return static_cast<int>(cudaGetLastError());
}
