// Key -> shard routing: (N, W) int32 little-endian key lanes + (N,) int32
// key byte lengths -> (N,) int32 shard ids in [0, n_shards), routing version
// "xor-rotate-fold-v1". The scatter step of every ShardedStore.update,
// delete and ShardedReleaseSession.apply.
//
// Replaces the TPU kernel src/repro/kernels/shard_route.py:40
// (_shard_route_kernel). The route is a persistent partitioning function
// (its version is written into SHARD_MANIFEST.json), so the ids must equal
// the reference's bit for bit on every key.
//
// Bound on this card: bytes. It reads N*W*4 + N*4 bytes and writes N*4,
// with about 8 integer operations per lane and 5 per key. At the smoke
// store's keys (611k keys of 9 bytes, W = 3) that is about 12 MB, a few
// microseconds: the launch costs more than the work, and the host packing
// of the key bytes (kernels/shard_route.key_lanes) far more than both.
//
// Design: one thread per key, looping over its W lanes, all arithmetic on
// uint32_t (unsigned wraps, where signed overflow is undefined in C++), so
// `>>` is the logical shift the reference takes
// (jax.lax.shift_right_logical) and the multiplies give the bits of the
// reference's int32 wraparound. The rotate amount (j % 31) + 1 is never 0
// or 32. The final `& 0x7FFFFFFF` leaves a non-negative value, so `%`
// equals the reference's int32 remainder.
#include "common.cuh"

namespace {

constexpr uint32_t kMul1 = 0x9E3779B1u;  // -1640531535 as int32
constexpr uint32_t kMul2 = 0x85EBCA77u;  // -2048144777
constexpr uint32_t kMul3 = 0xC2B2AE3Du;  // -1028477379
constexpr uint32_t kMul4 = 0x27D4EB2Fu;  //   668265263

__global__ void shard_route_kernel(const int32_t* __restrict__ lanes,
                                   const int32_t* __restrict__ lengths,
                                   int32_t* __restrict__ out, long long n,
                                   int w, uint32_t n_shards) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int32_t* row = lanes + i * w;
  uint32_t h = 0;
  for (int j = 0; j < w; ++j) {
    uint32_t t = static_cast<uint32_t>(__ldg(row + j)) * kMul1;
    t ^= t >> 15;
    t *= kMul2;
    const int r = (j % 31) + 1;
    h ^= (t << r) | (t >> (32 - r));
  }
  h ^= static_cast<uint32_t>(__ldg(lengths + i)) * kMul3;
  h ^= h >> 16;
  h *= kMul4;
  h ^= h >> 13;
  out[i] = static_cast<int32_t>((h & 0x7FFFFFFFu) % n_shards);
}

}  // namespace

// lanes: (n, w) int32 contiguous; lengths, out: (n,) int32; n_shards >= 1.
extern "C" int shard_route_launch(const int32_t* lanes,
                                  const int32_t* lengths, int32_t* out,
                                  long long n, int w, int n_shards, int block,
                                  void* stream) {
  if (n > 0) {
    const long long grid = (n + block - 1) / block;
    shard_route_kernel<<<static_cast<unsigned>(grid), block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        lanes, lengths, out, n, w, static_cast<uint32_t>(n_shards));
  }
  return static_cast<int>(cudaGetLastError());
}
