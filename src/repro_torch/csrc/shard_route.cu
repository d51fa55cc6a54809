// Key -> shard routing, routing version "xor-rotate-fold-v1": (N,) int32
// shard ids in [0, n_shards). The scatter step of every ShardedStore.update,
// delete and ShardedReleaseSession.apply.
//
// Replaces the TPU kernel src/repro/kernels/shard_route.py:40
// (_shard_route_kernel). The route is a persistent partitioning function
// (its version is written into SHARD_MANIFEST.json), so the ids must equal
// the reference's bit for bit on every key.
//
// Two entry points, one fold:
// * shard_route_bytes_launch, the store's route: every key's bytes laid end
//   to end in one flat buffer, and (N + 1,) int64 offsets. A thread builds
//   its key's little-endian lanes in registers from the aligned 4-byte
//   words that hold its bytes (a funnel shift joins two words where the key
//   starts off a word boundary) and zeroes the bytes past the key in its
//   last lane. It folds only the key's ceil(len / 4) lanes: a zero lane
//   contributes nothing. A warp's keys lie next to each other in the
//   buffer, so its word loads are coalesced. A word is loaded only where it
//   holds a byte of the key; an aligned 4-byte word that holds one byte of
//   the buffer lies within that byte's allocation, so the bytes around the
//   key that it also brings (and that are masked or shifted out) are safe
//   to read. This entry point is what lets the host skip packing keys into
//   padded (N, W) lanes one key at a time (kernels/shard_route.key_lanes).
// * shard_route_launch: (N, W) int32 little-endian key lanes + (N,) int32
//   key byte lengths, as the JAX package's kernel takes them. It folds all
//   W lanes of a row, as the reference does.
//
// Bound on this card: bytes. The byte form reads the key bytes, the
// offsets (8 bytes a key) and writes 4 bytes a key, with about 8 integer
// operations per lane and 5 per key: at the smoke store's 611k keys of 9
// bytes about 10 MB, a few microseconds, so the launch costs more than the
// work.
//
// All arithmetic on uint32_t (unsigned wraps, where signed overflow is
// undefined in C++), so `>>` is the logical shift the reference takes
// (jax.lax.shift_right_logical) and the multiplies give the bits of the
// reference's int32 wraparound. Lane j rotates by (j % 31) + 1, never 0 or
// 32, also past 31 lanes (keys of more than 124 bytes). The final
// `& 0x7FFFFFFF` leaves a non-negative value, so `%` equals the
// reference's int32 remainder.
#include "common.cuh"

namespace {

constexpr uint32_t kMul1 = 0x9E3779B1u;  // -1640531535 as int32
constexpr uint32_t kMul2 = 0x85EBCA77u;  // -2048144777
constexpr uint32_t kMul3 = 0xC2B2AE3Du;  // -1028477379
constexpr uint32_t kMul4 = 0x27D4EB2Fu;  //   668265263

// h with lane x folded in, rotated by r in [1, 31]
__device__ __forceinline__ uint32_t fold_lane(uint32_t h, uint32_t x, int r) {
  uint32_t t = x * kMul1;
  t ^= t >> 15;
  t *= kMul2;
  return h ^ ((t << r) | (t >> (32 - r)));
}

__device__ __forceinline__ int32_t shard_of(uint32_t h, uint32_t len,
                                            uint32_t n_shards) {
  h ^= len * kMul3;
  h ^= h >> 16;
  h *= kMul4;
  h ^= h >> 13;
  return static_cast<int32_t>((h & 0x7FFFFFFFu) % n_shards);
}

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
    h = fold_lane(h, static_cast<uint32_t>(__ldg(row + j)), (j % 31) + 1);
  }
  out[i] = shard_of(h, static_cast<uint32_t>(__ldg(lengths + i)), n_shards);
}

__global__ void shard_route_bytes_kernel(const uint8_t* __restrict__ flat,
                                         const long long* __restrict__ offsets,
                                         int32_t* __restrict__ out,
                                         long long n, uint32_t n_shards) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long start = __ldg(offsets + i);
  const uint32_t len = static_cast<uint32_t>(__ldg(offsets + i + 1) - start);
  const uintptr_t first = reinterpret_cast<uintptr_t>(flat + start);
  const uintptr_t end = first + len;  // one past the key's last byte
  const uint32_t* word =
      reinterpret_cast<const uint32_t*>(first & ~uintptr_t{3});
  const uint32_t shift = static_cast<uint32_t>(first & 3) * 8;
  uint32_t h = 0;
  uint32_t cur = len > 0 ? __ldg(word) : 0u;
  int r = 1;
  for (uint32_t j = 0; 4 * j < len; ++j) {
    const uint32_t* next = word + j + 1;
    const uint32_t nxt =
        reinterpret_cast<uintptr_t>(next) < end ? __ldg(next) : 0u;
    // bytes 4j .. 4j + 3 of the key, the first in the low byte
    uint32_t x = __funnelshift_r(cur, nxt, shift);
    const uint32_t left = len - 4 * j;
    if (left < 4) x &= (1u << (8 * left)) - 1u;
    h = fold_lane(h, x, r);
    r = r == 31 ? 1 : r + 1;
    cur = nxt;
  }
  out[i] = shard_of(h, len, n_shards);
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

// flat: every key's bytes end to end; offsets: (n + 1,) int64, key i is
// flat[offsets[i], offsets[i + 1]); out: (n,) int32; n_shards >= 1.
extern "C" int shard_route_bytes_launch(const uint8_t* flat,
                                        const long long* offsets,
                                        int32_t* out, long long n,
                                        int n_shards, int block,
                                        void* stream) {
  if (n > 0) {
    const long long grid = (n + block - 1) / block;
    shard_route_bytes_kernel<<<static_cast<unsigned>(grid), block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        flat, offsets, out, n, static_cast<uint32_t>(n_shards));
  }
  return static_cast<int>(cudaGetLastError());
}
