// Delta codec: out = a op b over an (N, W) row-major pair of integer lanes,
// op in {sub, add, xor}, plus one int32 stat per tile of `tile_rows` rows.
// The on-disk chain codec (kernels/delta_codec.py: chain_pack) packs every
// segment through it: sub for integer fields, xor of the bits for floats.
//
// Replaces the TPU kernels of src/repro/kernels/delta_codec.py:
//   :56 _pack_int_kernel    sub, stat = max |d| widened to int32
//   :63 _pack_xor_kernel    xor, stat = count of nonzero lanes
//   :69 _unpack_int_kernel  add, stat 0
//   :74 _unpack_xor_kernel  xor, stat 0
//   :154 _pack_wide_kernel, :166 _unpack_wide_kernel, :179 _xor_wide_kernel
//       the 64-bit sub / add / xor. The TPU split each value into (lo, hi)
//       int32 lanes with an explicit borrow or carry; Hopper has native
//       64-bit integers, so here they are the same template at int64.
//
// Arithmetic is done in the unsigned type of the lane's width (signed
// overflow is undefined in C++), so every result is the two's-complement
// wraparound the JAX package computes, whatever the stored dtype: uint16 and
// uint32 fields arrive as the signed int of their width and come back with
// the same bits.
//
// Stat, one per tile (the TPU kernel's 512-row tile, so the two compare one
// for one). A ragged last tile counts as padded with zero rows, as the TPU
// launch pads it:
//   kMaxAbs          max over the tile of |int32(d)|, d sign-extended;
//                    |INT32_MIN| wraps to INT32_MIN, as jnp.abs does
//   kMaxAbsUnsigned  the same with d zero-extended (uint8/uint16 fields)
//   kNonZero         count of d != 0
//   kNone            0
//
// Bound on this card: bytes. It reads 2*N*W*s and writes N*W*s bytes plus
// 4 bytes per tile, with one integer op per lane.
//
// Design. The grid is decoupled from the stat tile: a tile's flat range
// (tile_rows * W lanes) is cut into blocks_per_tile chunks of `chunk`
// lanes (at most 16 KB of each operand; the host plan,
// kernels/delta_codec.py: codec_plan). A block alone has up to 1,024
// threads, one 16-byte vector of each operand per thread, every load in
// flight at once: at W = 8 int32 a 16 KB tile is one such block. A tile
// with a stat over more chunks is a thread block cluster of at most 8
// blocks of 256 threads (clusters of larger blocks streamed slower on the
// card): at W = 64 int32, 8 blocks of 16 KB, where one block per 128 KB
// tile left a partial last wave (1,434 blocks, at most 1,056 resident).
// Blocks stream their chunk as 16-byte vectors, two per thread at a time
// (__ldcs / __stcs, 32-bit offsets inside the chunk). A scalar head runs
// up to the first 16-byte aligned lane and a scalar tail after the last
// whole vector; a, b and out share their alignment mod 16 (the wrapper
// allocates out so), else every lane goes scalar.
//
// The stat: a warp reduction plus one shared int per warp gives each
// block's partial, which a block alone writes out. In a cluster the word
// the blocks fold into lives in the shared memory of the cluster's first
// block: it sets the word to the identity (INT32_MIN, or 0 for the count)
// before a cluster barrier's arrive, every block waits on that barrier
// after its streaming, folds its partial into the word with an atomicMax
// (atomicAdd for the count) through distributed shared memory, and after
// a second cluster barrier the first block writes the word out. Integer
// max and sum do not depend on order, so the stats are exact, and no word
// outside the launch needs a value beforehand: one launch per call, where
// atomics into global words would need a fill first.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

enum Op : int { kSub = 0, kAdd = 1, kXor = 2 };
enum Stat : int { kNone = 0, kMaxAbs = 1, kMaxAbsUnsigned = 2, kNonZero = 3 };

template <typename T> struct Unsigned;
template <> struct Unsigned<int8_t> { using type = uint8_t; };
template <> struct Unsigned<int16_t> { using type = uint16_t; };
template <> struct Unsigned<int32_t> { using type = uint32_t; };
template <> struct Unsigned<int64_t> { using type = uint64_t; };

template <typename T, int kOp, int kStat>
struct Lane {
  using U = typename Unsigned<T>::type;
  // a op b on one lane, folding its stat into `acc`
  static __device__ __forceinline__ T run(T a, T b, int& acc) {
    const U x = static_cast<U>(a);
    const U y = static_cast<U>(b);
    U r;
    if constexpr (kOp == kSub) {
      r = static_cast<U>(x - y);
    } else if constexpr (kOp == kAdd) {
      r = static_cast<U>(x + y);
    } else {
      r = static_cast<U>(x ^ y);
    }
    if constexpr (kStat == kNonZero) {
      acc += r != 0;
    } else if constexpr (kStat == kMaxAbs || kStat == kMaxAbsUnsigned) {
      const int32_t w = kStat == kMaxAbsUnsigned
                            ? static_cast<int32_t>(r)
                            : static_cast<int32_t>(static_cast<T>(r));
      const uint32_t u = static_cast<uint32_t>(w);
      acc = max(acc, static_cast<int32_t>(w < 0 ? 0u - u : u));
    }
    return static_cast<T>(r);
  }
};

template <typename T>
union Vec {
  int4 v;
  T lane[16 / sizeof(T)];
};

template <typename T, int kOp, int kStat>
__device__ __forceinline__ int4 run_vec(int4 x, int4 y, int& acc) {
  Vec<T> a, b, r;
  a.v = x;
  b.v = y;
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) {
    r.lane[i] = Lane<T, kOp, kStat>::run(a.lane[i], b.lane[i], acc);
  }
  return r.v;
}

template <typename T, int kOp, int kStat>
__global__ void __launch_bounds__(1024)
codec_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ out, int32_t* __restrict__ stats,
             int32_t identity, long long n_rows, long long width,
             long long tile_rows, int blocks_per_tile, int chunk, int vec) {
  using L = Lane<T, kOp, kStat>;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ int scratch[32];
  __shared__ int word;  // the tile's stat, in the cluster's first block
  const int tile = static_cast<int>(blockIdx.x) / blocks_per_tile;
  const int part = static_cast<int>(blockIdx.x) % blocks_per_tile;
  const bool cluster = kStat != kNone && blocks_per_tile > 1;
  if (cluster) {
    if (part == 0 && threadIdx.x == 0) word = identity;
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
  const long long row0 = static_cast<long long>(tile) * tile_rows;
  const long long rows = min(tile_rows, n_rows - row0);
  const long long lo = static_cast<long long>(part) * chunk;
  const int n = static_cast<int>(
      max(min(lo + chunk, rows * width) - lo, 0ll));
  const long long begin = row0 * width + lo;
  const T* pa = a + begin;
  const T* pb = b + begin;
  T* po = out + begin;
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  int acc = kStat == kNonZero ? 0 : INT32_MIN;
  if (vec) {
    // lanes before the first 16-byte boundary, whole vectors, the rest
    const int head = min(
        static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(po) & 15)) & 15) /
                         sizeof(T)),
        n);
    const int n_vec = (n - head) / kVec;
    for (int i = tid; i < head; i += step) po[i] = L::run(pa[i], pb[i], acc);
    const int4* va = reinterpret_cast<const int4*>(pa + head);
    const int4* vb = reinterpret_cast<const int4*>(pb + head);
    int4* vo = reinterpret_cast<int4*>(po + head);
    int i = tid;
    for (; i + step < n_vec; i += 2 * step) {
      const int4 x0 = __ldcs(va + i), x1 = __ldcs(va + i + step);
      const int4 y0 = __ldcs(vb + i), y1 = __ldcs(vb + i + step);
      __stcs(vo + i, run_vec<T, kOp, kStat>(x0, y0, acc));
      __stcs(vo + i + step, run_vec<T, kOp, kStat>(x1, y1, acc));
    }
    for (; i < n_vec; i += step) {
      __stcs(vo + i, run_vec<T, kOp, kStat>(__ldcs(va + i), __ldcs(vb + i),
                                             acc));
    }
    for (int j = head + n_vec * kVec + tid; j < n; j += step) {
      po[j] = L::run(pa[j], pb[j], acc);
    }
  } else {
    for (int j = tid; j < n; j += step) po[j] = L::run(pa[j], pb[j], acc);
  }
  if constexpr (kStat == kNone) {
    if (part == 0 && tid == 0) stats[tile] = 0;
  } else {
    int total = kStat == kNonZero ? repro::block_sum(acc, scratch)
                                  : repro::block_max(acc, scratch);
    if (kStat != kNonZero && rows < tile_rows) {
      total = max(total, 0);  // the zero padding
    }
    if (!cluster) {
      if (tid == 0) stats[tile] = total;
      return;
    }
    // every block of the cluster has started and the word is set
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    if (tid == 0) {
      int* w = cl.map_shared_rank(&word, 0);
      if constexpr (kStat == kNonZero) {
        atomicAdd(w, total);
      } else {
        atomicMax(w, total);
      }
    }
    cl.sync();  // every partial is in; the first block stays till now
    if (part == 0 && tid == 0) stats[tile] = word;
  }
}

template <typename T, int kOp, int kStat>
cudaError_t launch(const void* a, const void* b, void* out, int32_t* stats,
                   int32_t identity, long long n_rows, long long width,
                   long long tile_rows, int n_tiles, int blocks_per_tile,
                   int chunk, int vec, int block, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks_per_tile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles) * blocks_per_tile);
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kStat != kNone && blocks_per_tile > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &cfg, codec_kernel<T, kOp, kStat>, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), stats, identity,
      n_rows, width, tile_rows, blocks_per_tile, chunk, vec);
}

#define REPRO_CODEC_CASE(T, OP, STAT)                                      \
  case OP * 4 + STAT:                                                      \
    err = launch<T, OP, STAT>(a, b, out, stats, identity, n_rows, width, \
                              tile_rows, n_tiles, blocks_per_tile, chunk, \
                              vec, block, stream);                        \
    return true;

#define REPRO_CODEC_NARROW(T)                                              \
  switch (op * 4 + stat) {                                                 \
    REPRO_CODEC_CASE(T, kSub, kNone) REPRO_CODEC_CASE(T, kSub, kMaxAbs)   \
    REPRO_CODEC_CASE(T, kSub, kMaxAbsUnsigned)                            \
    REPRO_CODEC_CASE(T, kSub, kNonZero) REPRO_CODEC_CASE(T, kAdd, kNone)  \
    REPRO_CODEC_CASE(T, kXor, kNone) REPRO_CODEC_CASE(T, kXor, kNonZero)  \
    default: return false;                                                 \
  }

bool dispatch(const void* a, const void* b, void* out, int32_t* stats,
              int32_t identity, long long n_rows,
              long long width, int itemsize,
              int op, int stat, long long tile_rows, int n_tiles,
              int blocks_per_tile, int chunk, int vec, int block,
              cudaStream_t stream, cudaError_t& err) {
  switch (itemsize) {
    case 1: REPRO_CODEC_NARROW(int8_t)
    case 2: REPRO_CODEC_NARROW(int16_t)
    case 4: REPRO_CODEC_NARROW(int32_t)
    case 8:
      switch (op * 4 + stat) {
        REPRO_CODEC_CASE(int64_t, kSub, kNone)
        REPRO_CODEC_CASE(int64_t, kAdd, kNone)
        REPRO_CODEC_CASE(int64_t, kXor, kNone)
        default: return false;
      }
    default: return false;
  }
}

}  // namespace

// a, b, out: (n_rows, width) lanes of `itemsize` bytes; stats: (n_tiles,)
// int32 with n_tiles = ceil(n_rows / tile_rows), every word written
// (0 where there is no stat). `plan` (kernels/delta_codec.py:
// _launch_args): n_rows, width, itemsize, op (0 sub, 1 add, 2 xor), stat
// (0 none, 1 max|d|, 2 max|d| zero-extended, 3 nonzero count; the 8-byte
// ops take stat 0 only), tile_rows, blocks_per_tile (with a stat at most
// 8, the portable cluster size), chunk (lanes per block, a multiple of
// 16 / itemsize; the blocks of a tile cover its tile_rows * width lanes),
// the stat's identity (INT32_MIN for the max, else 0) and the threads per
// block.
// Returns cudaErrorInvalidValue for any other combination.
extern "C" int delta_codec_launch(const void* a, const void* b, void* out,
                                  int32_t* stats, const long long* plan,
                                  void* stream) {
  const long long n_rows = plan[0], width = plan[1], tile_rows = plan[5];
  const int itemsize = static_cast<int>(plan[2]),
            op = static_cast<int>(plan[3]), stat = static_cast<int>(plan[4]),
            blocks_per_tile = static_cast<int>(plan[6]),
            chunk = static_cast<int>(plan[7]),
            block = static_cast<int>(plan[9]);
  if (n_rows <= 0 || width <= 0 || tile_rows <= 0)
    return static_cast<int>(cudaGetLastError());
  const long long lanes = tile_rows * width;
  const long long n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const long long want =
      stat == kMaxAbs || stat == kMaxAbsUnsigned ? INT32_MIN : 0;
  if (itemsize <= 0 || itemsize > 16 || blocks_per_tile <= 0 ||
      (stat != kNone && blocks_per_tile > 8) || block < 32 ||
      block > 1024 || block % 32 != 0 || chunk <= 0 ||
      chunk % (16 / itemsize) != 0 ||
      static_cast<long long>(blocks_per_tile) * chunk < lanes ||
      static_cast<long long>(blocks_per_tile - 1) * chunk >= lanes ||
      n_tiles * blocks_per_tile > 0x7fffffffll || stats == nullptr ||
      plan[8] != want) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const int vec = ((reinterpret_cast<uintptr_t>(a) ^ o) & 15) == 0 &&
                  ((reinterpret_cast<uintptr_t>(b) ^ o) & 15) == 0;
  cudaError_t err = cudaSuccess;
  if (!dispatch(a, b, out, stats, static_cast<int32_t>(want), n_rows, width,
                itemsize, op, stat, tile_rows, static_cast<int>(n_tiles),
                blocks_per_tile, chunk, vec, block,
                static_cast<cudaStream_t>(stream), err))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
