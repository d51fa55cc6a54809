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
// 4 bytes per tile, with one integer op per lane. Design: one block per
// tile; thread i handles lanes i, i + blockDim, ... of the tile's flat
// rows*W range, so each warp's loads and stores cover contiguous bytes; the
// stat is a warp reduction plus one shared int per warp.
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
__global__ void codec_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ out, int32_t* __restrict__ stats,
                             long long n_rows, long long width,
                             long long tile_rows) {
  using U = typename Unsigned<T>::type;
  __shared__ int scratch[32];
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const long long rows = min(tile_rows, n_rows - row0);
  const long long begin = row0 * width;
  const long long end = begin + rows * width;
  int acc = kStat == kNonZero ? 0 : INT32_MIN;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const U x = static_cast<U>(a[i]);
    const U y = static_cast<U>(b[i]);
    U r;
    if constexpr (kOp == kSub) {
      r = static_cast<U>(x - y);
    } else if constexpr (kOp == kAdd) {
      r = static_cast<U>(x + y);
    } else {
      r = static_cast<U>(x ^ y);
    }
    out[i] = static_cast<T>(r);
    if constexpr (kStat == kNonZero) {
      acc += r != 0;
    } else if constexpr (kStat == kMaxAbs || kStat == kMaxAbsUnsigned) {
      const int32_t w = kStat == kMaxAbsUnsigned
                            ? static_cast<int32_t>(r)
                            : static_cast<int32_t>(static_cast<T>(r));
      const uint32_t u = static_cast<uint32_t>(w);
      acc = max(acc, static_cast<int32_t>(w < 0 ? 0u - u : u));
    }
  }
  if constexpr (kStat == kNone) {
    if (threadIdx.x == 0) stats[blockIdx.x] = 0;
  } else if constexpr (kStat == kNonZero) {
    const int total = repro::block_sum(acc, scratch);
    if (threadIdx.x == 0) stats[blockIdx.x] = total;
  } else {
    int total = repro::block_max(acc, scratch);
    if (rows < tile_rows) total = max(total, 0);  // the zero padding
    if (threadIdx.x == 0) stats[blockIdx.x] = total;
  }
}

template <typename T, int kOp, int kStat>
void launch(const void* a, const void* b, void* out, int32_t* stats,
            long long n_rows, long long width, long long tile_rows,
            unsigned n_tiles, int block, cudaStream_t stream) {
  codec_kernel<T, kOp, kStat><<<n_tiles, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), stats, n_rows, width, tile_rows);
}

#define REPRO_CODEC_CASE(T, OP, STAT)                                      \
  case OP * 4 + STAT:                                                      \
    launch<T, OP, STAT>(a, b, out, stats, n_rows, width, tile_rows,       \
                        n_tiles, block, stream);                          \
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
              long long n_rows, long long width, int itemsize, int op,
              int stat, long long tile_rows, unsigned n_tiles, int block,
              cudaStream_t stream) {
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
// int32 with n_tiles = ceil(n_rows / tile_rows). op: 0 sub, 1 add, 2 xor;
// stat: 0 none, 1 max|d|, 2 max|d| zero-extended, 3 nonzero count (the
// 8-byte ops take stat 0 only). Returns cudaErrorInvalidValue for any
// other combination.
extern "C" int delta_codec_launch(const void* a, const void* b, void* out,
                                  int32_t* stats, long long n_rows,
                                  long long width, int itemsize, int op,
                                  int stat, int tile_rows, int block,
                                  void* stream) {
  if (n_rows <= 0 || width <= 0 || tile_rows <= 0)
    return static_cast<int>(cudaGetLastError());
  const unsigned n_tiles =
      static_cast<unsigned>((n_rows + tile_rows - 1) / tile_rows);
  if (!dispatch(a, b, out, stats, n_rows, width, itemsize, op, stat,
                tile_rows, n_tiles, block,
                static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
