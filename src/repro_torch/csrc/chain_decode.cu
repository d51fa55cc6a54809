// Chain decode at index: out (n, W) = the chain-decoded cells idx[0..n) of a
// delta-packed field, without decoding the rest. The gather of every
// delta-packed superlog field (core/store.py: _SuperLogField.take_cells)
// runs it; it equals the full decode followed by the take, bit for bit:
//   add path  truncate(chain_decode(deltas, heads)[idx], out_size)
//   XOR path  chain_decode(deltas, heads, xor=True)[idx]
// where chain_decode is the segmented inclusive scan that restarts at every
// cell whose head flag is set (and starts at cell 0 when no head comes
// first), in int32 wraparound addition of the sign-extended deltas, or XOR.
//
// Replaces src/repro/kernels/delta_codec.py:261 chain_decode, which is not a
// Pallas kernel: the JAX package decodes the whole field with
// jax.lax.associative_scan and then takes the gathered cells
// (src/repro/core/store.py:405-407), and the port's plain version does the
// same with torch ops (a (W, C) int64 cumsum and its temporaries).
//
// Bound on this card: bytes. A gathered cell needs its chain prefix (the
// cells from its chain's head up to itself: W packed deltas and one head
// byte each), its index and its W output lanes; chains in a store are at
// most one cell per release, so the output write dominates.
//
// Design: a group of G threads per gathered cell (G a power of two, at most
// a warp, covering the row's chunks), lanes across W. Each thread first
// walks the head flags back from idx[i] to the chain's start (one byte per
// step, the same address across the group), then sums the chain's deltas
// forward for its chunks: loads whose addresses are known up front, so they
// overlap. Where the row is 4-byte aligned a chunk is one 32-bit load of
// 4 / packed-size lanes (4 int8 lanes of the 64-lane sequence field) and
// one vector store of as many output lanes; otherwise one lane. Sums run in
// uint32 (signed overflow is undefined in C++) on the sign-extended lanes,
// so the low out_size bytes are the int32 scan's; XOR of sign-extended
// lanes is the sign extension of their XOR, so the XOR path is the same
// loop. Chains may be any length: the walk has no cap. An index outside
// [0, C) is clamped into it, as the store clips before it gathers.
#include <cstring>

#include "common.cuh"

namespace {

template <int B> struct Vec;
template <> struct Vec<1> { using type = uint8_t; };
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

template <int B> struct Unsigned;
template <> struct Unsigned<1> { using type = uint8_t; };
template <> struct Unsigned<2> { using type = uint16_t; };
template <> struct Unsigned<4> { using type = uint32_t; };

// In: the signed packed lane type; kOut: output bytes per lane; kE: lanes
// per chunk (1, or 4 / sizeof(In) on an aligned row).
template <typename In, int kOut, int kE, bool kXor>
__global__ void decode_at_kernel(const In* __restrict__ deltas,
                                 const uint8_t* __restrict__ heads,
                                 const void* __restrict__ idx, int idx_size,
                                 long long n, long long c, long long w,
                                 int group_log2, void* __restrict__ out) {
  using InVec = typename Vec<sizeof(In) * kE>::type;
  using OutLane = typename Unsigned<kOut>::type;
  using OutVec = typename Vec<kOut * kE>::type;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long cell = t >> group_log2;
  if (cell >= n) return;
  const int sub = static_cast<int>(t & ((1 << group_log2) - 1));
  long long i = idx_size == 8
                    ? __ldg(static_cast<const long long*>(idx) + cell)
                    : __ldg(static_cast<const int32_t*>(idx) + cell);
  i = i < 0 ? 0 : (i >= c ? c - 1 : i);
  long long start = i;
  while (start > 0 && !__ldg(heads + start)) --start;
  const long long chunks = w / kE;
  const InVec* src = reinterpret_cast<const InVec*>(deltas);
  OutVec* dst = static_cast<OutVec*>(out) + cell * chunks;
  for (long long j = sub; j < chunks; j += (1 << group_log2)) {
    uint32_t acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0;
    for (long long k = start; k <= i; ++k) {
      const InVec raw = __ldg(src + k * chunks + j);
      In v[kE];
      memcpy(v, &raw, sizeof raw);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const uint32_t u = static_cast<uint32_t>(static_cast<int32_t>(v[e]));
        acc[e] = kXor ? (acc[e] ^ u) : (acc[e] + u);
      }
    }
    OutLane o[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) o[e] = static_cast<OutLane>(acc[e]);
    OutVec packed;
    memcpy(&packed, o, sizeof packed);
    dst[j] = packed;
  }
}

template <typename In, int kOut, int kE, bool kXor>
void launch(const void* deltas, const uint8_t* heads, const void* idx,
            int idx_size, long long n, long long c, long long w,
            int group_log2, void* out, int block, cudaStream_t stream) {
  const long long threads = n << group_log2;
  const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
  decode_at_kernel<In, kOut, kE, kXor><<<grid, block, 0, stream>>>(
      static_cast<const In*>(deltas), heads, idx, idx_size, n, c, w,
      group_log2, out);
}

// every (packed size, out size, vector, xor) the wrapper may ask for; the
// XOR path writes the lanes' own width
#define REPRO_DECODE_VEC(In, OUT, XOR)                                      \
  if (vec)                                                                 \
    launch<In, OUT, 4 / sizeof(In), XOR>(deltas, heads, idx, idx_size, n,  \
                                         c, w, group_log2, out, block,     \
                                         stream);                          \
  else                                                                     \
    launch<In, OUT, 1, XOR>(deltas, heads, idx, idx_size, n, c, w,         \
                            group_log2, out, block, stream);               \
  return true;

#define REPRO_DECODE_IN(In)                                                \
  if (xor_) {                                                              \
    if (out_size != sizeof(In)) return false;                              \
    REPRO_DECODE_VEC(In, sizeof(In), true)                                 \
  }                                                                        \
  switch (out_size) {                                                      \
    case 1: { REPRO_DECODE_VEC(In, 1, false) }                             \
    case 2: { REPRO_DECODE_VEC(In, 2, false) }                             \
    case 4: { REPRO_DECODE_VEC(In, 4, false) }                             \
    default: return false;                                                 \
  }

bool dispatch(const void* deltas, const uint8_t* heads, const void* idx,
              int idx_size, long long n, long long c, long long w,
              int in_size, int out_size, int xor_, int vec, int group_log2,
              void* out, int block, cudaStream_t stream) {
  switch (in_size) {
    case 1: { REPRO_DECODE_IN(int8_t) }
    case 2: { REPRO_DECODE_IN(int16_t) }
    case 4: { REPRO_DECODE_IN(int32_t) }
    default: return false;
  }
}

}  // namespace

// deltas: (c, w) signed lanes of in_size bytes, row-major; heads: (c,) one
// byte per cell (0 or 1); idx: (n,) int32 or int64 (idx_size 4 or 8) cell
// indices; out: (n, w) lanes of out_size bytes. xor_: the XOR path (out_size
// must equal in_size). vec: chunks of 4 / in_size lanes (w a multiple of it
// and deltas 4-byte aligned). A group of 2^group_log2 threads decodes one
// cell. Returns cudaErrorInvalidValue for any other combination.
extern "C" int chain_decode_at_launch(const void* deltas, const uint8_t* heads,
                                      const void* idx, int idx_size,
                                      long long n, long long c, long long w,
                                      int in_size, int out_size, int xor_,
                                      int vec, int group_log2, void* out,
                                      int block, void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if (c <= 0 || (in_size != 1 && in_size != 2 && in_size != 4) ||
      (idx_size != 4 && idx_size != 8) || group_log2 < 0 ||
      group_log2 > 5 || block % 32 != 0 ||
      (vec && w % (4 / in_size) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!dispatch(deltas, heads, idx, idx_size, n, c, w, in_size, out_size,
                xor_, vec, group_log2, out, block,
                static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
