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
// a warp, covering the row's chunks; decode_at_plan picks), each thread
// kVec packed bytes of the row: 16 where rows are whole 16-byte vectors
// (16 int8, 8 int16 or 4 int32 lanes: the 64-lane int8 sequence field is
// 4 threads a cell, 8 cells a warp), else 4 bytes or one lane. The kernel
// is bound by the latency of a cell's dependent loads (index, then head
// flags and deltas), so a group decodes kCells cells at once, each step's
// loads in flight together, and a warp's cells are consecutive.
// - The taken cell's own row is the last cell of its chain: its chunk is
//   loaded as soon as the index is, beside the head search, so a chain of
//   one cell (most of a store's) costs two dependent loads, not three.
// - The chain's start: the group's first thread loads the aligned 8-byte
//   word of head flags that holds idx[i], masks the flags above i (and any
//   before the field's first cell), and takes the last set flag with
//   __clzll on a byte mask; only a word with no head steps back a word.
//   A store's chains are at most 8 cells, so that is one or two loads,
//   not one dependent byte load per cell; a chain of any length still
//   decodes, and cells before the first head chain from cell 0. A shuffle
//   hands the start to the group.
// - The sums: the rest of the chain is loaded kWin cells at a time, all
//   loads before their sums. Sums run in uint32 (signed overflow is
//   undefined in C++) on the sign-extended lanes, so the low out_size bytes
//   are the int32 scan's; XOR of sign-extended lanes is the sign extension
//   of their XOR, so the XOR path is the same loop.
// - The output: a thread's lanes leave as 16-byte (or narrower) streaming
//   stores (st.global.cs). Where a chunk's output is wider than its input
//   (int8 into int32: 64 output bytes a thread), the thread owns every G-th
//   16-byte piece of its cell's output row and loads the packed bytes of
//   those pieces (four 4-byte loads a chain cell), so that each store
//   instruction of a group writes whole 32-byte sectors: four consecutive
//   pieces a thread would leave each instruction half of every sector it
//   touches, which the card writes markedly slower (PERF.md). The
//   indices are streaming loads too: neither they nor the output are read
//   again, so the packed field and the head flags stay in L2 across a
//   large gather.
// An index outside [0, C) is clamped into it, as the store clips before it
// gathers.
#include <cstring>

#include "common.cuh"

namespace {

template <int B> struct Vec;
template <> struct Vec<1> { using type = unsigned char; };
template <> struct Vec<2> { using type = unsigned short; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

constexpr int kWin = 2;    // chain cells whose loads are in flight together
constexpr int kCells = 2;  // cells a group of threads decodes at once

// The first cell of the chain that holds cell i: the last cell at or before
// i whose head flag is set, or 0 when none is.
__device__ __forceinline__ long long chain_start(const uint8_t* heads,
                                                 long long i) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(heads);
  const uintptr_t at = first + i;
  uintptr_t word = at & ~static_cast<uintptr_t>(7);
  unsigned long long keep = ~0ull >> (8 * (7 - (at & 7)));  // bytes <= i
  while (true) {
    if (word < first) keep &= ~0ull << (8 * (first - word));  // before cell 0
    const unsigned long long x =
        __ldg(reinterpret_cast<const unsigned long long*>(word)) & keep;
    // bit 7 of each byte that is not zero
    const unsigned long long set =
        (((x & 0x7f7f7f7f7f7f7f7full) + 0x7f7f7f7f7f7f7f7full) | x) &
        0x8080808080808080ull;
    if (set) {
      const int byte = (63 - __clzll(static_cast<long long>(set))) >> 3;
      return static_cast<long long>(word + byte - first);
    }
    if (word <= first) return 0;
    word -= 8;
    keep = ~0ull;
  }
}

template <typename In, int kE, bool kXor>
__device__ __forceinline__ void accumulate(
    uint32_t (&acc)[kE], const typename Vec<sizeof(In) * kE>::type& raw) {
  In v[kE];
  memcpy(v, &raw, sizeof raw);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const uint32_t u = static_cast<uint32_t>(static_cast<int32_t>(v[e]));
    acc[e] = kXor ? (acc[e] ^ u) : (acc[e] + u);
  }
}

// In: the signed packed lane type; kOut: output bytes per lane; kVec:
// packed bytes per chunk (16, 4 or sizeof(In)). A chunk's output is
// kPieces pieces of at most 16 bytes; a row of `chunks` chunks is
// chunks * kPieces pieces, and the thread at chunk slot j of its group
// owns pieces s * chunks + j (s < kPieces), so that each store
// instruction of a group covers whole 32-byte sectors. It loads the
// packed bytes of those pieces, kVec / kPieces at a time.
template <typename In, int kOut, int kVec, bool kXor>
__global__ void decode_at_kernel(const In* __restrict__ deltas,
                                 const uint8_t* __restrict__ heads,
                                 const void* __restrict__ idx, int idx_size,
                                 long long n, long long c, long long w,
                                 int group_log2, void* __restrict__ out) {
  constexpr int kE = kVec / sizeof(In);  // lanes per chunk
  constexpr int kOutBytes = kE * kOut;   // output bytes per chunk
  constexpr int kSt = kOutBytes < 16 ? kOutBytes : 16;
  constexpr int kPieces = kOutBytes / kSt;
  constexpr int kSubE = kE / kPieces;    // lanes per piece
  using SubVec = typename Vec<kVec / kPieces>::type;
  using OutLane = typename Vec<kOut>::type;
  using StVec = typename Vec<kSt>::type;
  const int lane = threadIdx.x & 31;
  const int group_of_lane = lane >> group_log2;
  const int groups = 32 >> group_log2;  // per warp
  const int sub = lane & ((1 << group_log2) - 1);
  // a warp takes groups * kCells consecutive cells, kCells rounds of one
  // cell a group, so a round's stores cover consecutive output rows
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * groups * kCells;
  if (first >= n) return;  // the whole warp, before any shuffle
  long long cell[kCells], i[kCells], start[kCells];
  bool live[kCells];
#pragma unroll
  for (int m = 0; m < kCells; ++m) {
    cell[m] = first + m * groups + group_of_lane;
    live[m] = cell[m] < n;
    i[m] = 0;
    if (live[m]) {
      const long long v =
          idx_size == 8 ? __ldcs(static_cast<const long long*>(idx) + cell[m])
                        : __ldcs(static_cast<const int*>(idx) + cell[m]);
      i[m] = v < 0 ? 0 : (v >= c ? c - 1 : v);
    }
  }
  const long long chunks = w / kE;
  const long long pieces = chunks * kPieces;  // per row
  const SubVec* src = reinterpret_cast<const SubVec*>(deltas);
  // the taken cell's own row is on its chain: its loads go out before the
  // head search, not after it
  SubVec own[kCells][kPieces];
  long long j = sub;
#pragma unroll
  for (int m = 0; m < kCells; ++m)
#pragma unroll
    for (int s = 0; s < kPieces; ++s)
      if (live[m] && j < chunks)
        own[m][s] = __ldg(src + i[m] * pieces + s * chunks + j);
#pragma unroll
  for (int m = 0; m < kCells; ++m)
    start[m] = (live[m] && sub == 0) ? chain_start(heads, i[m]) : 0;
#pragma unroll
  for (int m = 0; m < kCells; ++m)
    start[m] = __shfl_sync(repro::kFullMask, start[m], 0, 1 << group_log2);
  for (; j < chunks; j += 1 << group_log2) {
#pragma unroll
    for (int m = 0; m < kCells; ++m) {
      if (!live[m]) continue;
      uint32_t acc[kPieces][kSubE];
#pragma unroll
      for (int s = 0; s < kPieces; ++s) {
        if (j != sub) own[m][s] = __ldg(src + i[m] * pieces + s * chunks + j);
#pragma unroll
        for (int e = 0; e < kSubE; ++e) acc[s][e] = 0;
        accumulate<In, kSubE, kXor>(acc[s], own[m][s]);
      }
      // the rest of the chain, start .. i - 1, kWin cells at a time
      for (long long k = start[m]; k < i[m]; k += kWin) {
        const int rest = static_cast<int>(i[m] - k);
        SubVec raw[kWin][kPieces];
#pragma unroll
        for (int q = 0; q < kWin; ++q)
#pragma unroll
          for (int s = 0; s < kPieces; ++s)
            if (q < rest)
              raw[q][s] = __ldg(src + (k + q) * pieces + s * chunks + j);
#pragma unroll
        for (int q = 0; q < kWin; ++q)
#pragma unroll
          for (int s = 0; s < kPieces; ++s)
            if (q < rest) accumulate<In, kSubE, kXor>(acc[s], raw[q][s]);
      }
      StVec* row = reinterpret_cast<StVec*>(static_cast<char*>(out) +
                                            cell[m] * w * kOut);
#pragma unroll
      for (int s = 0; s < kPieces; ++s) {
        OutLane o[kSubE];
#pragma unroll
        for (int e = 0; e < kSubE; ++e) o[e] = static_cast<OutLane>(acc[s][e]);
        StVec v;
        memcpy(&v, o, sizeof v);
        __stcs(row + s * chunks + j, v);
      }
    }
  }
}

template <typename In, int kOut, int kVec, bool kXor>
void launch(const void* deltas, const uint8_t* heads, const void* idx,
            int idx_size, long long n, long long c, long long w,
            int group_log2, void* out, int block, cudaStream_t stream) {
  const long long per_warp = (32 >> group_log2) * kCells;
  const long long threads = (n + per_warp - 1) / per_warp * 32;
  const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
  decode_at_kernel<In, kOut, kVec, kXor><<<grid, block, 0, stream>>>(
      static_cast<const In*>(deltas), heads, idx, idx_size, n, c, w,
      group_log2, out);
}

// every (packed size, out size, chunk, xor) the wrapper may ask for; the
// XOR path writes the lanes' own width
template <typename In, int kOut, bool kXor>
bool by_vec(int vec, const void* deltas, const uint8_t* heads,
            const void* idx, int idx_size, long long n, long long c,
            long long w, int group_log2, void* out, int block,
            cudaStream_t stream) {
  if (vec == 16) {
    launch<In, kOut, 16, kXor>(deltas, heads, idx, idx_size, n, c, w,
                               group_log2, out, block, stream);
  } else if (vec == 4) {
    launch<In, kOut, 4, kXor>(deltas, heads, idx, idx_size, n, c, w,
                              group_log2, out, block, stream);
  } else if (vec == static_cast<int>(sizeof(In))) {
    launch<In, kOut, sizeof(In), kXor>(deltas, heads, idx, idx_size, n, c,
                                       w, group_log2, out, block, stream);
  } else {
    return false;
  }
  return true;
}

#define REPRO_DECODE_ARGS \
  vec, deltas, heads, idx, idx_size, n, c, w, group_log2, out, block, stream

template <typename In>
bool by_out(int out_size, int xor_, int vec, const void* deltas,
            const uint8_t* heads, const void* idx, int idx_size, long long n,
            long long c, long long w, int group_log2, void* out, int block,
            cudaStream_t stream) {
  if (xor_) {
    return out_size == static_cast<int>(sizeof(In)) &&
           by_vec<In, sizeof(In), true>(REPRO_DECODE_ARGS);
  }
  switch (out_size) {
    case 1: return by_vec<In, 1, false>(REPRO_DECODE_ARGS);
    case 2: return by_vec<In, 2, false>(REPRO_DECODE_ARGS);
    case 4: return by_vec<In, 4, false>(REPRO_DECODE_ARGS);
    default: return false;
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// deltas: (c, w) signed lanes of in_size bytes, row-major; heads: (c,) one
// byte per cell (0 or 1), at any address; idx: (n,) int32 or int64
// (idx_size 4 or 8) cell indices; out: (n, w) lanes of out_size bytes,
// 16-byte aligned. xor_: the XOR path (out_size must equal in_size). vec:
// packed bytes per chunk, 16 or 4 (w a multiple of its lanes and deltas
// aligned to it) or in_size (one lane). A group of 2^group_log2 threads
// decodes one cell. Returns cudaErrorInvalidValue for any other
// combination.
extern "C" int chain_decode_at_launch(const void* deltas, const uint8_t* heads,
                                      const void* idx, int idx_size,
                                      long long n, long long c, long long w,
                                      int in_size, int out_size, int xor_,
                                      int vec, int group_log2, void* out,
                                      int block, void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if (c <= 0 || (in_size != 1 && in_size != 2 && in_size != 4) ||
      (idx_size != 4 && idx_size != 8) || group_log2 < 0 ||
      group_log2 > 5 || block <= 0 || block > 1024 || block % 32 != 0 ||
      (vec != 16 && vec != 4 && vec != in_size) || vec < in_size ||
      w % (vec / in_size) != 0 || !aligned(deltas, vec) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (in_size) {
    case 1:
      ok = by_out<int8_t>(out_size, xor_, vec, deltas, heads, idx, idx_size,
                          n, c, w, group_log2, out, block, s);
      break;
    case 2:
      ok = by_out<int16_t>(out_size, xor_, vec, deltas, heads, idx, idx_size,
                           n, c, w, group_log2, out, block, s);
      break;
    case 4:
      ok = by_out<int32_t>(out_size, xor_, vec, deltas, heads, idx, idx_size,
                           n, c, w, group_log2, out, block, s);
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
