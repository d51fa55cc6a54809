// Masked cumsum: ts (C,) int32 x Q query timestamps -> out (Q, C) int32,
// out[q][c] = #{c' <= c : ts[c'] <= t_q}. The scan behind get_versions /
// get_increments (the fused superlog's boundary counts) and, at Q = 1,
// behind the cold single-version path. The stacked form runs S such scans,
// one per row of a (S, C) stack of shards' fused ts arrays, in the same
// launch: ts (S, C) x Q -> out (S, Q, C), the scan behind a sharded store's
// parallel placement (core/placement.py).
//
// Replaces three TPU kernels: src/repro/kernels/batched_select.py:50
// (_batched_masked_cumsum_kernel) and src/repro/kernels/version_select.py:30
// (_masked_cumsum_kernel), the single-query one being this one at Q = 1;
// and src/repro/kernels/batched_select.py:115
// (_stacked_masked_cumsum_kernel), which is this one with a shard axis.
//
// Bound on this card: bytes. It must read S*C*4 bytes and write S*Q*C*4
// bytes, with one compare and one add per (shard, query, cell).
//
// Design: one launch, a single pass with decoupled look-back (Merrill and
// Garland). The TPU kernels ran their grid in order and carried the running
// count from one step to the next; here blocks run in any order, so
//   - a block takes its tile from a ticket counter (atomicAdd), not from
//     blockIdx: every tile before its own belongs to a block that is
//     already running, so waiting on them cannot deadlock;
//   - for each query the block counts its tile, publishes that aggregate in
//     the tile's status word, then one warp looks back over the words of
//     the tiles before it (32 at a time) until it meets an inclusive
//     prefix, adds the aggregates on the way, and publishes the tile's
//     inclusive prefix; then every thread scans its cells and writes them;
//   - a status word is 64 bits, the status (0 none, 1 aggregate,
//     2 inclusive) above the int32 count, written by one 8-byte store, so a
//     reader never sees a status without its count. No other memory is read
//     through it, so the stores and loads are relaxed at gpu scope (a
//     release store fences every earlier write of the thread, which a
//     reader here never looks at, and it showed in the Q = 1 time);
//   - the workspace (the status words and the ticket) is zeroed by the
//     entry point on the caller's stream just before the launch, so a call
//     never reads an earlier call's words.
// A tile is 8192 cells: kSub sub-tiles of kBlock threads x 4 cells, so
// loads and stores are 16 bytes a thread, whole warps on consecutive
// bytes. Queries go in chunks of kChunk: the block counts every query of
// the chunk, publishes every aggregate, then looks back once per query,
// then writes, so it waits on its predecessors once per chunk rather than
// once per query. Rows of an odd C start off 16-byte boundaries; their
// stores are realigned by warp shuffles. The ragged last tile is masked,
// never padded. Padding cells of a stack hold int32 max, above every
// clamped query, and never count.
//
// Shape, from short runs on an H100 80GB HBM3 at 700 W. With 2048-cell
// tiles the look-back could not keep up with the tiles in flight, and a
// Q = 1 scan took longer than the two launches it replaced; a quarter as
// many tiles fixed that. Up to kFewQueries queries a block is 128 threads
// x 16 sub-tiles, above that 512 x 4: the small blocks were faster at
// Q = 1/2/8, the large ones at Q = 64. A look-back window of several words
// a lane, and persistent blocks that load their next tile during the
// look-back, were both slower and were not kept. The crossover with the
// two-pass kernel this replaces: none. At every shape the store runs,
// this one pass is within 10% of that kernel's times or faster (PERF.md's
// kernel table, chip_smoke.py), so it serves them all.
#include "common.cuh"

namespace {

constexpr int kTile = 8192;   // cells of a tile
constexpr int kParts = kTile / 128;  // (sub-tile, warp) runs of 128 cells
constexpr int kChunk = 64;    // queries whose run totals a block holds
// blocks of 128 threads (16 sub-tiles) for at most this many queries, of
// 512 (4 sub-tiles) above it
constexpr int kFewQueries = 8;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(repro::kFullMask, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The exclusive prefix of `tile` for one query, by decoupled look-back over
// the status words of the tiles before it (one warp; lane k reads tile
// pred - k). A window with an inclusive word ends the walk there; otherwise
// its 32 aggregates are summed and the window moves back. A word still 0
// (its tile has not published) is read again until it is set.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile, int lane) {
  int exclusive = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int k = pred - lane;
    unsigned long long word = k >= 0 ? load_status(status + k) : kInclusive;
    while (__any_sync(repro::kFullMask, (word >> 32) == 0))
      word = k >= 0 ? load_status(status + k) : kInclusive;
    const unsigned inclusive =
        __ballot_sync(repro::kFullMask, (word >> 32) == 2);
    int v = static_cast<int>(static_cast<uint32_t>(word));
    if (inclusive) {
      // the nearest inclusive word (the lowest such lane) and the
      // aggregates between it and this tile
      if (lane > __ffs(inclusive) - 1) v = 0;
      return exclusive + __reduce_add_sync(repro::kFullMask, v);
    }
    exclusive += __reduce_add_sync(repro::kFullMask, v);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Write a thread's run of 4 output cells at dst (n_ok of them inside the
// row) in 16-byte stores. At a row offset m != 0 a warp's runs straddle
// the 16-byte boundaries, so each lane stores the aligned vector that
// ends inside its run: the previous lane's last m cells (by shuffle) and
// its own first 4 - m; lane 0 stores its first 4 - m cells alone and
// lane 31 its last m. A warp that reaches the ragged end stores cells.
__device__ __forceinline__ void store_run(int32_t* dst, const int (&o)[4],
                                          int m, int n_ok, int lane) {
  const bool whole = __all_sync(repro::kFullMask, n_ok == 4);
  int p[4];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    p[k] = __shfl_up_sync(repro::kFullMask, o[k], 1);
  if (!whole) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n_ok) dst[k] = o[k];
    return;
  }
  if (m == 0) {
    *reinterpret_cast<int4*>(dst) = make_int4(o[0], o[1], o[2], o[3]);
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < 4 - m) dst[k] = o[k];
  } else {
    int a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // cell k of the aligned vector: the previous lane's cell 4 - m + k,
      // or this lane's cell k - m
      int prev = p[1];
      if (k + 4 - m == 2) prev = p[2];
      if (k + 4 - m == 3) prev = p[3];
      int own = o[0];
      if (k - m == 1) own = o[1];
      if (k - m == 2) own = o[2];
      a[k] = k < m ? prev : own;
    }
    *reinterpret_cast<int4*>(dst - m) = make_int4(a[0], a[1], a[2], a[3]);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k >= 4 - m) dst[k] = o[k];
  }
}

// One block per tile of kSub sub-tiles of kBlock x 4 cells of one row, the
// tile taken by ticket. Queries go in chunks of kChunk: (A) every warp sums
// its cells' masks per sub-tile for each query, (B) warp w, for queries w,
// w + kWarps, ...: scans the query's kParts run totals and publishes the
// tile aggregate, then looks back for the exclusive prefix and publishes
// the inclusive one, (C) every thread scans its cells and writes them. So
// a block waits on its predecessors once per chunk, not once per query.
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
    single_pass_kernel(const int32_t* __restrict__ ts, long long c,
                       const int32_t* __restrict__ tq, int q, int n_tiles,
                       unsigned long long* status, unsigned int* ticket,
                       int32_t* __restrict__ out) {
  constexpr int kSub = kTile / (kBlock * 4);  // sub-tiles of a tile
  constexpr int kWarps = kBlock / 32;
  static_assert(kSub * kWarps == kParts, "runs of 128 cells");
  __shared__ unsigned int s_ticket;
  __shared__ int run_base[kChunk][kParts];  // [query of the chunk][run]
  __shared__ int tile_base[kChunk];         // [query of the chunk]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long row = s_ticket / n_tiles;
  const int tile = static_cast<int>(s_ticket % n_tiles);
  ts += row * c;
  out += row * q * c;
  status += row * q * n_tiles;
  // sub-tile h of this thread: cells first[h] .. first[h] + 3, whole
  // 16-byte vectors where the row is aligned and the run is complete,
  // single cells at a ragged end
  long long first[kSub];
  int n_ok[kSub];
  int32_t v[kSub][4];
#pragma unroll
  for (int h = 0; h < kSub; ++h) {
    first[h] = ((static_cast<long long>(tile) * kSub + h) * kBlock +
                threadIdx.x) * 4;
    n_ok[h] = static_cast<int>(max(0LL, min(4LL, c - first[h])));
    if (n_ok[h] == 4 && aligned16(ts)) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(ts + first[h]));
      v[h][0] = x.x;
      v[h][1] = x.y;
      v[h][2] = x.z;
      v[h][3] = x.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[h][k] = k < n_ok[h] ? __ldg(ts + first[h] + k) : 0;
    }
  }
  for (int q0 = 0; q0 < q; q0 += kChunk) {
    const int nq = min(kChunk, q - q0);
    for (int j = 0; j < nq; ++j) {
      const int32_t bound = __ldg(tq + q0 + j);
#pragma unroll
      for (int h = 0; h < kSub; ++h) {
        int s = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) s += (k < n_ok[h] && v[h][k] <= bound);
        s = __reduce_add_sync(repro::kFullMask, s);
        if (lane == 0) run_base[j][h * kWarps + warp] = s;
      }
    }
    __syncthreads();
    // every aggregate first, so the tiles after this one can pass it
    for (int j = warp; j < nq; j += kWarps) {
      int total = 0;  // exclusive scan of the run totals, in place
      for (int r0 = 0; r0 < kParts; r0 += 32) {
        const int x = r0 + lane < kParts ? run_base[j][r0 + lane] : 0;
        const int incl = warp_inclusive_scan(x, lane);
        if (r0 + lane < kParts) run_base[j][r0 + lane] = total + incl - x;
        total += __shfl_sync(repro::kFullMask, incl, 31);
      }
      if (lane == 0) {
        tile_base[j] = total;  // the aggregate, until the look-back
        store_status(status + static_cast<long long>(q0 + j) * n_tiles +
                          tile,
                      (tile == 0 ? kInclusive : kAggregate) |
                          static_cast<uint32_t>(total));
      }
    }
    for (int j = warp; j < nq; j += kWarps) {
      int exclusive = 0;
      if (tile > 0) {
        unsigned long long* st = status + static_cast<long long>(q0 + j) *
                                              n_tiles;
        exclusive = look_back(st, tile, lane);
        if (lane == 0)
          store_status(st + tile,
                        kInclusive | static_cast<uint32_t>(exclusive +
                                                           tile_base[j]));
      }
      __syncwarp();
      if (lane == 0) tile_base[j] = exclusive;
    }
    __syncthreads();
    for (int j = 0; j < nq; ++j) {
      const int32_t bound = __ldg(tq + q0 + j);
      int32_t* dst_row = out + static_cast<long long>(q0 + j) * c;
      // the row's offset from a 16-byte boundary, in cells (rows of an odd
      // C start at every offset)
      const int m = static_cast<int>(
          (reinterpret_cast<uintptr_t>(dst_row) >> 2) & 3);
#pragma unroll
      for (int h = 0; h < kSub; ++h) {
        int o[4];
        int s = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s += (k < n_ok[h] && v[h][k] <= bound);
          o[k] = s;
        }
        const int before = tile_base[j] + run_base[j][h * kWarps + warp] +
                           warp_inclusive_scan(s, lane) - s;
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] += before;
        store_run(dst_row + first[h], o, m, n_ok[h], lane);
      }
    }
    __syncthreads();  // the next chunk reuses run_base and tile_base
  }
}

}  // namespace

// ts: (s, c) int32; tq: (q,) int32 on the card; out: (s, q, c) int32;
// workspace: s * q * n_tiles + 1 words of 8 bytes (status words, then the
// ticket), zeroed here on `stream` before the launch; n_tiles =
// ceil(c / 8192), the tile of this file (kTile).
extern "C" int masked_cumsum_launch(const int32_t* ts, int s, long long c,
                                    const int32_t* tq, int q, int n_tiles,
                                    void* workspace, int32_t* out,
                                    void* stream) {
  if (s <= 0 || c <= 0 || q <= 0) return static_cast<int>(cudaGetLastError());
  if (c > 0x7fffffffLL ||
      n_tiles != static_cast<int>((c + kTile - 1) / kTile) ||
      static_cast<long long>(s) * n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const long long words = static_cast<long long>(s) * q * n_tiles;
  auto* status = static_cast<unsigned long long*>(workspace);
  const cudaError_t rc =
      cudaMemsetAsync(status, 0, (words + 1) * sizeof(*status), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned grid = static_cast<unsigned>(s * n_tiles);
  auto* ticket = reinterpret_cast<unsigned int*>(status + words);
  if (q <= kFewQueries)
    single_pass_kernel<128><<<grid, 128, 0, st>>>(ts, c, tq, q, n_tiles,
                                                   status, ticket, out);
  else
    single_pass_kernel<512><<<grid, 512, 0, st>>>(ts, c, tq, q, n_tiles,
                                                   status, ticket, out);
  return static_cast<int>(cudaGetLastError());
}
