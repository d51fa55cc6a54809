// Batched masked cumsum: ts (C,) int32 x Q query timestamps ->
// out (Q, C) int32, out[q][c] = #{c' <= c : ts[c'] <= t_q}. The scan behind
// get_versions / get_increments (the fused superlog's boundary counts) and,
// at Q = 1, behind the cold single-version path. The stacked form runs S
// such scans, one per row of a (S, C) stack of shards' fused ts arrays, in
// the same launch pair: ts (S, C) x Q -> out (S, Q, C), the scan behind a
// sharded store's parallel placement (core/placement.py).
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
// Design: reduce, then scan. The TPU kernels ran their grid in order and
// left the tile offsets to a second XLA pass over the whole output; here
// blocks run in any order, so
//   1. masked_cumsum_counts: one block per tile of `tile` cells loads the
//      tile once into registers and, for each query, block-reduces the
//      number of cells with ts <= t_q -> counts (S, Q, n_tiles);
//   2. the caller turns counts into exclusive tile offsets with
//      torch.cumsum (a (S, Q, n_tiles) array, tiny next to the output);
//   3. masked_cumsum_scan: one block per tile loads the tile again and,
//      for each query, forms the 0/1 mask, scans it inside the block
//      (per-thread runs of ITEMS cells, warp shuffles, one shared int per
//      warp), adds the tile's offset and writes the final values.
// The output is written once and never read back, at the price of reading
// ts twice (C*4 bytes per row, small next to Q*C*4 when Q > 1). The ragged
// last tile is masked in the kernel; nothing is padded. Each thread owns
// ITEMS consecutive cells, so loads and stores are 16 bytes apart across a
// warp; L1 and L2 merge them into whole sectors. A single-pass scan with
// decoupled look-back, and sampling only the CSR boundaries instead of
// writing the whole output, are later optimizations.
//
// The shard axis is the grid's y axis: block (x, y) scans tile x of row y,
// and every pointer moves by that row's stride (C cells of ts, Q*C of out,
// Q*n_tiles of counts and offsets); the unstacked scan is one row. The
// TPU kernel walked (shard, tile, query) in order; here the tiles of every
// shard run at once, so S shards of C cells fill the card like one log of
// S*C cells. Padding cells of a stack hold int32 max, above every clamped
// query, and never count.
#include "common.cuh"

namespace {

constexpr int kItems = 4;

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(repro::kFullMask, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

struct Tile {
  int32_t v[kItems];
  bool ok[kItems];
};

__device__ __forceinline__ Tile load_tile(const int32_t* __restrict__ ts,
                                          long long c, long long first) {
  Tile t;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    t.ok[k] = first + k < c;
    t.v[k] = t.ok[k] ? __ldg(ts + first + k) : 0;
  }
  return t;
}

__global__ void counts_kernel(const int32_t* __restrict__ ts, long long c,
                              const int32_t* __restrict__ tq, int q,
                              int32_t* __restrict__ counts, int n_tiles) {
  __shared__ int scratch[2][32];
  const long long row = blockIdx.y;  // shard row of a stack (0 unstacked)
  ts += row * c;
  counts += row * q * n_tiles;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kItems;
  const Tile t = load_tile(ts, c, first);
  for (int qi = 0; qi < q; ++qi) {
    const int32_t bound = __ldg(tq + qi);
    int s = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) s += (t.ok[k] && t.v[k] <= bound);
    // double-buffered scratch: a warp can only overwrite buffer qi & 1 at
    // query qi + 2, after every thread passed block_sum's barrier at qi + 1
    const int total = repro::block_sum(s, scratch[qi & 1]);
    if (threadIdx.x == 0)
      counts[static_cast<long long>(qi) * n_tiles + blockIdx.x] = total;
  }
}

__global__ void scan_kernel(const int32_t* __restrict__ ts, long long c,
                            const int32_t* __restrict__ tq, int q,
                            const int32_t* __restrict__ offsets, int n_tiles,
                            int32_t* __restrict__ out) {
  __shared__ int warp_totals[2][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.y;  // shard row of a stack (0 unstacked)
  ts += row * c;
  offsets += row * q * n_tiles;
  out += row * q * c;
  const long long first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kItems;
  const Tile t = load_tile(ts, c, first);
  for (int qi = 0; qi < q; ++qi) {
    const int32_t bound = __ldg(tq + qi);
    int run[kItems];
    int s = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      s += (t.ok[k] && t.v[k] <= bound);
      run[k] = s;
    }
    const int incl = warp_inclusive_scan(s, lane);
    int* totals = warp_totals[qi & 1];  // double-buffered as in counts_kernel
    if (lane == 31) totals[warp] = incl;
    __syncthreads();
    int before = __ldg(offsets + static_cast<long long>(qi) * n_tiles +
                       blockIdx.x);
    for (int w = 0; w < warp; ++w) before += totals[w];
    before += incl - s;
    int32_t* dst = out + static_cast<long long>(qi) * c;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (t.ok[k]) dst[first + k] = before + run[k];
  }
}

}  // namespace

// ts: (s, c) int32 (s rows of c cells); tq: (q,) int32; counts:
// (s, q, n_tiles) int32 with n_tiles = ceil(c / (block * 4)); s <= 65535.
extern "C" int masked_cumsum_counts(const int32_t* ts, int s, long long c,
                                    const int32_t* tq, int q, int32_t* counts,
                                    int n_tiles, int block, void* stream) {
  if (s > 0 && c > 0 && q > 0)
    counts_kernel<<<dim3(n_tiles, s), block, 0,
                    static_cast<cudaStream_t>(stream)>>>(ts, c, tq, q, counts,
                                                         n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// offsets: (s, q, n_tiles) int32 exclusive per-tile offsets; out: (s, q, c)
// int32.
extern "C" int masked_cumsum_scan(const int32_t* ts, int s, long long c,
                                  const int32_t* tq, int q,
                                  const int32_t* offsets, int n_tiles,
                                  int32_t* out, int block, void* stream) {
  if (s > 0 && c > 0 && q > 0)
    scan_kernel<<<dim3(n_tiles, s), block, 0,
                  static_cast<cudaStream_t>(stream)>>>(ts, c, tq, q, offsets,
                                                       n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}
