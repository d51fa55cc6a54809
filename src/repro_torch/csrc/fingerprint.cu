// Row fingerprint: (N, W) int32 lanes -> (N, 2) int32, the change-detection
// hash of VersionedStore.update / ReleaseSession.apply / head rebuilds.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint.py:29
// (_fingerprint_kernel). The bits must equal the reference exactly: they go
// into the release digest chain.
//
// Bound on this card: bytes. It reads N*W*4 bytes and writes N*8 bytes and
// does about 5 integer operations per lane read, far below the card's
// operations-per-byte balance.
//
// The fold is sequential in lane order within a row, so a row belongs to
// one thread; what the design arranges is that the loads are coalesced.
// The launch geometry comes from kernels/fingerprint.py (fingerprint_plan):
//
// * rows path (rows of at most 32 bytes, W <= 8): no staging. A warp takes
//   128 consecutive rows at a time and a thread folds rows lane, lane + 32,
//   lane + 64 and lane + 96 of them, so each of a warp's store
//   instructions, and its load of one lane of 32 rows, covers one
//   contiguous run of at most 1 KB: the first loads bring its sectors into
//   L1 and the later lanes are served there, and a thread has four rows'
//   loads in flight. (At W 8 a staged tile took longer than this.)
// * tile paths (wider rows): a block of R threads stages a tile of R rows
//   in shared memory and each thread then folds its own row from there. At
//   W = 64 one thread per row reading global memory directly touched 32
//   sectors per warp load for 128 useful bytes, and a block's 64 KB of rows
//   evicted the later lanes' sectors from L1 before they were used. The
//   copy is cp.async, shared by every thread of the block: 16-byte pieces
//   (cp.async.cg, each asking L2 to fetch the whole 128-byte line, which
//   measured a little faster than without the hint) when the base is
//   16-byte aligned and a row is whole 16-byte pieces ("tile16"), else
//   4-byte words of the same kernel ("tile4"). A staged row is padded to
//   an odd number of 16-byte pieces (tile16) or of words (tile4), so the
//   eight threads of a quarter-warp reading piece c of eight rows, or a
//   warp reading word c of 32 rows, hit distinct banks. (A 1-D bulk copy
//   cannot pad rows, and a swizzle needs at least eight pieces a row;
//   padding works at every width.) Rows wider than the plan's chunk (128
//   lanes) are staged a chunk of lanes at a time, the fold's state kept in
//   registers between chunks. The grid is
//   persistent (as many blocks as fit on the card at once, by the occupancy
//   API, cached per kernel, shared memory size and card), and each block
//   double-buffers its tiles: the copy of its next tile is in flight while
//   it folds the current one.
//
// The rows path is compiled for each W up to 8 (the main path's W 1 and 8
// among them), and tile16 for W 64, with their lane loops unrolled; every
// other width runs the tile kernels with W at run time. All arithmetic is
// on uint32_t (signed overflow is undefined in C++, unsigned wraps, and the
// bits are those of the reference's int32 wraparound); the final `>> 7` is
// taken on the value cast to int32_t, an arithmetic shift as in the
// reference.
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr uint32_t kFnv1Init = 0x811C9DC5u;  // -2128831035 as int32
constexpr uint32_t kFnv1Mul = 0x01000193u;   // 16777619
constexpr uint32_t kFnv2Init = 0xAA050E95u;  // -1442509163 as int32
constexpr uint32_t kFnv2Mul = 0x165667B1u;   // 374761393

constexpr int kRowsPerThread = 4;  // rows path: rows a thread folds at once
constexpr int kPathRows = 0, kPathTile16 = 1, kPathTile4 = 2;

struct Fold {
  uint32_t h1 = kFnv1Init;
  uint32_t h2 = kFnv2Init;

  // lane x at (0-based) position j1 - 1 of its row
  __device__ __forceinline__ void lane(uint32_t x, uint32_t j1) {
    h1 = (h1 ^ x) * kFnv1Mul;
    h2 = (h2 * kFnv2Mul) ^ (x + j1);
  }

  __device__ __forceinline__ int2 finish() const {
    const uint32_t a = h1 ^ (h2 << 13);
    const uint32_t b =
        h2 ^ static_cast<uint32_t>(static_cast<int32_t>(a) >> 7);
    return make_int2(static_cast<int32_t>(a), static_cast<int32_t>(b));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows of W <= 8 lanes, straight from global memory.
template <int W>
__global__ void __launch_bounds__(256)
    fingerprint_rows_kernel(const int32_t* __restrict__ lanes,
                            int2* __restrict__ out, long long n) {
  constexpr int kSpan = 32 * kRowsPerThread;  // rows a warp takes at a time
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r0 = warp * kSpan; r0 < n; r0 += warps * kSpan) {
    uint32_t x[kRowsPerThread][W > 0 ? W : 1];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long r = r0 + lane + 32 * k;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        x[k][j] = r < n ? static_cast<uint32_t>(__ldg(lanes + r * W + j))
                        : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long r = r0 + lane + 32 * k;
      if (r < n) {
        Fold f;
#pragma unroll
        for (int j = 0; j < W; ++j) f.lane(x[k][j], j + 1);
        out[r] = f.finish();
      }
    }
  }
}

struct TileArgs {
  long long n;  // rows
  int w;        // lanes per row
  int k;        // lanes per chunk: a staged tile holds k lanes of each row
  int stride;   // shared memory words per staged row (odd pieces or words)
};

// Rows staged through shared memory, one row per thread of the block
// (blockDim.x rows a tile). VEC: 16 (16-byte pieces) or 4 (words). W > 0
// fixes the width (then one chunk, k == W) and unrolls the fold.
template <int W, int VEC>
__global__ void __launch_bounds__(256)
    fingerprint_tile_kernel(const int32_t* __restrict__ lanes,
                            int2* __restrict__ out, TileArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int w = W > 0 ? W : a.w;
  const int k = W > 0 ? W : a.k;
  const int rows = blockDim.x;
  const int n_chunks = W > 0 ? 1 : (w + k - 1) / k;
  const long long n_tiles = (a.n + rows - 1) / rows;
  // the grid never exceeds the tiles, so every block has one
  const long long items =
      (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * n_chunks;
  const int stage_words = rows * a.stride;

  // item i of this block: tile blockIdx.x + (i / n_chunks) * gridDim.x,
  // lanes [chunk * k, chunk * k + kc) of its rows, chunk = i % n_chunks
  auto copy = [&](long long item, int stage) {
    const long long r0 =
        (blockIdx.x + item / n_chunks * gridDim.x) * rows;
    const int k0 = static_cast<int>(item % n_chunks) * k;
    const int kc = min(k, w - k0);
    const int nr = static_cast<int>(min(static_cast<long long>(rows),
                                        a.n - r0));
    const int32_t* src = lanes + r0 * w + k0;
    uint32_t* dst = smem + stage * stage_words;
    if constexpr (VEC == 16) {
      const int per_row = (W > 0 ? W : kc) / 4;
      for (int u = threadIdx.x; u < nr * per_row; u += rows) {
        const int r = u / per_row;
        const int q = u - r * per_row;
        cp_async16(dst + r * a.stride + 4 * q,
                   src + static_cast<long long>(r) * w + 4 * q);
      }
    } else {
      for (int u = threadIdx.x; u < nr * kc; u += rows) {
        const int r = u / kc;
        const int q = u - r * kc;
        cp_async4(dst + r * a.stride + q,
                  src + static_cast<long long>(r) * w + q);
      }
    }
  };

  Fold f;
  copy(0, 0);
  cp_async_commit();
  for (long long i = 0; i < items; ++i) {
    cp_async_wait_all();
    // item i is in shared memory, and every thread is done folding item
    // i - 1, whose stage the copy of item i + 1 now overwrites
    __syncthreads();
    if (i + 1 < items) copy(i + 1, static_cast<int>((i + 1) & 1));
    cp_async_commit();

    const long long r =
        (blockIdx.x + i / n_chunks * gridDim.x) * rows + threadIdx.x;
    const int chunk = static_cast<int>(i % n_chunks);
    if (chunk == 0) f = Fold();
    if (r < a.n) {
      const uint32_t* row =
          smem + static_cast<int>(i & 1) * stage_words + threadIdx.x * a.stride;
      const int k0 = chunk * k;
      if constexpr (VEC == 16) {
        const uint4* v = reinterpret_cast<const uint4*>(row);
        auto fold4 = [&](int q) {
          const uint4 x = v[q];
          const uint32_t j1 = static_cast<uint32_t>(k0 + 4 * q + 1);
          f.lane(x.x, j1);
          f.lane(x.y, j1 + 1);
          f.lane(x.z, j1 + 2);
          f.lane(x.w, j1 + 3);
        };
        if constexpr (W > 0) {
#pragma unroll
          for (int q = 0; q < W / 4; ++q) fold4(q);
        } else {
          const int pieces = min(k, w - k0) / 4;
#pragma unroll 4
          for (int q = 0; q < pieces; ++q) fold4(q);
        }
      } else {
        const int kc = min(k, w - k0);
#pragma unroll 4
        for (int q = 0; q < kc; ++q) {
          f.lane(row[q], static_cast<uint32_t>(k0 + q + 1));
        }
      }
      if (chunk == n_chunks - 1) out[r] = f.finish();
    }
  }
}

// Blocks of `kernel` that fit on the whole card at once with `threads`
// threads and `smem` bytes of dynamic shared memory: the persistent grid.
// Cached per (kernel, threads, shared memory, card), so the occupancy query
// and the SM count are read once; the first call on a card also lifts the
// kernel's dynamic shared memory cap to the card's maximum where it needs
// more than the default 48 KB.
cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                            long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, long long> cache;
  const auto key = std::make_tuple(kernel, threads, smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    int cap = 0;
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = cache[key] = static_cast<long long>(per_sm) * sms;
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long work_blocks, int threads, int smem,
           cudaStream_t stream, Args... args) {
  long long blocks = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(kernel), threads, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = work_blocks < blocks ? work_blocks : blocks;
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_rows(const int32_t* lanes, int2* out, long long n, int threads,
                cudaStream_t stream) {
  const long long rows_per_block =
      static_cast<long long>(threads) * kRowsPerThread;
  return launch(fingerprint_rows_kernel<W>,
                (n + rows_per_block - 1) / rows_per_block, threads, 0,
                stream, lanes, out, n);
}

template <int W, int VEC>
int launch_tile(const int32_t* lanes, int2* out, const TileArgs& a,
                int threads, int smem, cudaStream_t stream) {
  return launch(fingerprint_tile_kernel<W, VEC>,
                (a.n + threads - 1) / threads, threads, smem, stream, lanes,
                out, a);
}

}  // namespace

// lanes: (n, w) int32 contiguous; out: (n, 2) int32 contiguous. plan: w,
// path (0 rows, 1 tile16, 2 tile4), threads per block, rows per tile,
// lanes per chunk, staged row stride in words, dynamic shared memory bytes
// (kernels/fingerprint.py, fingerprint_plan). tile16 needs a 16-byte
// aligned base and w % 4 == 0.
extern "C" int fingerprint_launch(const int32_t* lanes, int32_t* out,
                                  long long n, const long long* plan,
                                  void* stream) {
  if (n <= 0) return 0;
  const int w = static_cast<int>(plan[0]);
  const int path = static_cast<int>(plan[1]);
  const int threads = static_cast<int>(plan[2]);
  const TileArgs a{n, w, static_cast<int>(plan[4]),
                   static_cast<int>(plan[5])};
  const int smem = static_cast<int>(plan[6]);
  auto* o = reinterpret_cast<int2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // the plan's rows per block step: a thread's rows (rows path) or one
  // row a thread (tile paths)
  if (plan[3] != static_cast<long long>(threads) *
                     (path == kPathRows ? kRowsPerThread : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path == kPathRows) {
    switch (w) {
      case 0: return launch_rows<0>(lanes, o, n, threads, s);
      case 1: return launch_rows<1>(lanes, o, n, threads, s);
      case 2: return launch_rows<2>(lanes, o, n, threads, s);
      case 3: return launch_rows<3>(lanes, o, n, threads, s);
      case 4: return launch_rows<4>(lanes, o, n, threads, s);
      case 5: return launch_rows<5>(lanes, o, n, threads, s);
      case 6: return launch_rows<6>(lanes, o, n, threads, s);
      case 7: return launch_rows<7>(lanes, o, n, threads, s);
      case 8: return launch_rows<8>(lanes, o, n, threads, s);
      default: break;
    }
  } else if (path == kPathTile16 && w % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(lanes) & 15) == 0) {
    if (w == 64) return launch_tile<64, 16>(lanes, o, a, threads, smem, s);
    return launch_tile<0, 16>(lanes, o, a, threads, smem, s);
  } else if (path == kPathTile4) {
    return launch_tile<0, 4>(lanes, o, a, threads, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
