// Masked merge: out[n, w] = (row_mask[n] && field_mask[w]) ? upd[n, w]
// : base[n, w] over an (N, W) row-major pair of any 1-, 2-, 4- or 8-byte
// element type, plus ts_out[n] = row_mask[n] ? ts_new : ts_base[n] with
// int32 or int64 timestamps. The increment merge of the head table (paper
// §III.A/F), reached through kernels.ops.masked_merge.
//
// Replaces the TPU kernel src/repro/kernels/masked_merge.py:24
// (_masked_merge_kernel). A select moves bits, so the kernel is templated
// on the element's width, not its type: float NaN payloads, signed zeros
// and every integer come through unchanged.
//
// Bound on this card: bytes. It reads 2*N*W*s bytes of values, N + W mask
// bytes and N*t bytes of timestamps, and writes N*W*s + N*t, with one
// compare and select per element. Design: one block per tile of
// `tile_rows` rows (the TPU kernel's 512); thread i handles flat elements
// i, i + blockDim, ... of the tile's rows*W range, so a warp's loads and
// stores cover contiguous bytes, and the index arithmetic stays 32-bit
// inside a tile. The block also stamps its tile's timestamps.
#include "common.cuh"

namespace {

template <typename U, typename TS>
__global__ void masked_merge_kernel(const U* __restrict__ base,
                                    const U* __restrict__ upd,
                                    const uint8_t* __restrict__ row_mask,
                                    const uint8_t* __restrict__ field_mask,
                                    const TS* __restrict__ ts_base, TS ts_new,
                                    U* __restrict__ out,
                                    TS* __restrict__ ts_out, long long n_rows,
                                    int width, int tile_rows) {
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        n_rows - row0));
  const long long begin = row0 * width;
  const int count = rows * width;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int r = j / width;
    const int c = j - r * width;
    const long long i = begin + j;
    out[i] = (row_mask[row0 + r] && field_mask[c]) ? upd[i] : base[i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const long long i = row0 + r;
    ts_out[i] = row_mask[i] ? ts_new : ts_base[i];
  }
}

template <typename U, typename TS>
void launch_typed(const void* base, const void* upd, const uint8_t* row_mask,
                  const uint8_t* field_mask, const void* ts_base,
                  long long ts_new, void* out, void* ts_out, long long n,
                  int w, int tile_rows, cudaStream_t stream) {
  const long long grid = (n + tile_rows - 1) / tile_rows;
  masked_merge_kernel<U, TS><<<static_cast<unsigned>(grid), 256, 0, stream>>>(
      static_cast<const U*>(base), static_cast<const U*>(upd), row_mask,
      field_mask, static_cast<const TS*>(ts_base), static_cast<TS>(ts_new),
      static_cast<U*>(out), static_cast<TS*>(ts_out), n, w, tile_rows);
}

template <typename U>
void launch_ts(int ts_size, const void* base, const void* upd,
               const uint8_t* row_mask, const uint8_t* field_mask,
               const void* ts_base, long long ts_new, void* out, void* ts_out,
               long long n, int w, int tile_rows, cudaStream_t stream) {
  if (ts_size == 8) {
    launch_typed<U, int64_t>(base, upd, row_mask, field_mask, ts_base, ts_new,
                             out, ts_out, n, w, tile_rows, stream);
  } else {
    launch_typed<U, int32_t>(base, upd, row_mask, field_mask, ts_base, ts_new,
                             out, ts_out, n, w, tile_rows, stream);
  }
}

}  // namespace

// base, upd, out: (n, w) contiguous, elem_size bytes each (1, 2, 4 or 8);
// row_mask: (n,) and field_mask: (w,) bytes, nonzero = true; ts_base,
// ts_out: (n,) of ts_size bytes (4 or 8). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width the kernel does not take.
extern "C" int masked_merge_launch(const void* base, const void* upd,
                                   const uint8_t* row_mask,
                                   const uint8_t* field_mask,
                                   const void* ts_base, long long ts_new,
                                   void* out, void* ts_out, long long n,
                                   int w, int elem_size, int ts_size,
                                   int tile_rows, void* stream) {
  if ((ts_size != 4 && ts_size != 8) || tile_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1:
      launch_ts<uint8_t>(ts_size, base, upd, row_mask, field_mask, ts_base,
                         ts_new, out, ts_out, n, w, tile_rows, s);
      break;
    case 2:
      launch_ts<uint16_t>(ts_size, base, upd, row_mask, field_mask, ts_base,
                          ts_new, out, ts_out, n, w, tile_rows, s);
      break;
    case 4:
      launch_ts<uint32_t>(ts_size, base, upd, row_mask, field_mask, ts_base,
                          ts_new, out, ts_out, n, w, tile_rows, s);
      break;
    case 8:
      launch_ts<uint64_t>(ts_size, base, upd, row_mask, field_mask, ts_base,
                          ts_new, out, ts_out, n, w, tile_rows, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
