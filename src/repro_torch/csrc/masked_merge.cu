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
// Bound on this card: bytes. Each output element needs one operand
// element, the one the masks select, so the least traffic is N*W*s bytes
// of values read and N*W*s written, N + W mask bytes, the timestamps of
// the rows that keep theirs read and N*t written, with one select per
// element (kernels/masked_merge.py: merge_nbytes).
//
// Design: a row is cut into units of kUnit bytes (16 where W*s and the
// three value pointers allow it, else 8, 4, 2 or one element;
// merge_plan picks), so no unit crosses a row and a row's mask is one
// byte per unit. A block owns rows_per_block rows. It first turns the
// field mask into one class per unit position (none, all or mixed lanes
// taken) and the row mask into shared memory, and stamps its rows'
// timestamps (reading ts_base only where the row keeps it). Then each
// thread moves units tid, tid + blockDim, ... of the block's rows,
// kBatch loads in flight before their stores, and reads only the operand
// the select needs: base where the row is not merged or its unit takes
// no field, upd where the row is merged and the unit takes every field,
// both (and a select per lane) only for a mixed unit of a merged row. A
// thread finds its units' rows by stepping (row, unit) by blockDim's
// quotient and remainder, one division per thread and none per element.
// Operands and timestamps are read and written with the streaming hints
// (ld/st .cs): nothing is read twice.
#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

template <int B> struct Bits;
template <> struct Bits<1> { using type = unsigned char; };
template <> struct Bits<2> { using type = unsigned short; };
template <> struct Bits<4> { using type = unsigned int; };
template <> struct Bits<8> { using type = unsigned long long; };
template <> struct Bits<16> { using type = uint4; };

enum : uint8_t { kNone = 0, kAll = 1, kMixed = 2 };

constexpr int kBatch = 4;            // loads in flight per thread
constexpr int kMaxClasses = 32768;   // unit classes kept in shared memory
constexpr int kMaxRowsPerBlock = 8192;

// which of a unit's kLanes fields the field mask takes: none, all or some
template <int kLanes>
__device__ __forceinline__ uint8_t unit_class(const uint8_t* field_mask,
                                              long long u) {
  int taken = 0;
#pragma unroll
  for (int e = 0; e < kLanes; ++e)
    taken += __ldg(field_mask + u * kLanes + e) != 0;
  return taken == 0 ? kNone : (taken == kLanes ? kAll : kMixed);
}

// a mixed unit: upd's lanes where the field is taken, base's elsewhere
template <typename Unit, typename Lane>
__device__ __forceinline__ Unit lane_select(Unit upd, Unit base,
                                            const uint8_t* field_mask,
                                            long long u) {
  constexpr int kLanes = sizeof(Unit) / sizeof(Lane);
  Lane a[kLanes], b[kLanes];
  memcpy(a, &upd, sizeof upd);
  memcpy(b, &base, sizeof base);
#pragma unroll
  for (int e = 0; e < kLanes; ++e)
    if (!__ldg(field_mask + u * kLanes + e)) a[e] = b[e];
  memcpy(&upd, a, sizeof upd);
  return upd;
}

template <int kUnit, int kLane, int kTs>
__global__ void masked_merge_kernel(
    const typename Bits<kUnit>::type* __restrict__ base,
    const typename Bits<kUnit>::type* __restrict__ upd,
    const uint8_t* __restrict__ row_mask,
    const uint8_t* __restrict__ field_mask,
    const typename Bits<kTs>::type* __restrict__ ts_base,
    typename Bits<kTs>::type ts_new,
    typename Bits<kUnit>::type* __restrict__ out,
    typename Bits<kTs>::type* __restrict__ ts_out, long long n_rows,
    int units_per_row, int rows_per_block) {
  using Unit = typename Bits<kUnit>::type;
  using Lane = typename Bits<kLane>::type;
  constexpr int kLanes = kUnit / kLane;
  extern __shared__ uint8_t smem[];
  uint8_t* rm = smem;                   // the block's row mask
  uint8_t* cls = smem + rows_per_block;  // class of each unit position
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(
      min(static_cast<long long>(rows_per_block), n_rows - row0));
  const int n_cls = min(units_per_row, kMaxClasses);
  for (int u = threadIdx.x; u < n_cls; u += blockDim.x)
    cls[u] = unit_class<kLanes>(field_mask, u);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const long long i = row0 + r;
    const uint8_t m = row_mask[i] != 0;
    rm[r] = m;
    __stcs(ts_out + i, m ? ts_new : __ldcs(ts_base + i));
  }
  __syncthreads();
  if (units_per_row == 0) return;
  const int count = rows * units_per_row;
  const long long first = row0 * units_per_row;
  const Unit* b = base + first;
  const Unit* p = upd + first;
  Unit* o = out + first;
  int r = threadIdx.x / units_per_row;
  int u = threadIdx.x - r * units_per_row;
  const int dr = blockDim.x / units_per_row;
  const int du = blockDim.x - dr * units_per_row;
  for (int j0 = threadIdx.x; j0 < count; j0 += kBatch * blockDim.x) {
    Unit v[kBatch], w[kBatch];
    uint8_t how[kBatch];
    int at[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < count) {
        const uint8_t c =
            u < n_cls ? cls[u] : unit_class<kLanes>(field_mask, u);
        how[k] = rm[r] ? c : kNone;
        at[k] = u;
        v[k] = __ldcs((how[k] == kNone ? b : p) + j);
        if (kLanes > 1 && how[k] == kMixed) w[k] = __ldcs(b + j);
      }
      u += du;
      r += dr;
      if (u >= units_per_row) {
        u -= units_per_row;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = j0 + k * blockDim.x;
      if (j < count) {
        if constexpr (kLanes > 1) {
          if (how[k] == kMixed)
            v[k] = lane_select<Unit, Lane>(v[k], w[k], field_mask, at[k]);
        }
        __stcs(o + j, v[k]);
      }
    }
  }
}

struct Args {
  const void* base;
  const void* upd;
  const uint8_t* row_mask;
  const uint8_t* field_mask;
  const void* ts_base;
  long long ts_new;
  void* out;
  void* ts_out;
  long long n;
  long long w;
  int rows_per_block;
  int threads;
  cudaStream_t stream;
};

template <int kUnit, int kLane, int kTs>
int launch(const Args& a) {
  using Unit = typename Bits<kUnit>::type;
  using TS = typename Bits<kTs>::type;
  const long long units = a.w * kLane / kUnit;
  const long long grid = (a.n + a.rows_per_block - 1) / a.rows_per_block;
  if (units > INT_MAX / a.rows_per_block || grid > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      a.rows_per_block + (units < kMaxClasses ? units : kMaxClasses);
  // the low kTs bytes of ts_new: its two's complement bits at that width
  TS ts_new;
  memcpy(&ts_new, &a.ts_new, sizeof ts_new);
  masked_merge_kernel<kUnit, kLane, kTs>
      <<<static_cast<unsigned>(grid), a.threads, smem, a.stream>>>(
          static_cast<const Unit*>(a.base), static_cast<const Unit*>(a.upd),
          a.row_mask, a.field_mask, static_cast<const TS*>(a.ts_base), ts_new,
          static_cast<Unit*>(a.out), static_cast<TS*>(a.ts_out), a.n,
          static_cast<int>(units), a.rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <int kUnit, int kLane>
int by_ts(int ts_size, const Args& a) {
  return ts_size == 8 ? launch<kUnit, kLane, 8>(a) : launch<kUnit, kLane, 4>(a);
}

template <int kUnit>
int by_lane(int elem_size, int ts_size, const Args& a) {
  switch (elem_size) {
    case 1: return by_ts<kUnit, 1>(ts_size, a);
    case 2: if constexpr (kUnit >= 2) return by_ts<kUnit, 2>(ts_size, a); break;
    case 4: if constexpr (kUnit >= 4) return by_ts<kUnit, 4>(ts_size, a); break;
    case 8: if constexpr (kUnit >= 8) return by_ts<kUnit, 8>(ts_size, a); break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// base, upd, out: (n, w) contiguous, elem_size bytes each (1, 2, 4 or 8);
// row_mask: (n,) and field_mask: (w,) bytes, nonzero = true; ts_base,
// ts_out: (n,) of ts_size bytes (4 or 8). unit_bytes: bytes a thread
// moves at once (1, 2, 4, 8 or 16, at least elem_size, dividing w *
// elem_size, and base, upd and out aligned to it); rows_per_block rows
// per block of `threads` threads. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for anything else.
extern "C" int masked_merge_launch(const void* base, const void* upd,
                                   const uint8_t* row_mask,
                                   const uint8_t* field_mask,
                                   const void* ts_base, long long ts_new,
                                   void* out, void* ts_out, long long n,
                                   long long w, int elem_size, int ts_size,
                                   int unit_bytes, int rows_per_block,
                                   int threads, void* stream) {
  const bool unit_ok = (unit_bytes == 1 || unit_bytes == 2 || unit_bytes == 4 ||
                        unit_bytes == 8 || unit_bytes == 16) &&
                       unit_bytes >= elem_size &&
                       (w * elem_size) % unit_bytes == 0 &&
                       aligned(base, unit_bytes) && aligned(upd, unit_bytes) &&
                       aligned(out, unit_bytes);
  if ((ts_size != 4 && ts_size != 8) || !unit_ok || w < 0 ||
      rows_per_block <= 0 || rows_per_block > kMaxRowsPerBlock ||
      threads <= 0 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const Args a{base, upd, row_mask, field_mask, ts_base, ts_new, out,
               ts_out, n, w, rows_per_block, threads, s};
  switch (unit_bytes) {
    case 1: return by_lane<1>(elem_size, ts_size, a);
    case 2: return by_lane<2>(elem_size, ts_size, a);
    case 4: return by_lane<4>(elem_size, ts_size, a);
    case 8: return by_lane<8>(elem_size, ts_size, a);
    case 16: return by_lane<16>(elem_size, ts_size, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
