// Causal grouped-query flash attention, backward (the FlashAttention-2
// algorithm, P recomputed from q, k and the forward's log-sum-exp):
//   s_ij   = q_i . k_j D^-0.5,  P_ij = exp(s_ij - lse_i), 0 where masked
//   delta_i = dO_i . o_i                                   (delta kernel)
//   dV_j   = sum_i P_ij dO_i                                (dkdv kernels)
//   dS_ij  = P_ij (dO_i . v_j - delta_i)
//   dK_j   = D^-0.5 sum_i dS_ij q_i                         (dkdv kernels)
//   dQ_i   = D^-0.5 sum_j dS_ij k_j                         (dq kernels)
// with q, o, dO (B, Sq, H, D), k and v (B, Sk, K, D), H = K * G, f32 or
// bf16, D 8, 16, 32, 64, 112 or 128, the queries the last Sq positions of
// the key axis (key j visible to query i when j <= i + Sk - Sq), lse (B, H,
// Sq) f32 from flash_attention.cu's kernels (m + log(max(l, 1e-30)); -1e30
// for a row that sees no key). dK and dV of a KV head sum over the G query
// heads that read it. A masked pair, and a row that sees no key, add
// exactly 0.
// Every sum is f32; the outputs are written once, in q's dtype.
//
// Replaces no TPU kernel: the JAX package differentiates its attention by
// autodiff of the XLA scan (src/repro/models/attention.py:89,
// _chunked_attention, under jax.checkpoint), and its Pallas forward
// (src/repro/kernels/flash_attention.py:33) has no backward. The port's
// "chunked" attention is the hand-written forward kernel, so training
// needs these for the same gradients (kernels/flash_attention.py:
// FlashAttentionFn). The arithmetic is that of the JAX gradient: f32
// logits, P and dS in f32 in every product, f32 sums.
//
// Bound on this card: operations. dkdv takes four products over the
// visible pairs (S recomputed, dP, dV, dK) and dq three (S, dP, dQ), 2 B H
// D FLOPs a pair each: at llama3.2-1b's training layer (B 2 x S 4,096,
// H 32 / K 8, D 64) 0.275 and 0.206 TFLOP, 0.28 and 0.21 ms at the dense
// bf16 tensor-core rate of 989.4 TFLOP/s; in f32 each product is three
// TF32 products at 494.7 TFLOP/s, 1.67 and 1.25 ms. Two kernels rather
// than dQ folded into the dkdv pass with f32 atomics: 7 products a tile
// pair instead of 5, but deterministic gradients.
//
// Four designs, by (dtype, D) as the forward's (kernels/flash_attention.py:
// bwd_plan). At D 64, 112 and 128 two, by dtype, on the tensor cores by
// wgmma, with the skeleton of flash_attention.cu's wgmma kernels (D 112
// in D 128's tiles: TMA fills the box columns past 112 with zeros, so the
// products over D take 16 zero columns, and the epilogues store 112; the
// kernels' template argument is the tensors' D, their tiles tile_d(D)):
// warpgroup 0 the producer (one thread issues TMA loads of 128-byte-swizzled
// boxes into a ring of stages, each with a full and an empty mbarrier),
// 64-row consumer warpgroups, blocks heaviest first, masks only on tiles
// that cross the diagonal, Sq or Sk. P and dS are formed in f32 on the
// accumulator fragment and enter their products in parts that keep them at
// f32 precision. dkdv is a block per (key tile, KV head, batch), key tile 0
// (the most query tiles) first: the block takes its K and V once and, for
// each of the G query heads and each query tile from the first that sees its
// keys (bwd_plan.first_q_tile), the q and dO tiles and their lse (log2
// units) and delta rows; its consumers take the keys as the M side, S^T = K
// q^T, dP^T = V dO^T, P^T = exp2(S^T D^-0.5 log2(e) - lse) and dS^T = P^T
// (dP^T - delta) with the query the column, then dV += P^T dO and dK += dS^T
// q with P^T and dS^T the register A operand (RS). dq is a block per (query
// tile, head, batch), the last first: q and dO once, then each causal K and
// V tile, S = q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K (RS). dK,
// dV and dQ stay in f32 registers and are written once (dK and dQ times
// D^-0.5), with no atomics: the result does not depend on block order.
// * bf16: flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel. P and
//   dS enter as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), each
//   its own wgmma: hi + lo is x to 2^-17, and the other operand is a bf16
//   input, so each product is exact in f32 and only the order of the f32
//   sums differs from the plain version's; the outputs round once to
//   bf16. dkdv folds its accumulators into f32 running sums in shared
//   memory every kFoldTrips trips (accumulator drift, as in the f32
//   kernels below; 64 KB of shared memory). P rounded to bf16 once (FlashAttention-2/3) would move outputs
//   by several bf16 ulps from the f32-P gradient. The price: dkdv issues 6
//   product units a tile pair against the 4 of its bound, dq 4 against 3.
//   The producer gives its registers away by setmaxnreg where there are
//   two consumers.
//   - dkdv: 128 keys and two consumers at D 64, 64 keys and one consumer
//     at D 128 (dK and dV alone are 128 registers a thread there); 64-row
//     query tiles through 3 stages, producer warp 1 copying each tile's
//     lse and delta rows into the stage. S^T and dP^T are SS wgmma
//     m64n64k16 (K and V the K-major A operand as stored, q and dO the
//     K-major B operand as stored); dV and dK are RS wgmma m64nDk16, dO
//     and q read from the same stage as the MN-major B operand (the
//     forward's V). Three commit groups overlap the exp and the splits
//     with the tensor cores: S^T, then dP^T (P^T formed while it runs),
//     then dV (dS^T formed while it runs), then dK. A tile where all of a
//     consumer's keys follow all its queries is skipped. Shared memory:
//     147 KB at D 64, 195 KB at D 128 (64 KB of them the running sums).
//   - dq: 128-row query tiles, two 64-row consumers; 64-key K and V tiles
//     through two stages; S and dP as SS wgmma in two groups, dQ += dS K
//     as RS wgmma with K the MN-major B operand. Shared memory: 65 KB at
//     D 64, 129 KB at D 128.
// * f32: flash_bwd_dkdv_wgmma_f32_kernel and flash_bwd_dq_wgmma_f32_kernel,
//   the arithmetic of flash_attention.cu's flash_wgmma_f32_kernel: wgmma
//   reads f32 operands as TF32, so every operand x is split into hi, x
//   rounded to TF32, and lo = x - hi (split), and every product is three
//   TF32 products, A_lo B_hi + A_hi B_lo + A_hi B_hi (the small terms
//   first), summed in f32; A_lo B_lo (2^-22 of A B) is dropped. One TF32
//   product would be 2^-11 off, far outside the f32 checks. P^T and dS^T
//   (dkdv), P and dS (dq), are split in registers as the forward splits P.
//   Unlike the forward, the split takes no cvt: hi is rounded on the
//   integer pipe and lo is left unrounded, since the conversion pipe,
//   which the producer and the consumers share, held both kernels back.
//   What the TF32 products force:
//   - TF32 wgmma reads both shared-memory operands K-major only. Of the
//     B operands, q and dO (of S^T, dP^T), K and V (of S, dP) are K-major
//     as stored; dO^T (of dV), q^T (of dK) and K^T (of dQ) are not, so the
//     producer warpgroup writes them transposed: rows of D, the queries or
//     keys contiguous, each 8-group in the order 0 2 4 6 1 3 5 7, so that
//     the accumulator's P and dS fragments are TF32 A fragments with no
//     register moved between lanes (perm8). TMA loads the raw f32 tiles
//     (32-column boxes, the 128-byte swizzle row of f32) into a raw ring;
//     all 128 producer threads write each tile's hi and lo parts at the
//     raw tile's own offsets and, where it is a B operand of an RS
//     product, transposed, into a ring of split stages that the consumers
//     read. Its writes are free of bank conflicts (split_tile).
//   - Shared memory: f32 tiles are twice bf16's and every operand needs
//     two parts. dkdv holds the hi and lo of its K and V, 64 keys (64 KB
//     at D 64, 128 KB at D 128), and per split stage the hi and lo of q,
//     dO and of the transposed tile (q^T beside dO^T): 64 KB at 32 query
//     rows a trip and D 64, or at 16 rows and D 128. D 64: two split
//     stages and two raw stages (16 KB each), 224 KB of the 227; D 128:
//     one split stage, 224 KB. So 64 keys a block, where the bf16 kernel
//     takes 128 at D 64. dq holds the hi and lo of q and dO for its 64
//     rows (64 KB at D 64, 128 KB at D 128) and per split stage the hi and
//     lo of K and V and one transposed tile (K^T hi beside K^T lo): 48 KB
//     at 32 keys a trip and D 64 (two stages, 192 KB), at 16 keys and D
//     128 (one stage, 208 KB). The raw K and V (dkdv) and q and dO (dq)
//     land once where the stages go and are split before the first trip.
//     Sixteen-row tiles are half a 128-byte row transposed; two share one
//     (q^T beside dO^T, K^T hi beside K^T lo), so every tile keeps the
//     128-byte swizzle.
//   - Accumulator drift: the tensor cores' f32 sums drop low bits of
//     addends much smaller than the sum. dK and dV sum over G x query
//     trips (512 at S 4,096, G 4, 32-row trips), dQ over up to 256 key
//     trips, so each kFold trips' products go into a fresh accumulator
//     and are added to the f32 running sums with one FADD an element
//     (kFold). tools/torch_flash_bwd_probe.py chose kFold = 1
//     (NVIDIA H100 80GB HBM3, 700 W, B 2 x S 4,096, llama3.2-1b's H 32 /
//     K 8, D 64): with no fold dK and dV land 4.2 and 6.8 times BWD_TOL[f32]
//     from the plain backward (1.4 and 1.8 at olmo-1b's D 128); folding
//     every 8 trips leaves 0.15 and 0.24 of it, every trip 0.09 and 0.11,
//     for the same time.
//   - Registers: the running sums and a fresh accumulator are D
//     registers a thread, too many at D 128 beside dK and dV's own. So
//     dkdv's two consumers split by gradient, not by keys: both own the
//     block's 64 keys and form P^T, warpgroup 1 sums dV, warpgroup 2 forms
//     dP^T and dS^T and sums dK (5 product units a trip against the 4 of
//     the bound). Each role is its own instantiation (dkdv_consumer):
//     with the roles as runtime branches ptxas serialized every wgmma (a
//     register of the A operand defined on a divergent path). The producer
//     keeps 72 registers (setmaxnreg) for its unrolled split, the
//     consumers 216. At D 64 the consumers also hold K's hi and lo as A
//     fragments (64 registers), so S^T is an RS product and reads only
//     q's parts from shared memory. dq has one consumer and no setmaxnreg.
//   - Where the time goes (the probe, same card): at llama3.2-1b's layer
//     dkdv 4.21 ms and dq 2.74 ms on the card alone, 40% and 46% of their
//     bounds (4.75 and 3.03 with two cvt an element); with the producer's
//     per-trip split removed (timing only) 3.47-3.61 and 2.29 ms.
// * D 8, 16 and 32, both dtypes: flash_bwd_dkdv_mma_kernel and
//   flash_bwd_dq_mma_kernel (namespace mb), warp-level mma.sync on the
//   tensor cores with the forward mma kernels' packing, so that S 16-32
//   sequences fill a block: rows through 16-byte cp.async copies into
//   padded shared-memory rows (hopper.cuh: strip), 16-row strips a warp,
//   several strips and heads a block, two stages where a block visits
//   more than one tile. The FlashAttention-2 split, which holds at S 4,096
//   too: dkdv takes a warp per 16-key strip of one (KV head, batch), the
//   block's K and V strips once, then for each of the G query heads and
//   each 32-row query tile from the first that sees a key of the block a
//   trip of the hb query heads' q and dO tiles and lse and delta rows; the
//   keys are the M side (S^T = K q^T, dP^T = V dO^T, dV += P^T dO, dK +=
//   dS^T q). dq is the forward's packing (a warp a 16-row query strip of
//   one (head, batch)) with dO's rows beside q's and the K and V tiles of
//   32 keys through the stages (S = q K^T, dP = dO V^T, dQ += dS K). The
//   arithmetic is the wgmma designs': in bf16 S and dP one product of the
//   bf16 inputs (exact in f32), P and dS (P^T, dS^T) as two bf16 parts,
//   each its own m16n8k16 product; in f32 every product three m16n8k8
//   TF32 products of the operands' hi and lo parts (split in registers),
//   with P's and dS's A fragments the accumulator's c0 c2 c1 c3 and the
//   B operand read at rows 2t and 2t + 1 (flash_attention.cu's
//   flash_mma_f32_kernel). Each trip's products go into a fresh
//   accumulator, added to the f32 sums; masks only on trips that cross
//   the diagonal, Sq or Sk. At D 8 (bf16) the k16 steps read the rows'
//   zeroed padding as head-dim columns. Bound by bytes at the Meta-pipe
//   encoder's B 4,096 x S 32 (one tile each way): a simple first design.
// * flash_bwd_delta_kernel (either dtype): delta_lanes(D) threads a row (a
//   power of two at most D / 4 and 32, so that a row's lanes sit inside a
//   warp: 16 at D 112 over its 28 four-element pieces, 2 at D 8), four
//   elements a load, a shuffle reduction; (B, H, Sq) f32.
//
// The wgmma dkdv and dq kernels read q, k, v and dO by TMA, the mma ones
// by 16-byte cp.async: every base and stride a multiple of 16 bytes, the
// head dim contiguous; the wrapper copies an operand that is not (a scalar
// loss's zero-stride dO among them).
#include <cuda_bf16.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // the delta kernel's block
constexpr float kLog2e = 1.4426950408889634f;

using hopper::Strides;
using hopper::tile_d;

struct Shape {
  int batch, sq, sk, n_heads, n_kv_heads, group;
};

using hopper::ex2;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, c;
  *reinterpret_cast<uint32_t*>(&a) = u.x;
  *reinterpret_cast<uint32_t*>(&c) = u.y;
  const float2 fa = __bfloat1622float2(a), fc = __bfloat1622float2(c);
  return make_float4(fa.x, fa.y, fc.x, fc.y);
}
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The delta kernel's lanes a row: the largest power of two at most D / 4
// and 32, so that a row's lanes are an aligned group within a warp and
// the shuffle sum stays inside it. Each lane sums the four-element pieces
// lane, lane + lanes, ... of the row: one at D 8 (2 lanes), 16, 32, 64 and
// 128 (32 lanes), two or one at D 112 (28 pieces over 16 lanes)
// (kernels/flash_attention.py: delta_lanes).
__host__ __device__ constexpr int delta_lanes(int d) {
  int n = 1;
  while (2 * n <= d / 4 && 2 * n <= 32) n *= 2;
  return n;
}

// delta[(b H + h) Sq + i] = dO[b, i, h, :] . o[b, i, h, :], delta_lanes(D)
// threads a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, Strides ost,
                       const T* __restrict__ dO, Strides dst,
                       float* __restrict__ delta, Shape sh) {
  constexpr int kLanes = delta_lanes(D);
  constexpr int kPieces = D / 4;
  const long long r = static_cast<long long>(blockIdx.x) *
                          (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long n_rows =
      static_cast<long long>(sh.batch) * sh.n_heads * sh.sq;
  float acc = 0.f;
  if (r < n_rows) {
    const int i = static_cast<int>(r % sh.sq);
    const int h = static_cast<int>(r / sh.sq % sh.n_heads);
    const int b = static_cast<int>(r / sh.sq / sh.n_heads);
    const T* orow = o + b * ost.b + i * ost.s + h * ost.h;
    const T* drow = dO + b * dst.b + i * dst.s + h * dst.h;
    for (int c = lane; c < kPieces; c += kLanes) {
      acc = dot4(acc, load4(orow + 4 * c), load4(drow + 4 * c));
    }
  }
#pragma unroll
  for (int w = kLanes / 2; w > 0; w /= 2) {
    acc += __shfl_xor_sync(repro::kFullMask, acc, w);
  }
  if (r < n_rows && lane == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernels (D = 64 and 128)
// ---------------------------------------------------------------------------

namespace wg {

using hopper::bits;
using hopper::desc_k_major;
using hopper::desc_mn_major;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_bf16;
using hopper::wgmma_wait;

constexpr int kCols = 64;  // head-dim columns a TMA box: one 128-byte
                           // swizzle row of bf16
constexpr int kRow = 128;  // bytes of a box row

// Trips of dkdv's tensor-core accumulators between two folds into the
// f32 running sums (the fold: see flash_bwd_dkdv_wgmma_kernel).
constexpr int kFoldTrips = 4;

// flash_bwd_dkdv_wgmma_kernel's geometry. Shared memory from a 1024-byte
// aligned base: the block's K and V tiles (D / 64 boxes of kBK rows each),
// then per stage a q and a dO tile (D / 64 boxes of kBQ rows each), then
// per stage the tile's lse (log2 units) and delta rows, then the
// mbarriers: K/V full, then full and empty per stage, then the consumers'
// running sums of dK and dV (D floats a thread, as float4 slots
// interleaved over the warpgroup's 128 threads).
template <int D>
struct Dkdv {
  static constexpr int kConsumers = D == 64 ? 2 : 1;  // 64-key warpgroups
  static constexpr int kBK = 64 * kConsumers;         // keys a block
  static constexpr int kBQ = 64;                      // query rows a tile
  static constexpr int kStages = 3;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBoxK = kBK * kRow;
  static constexpr int kBoxQ = kBQ * kRow;
  static constexpr int kKTile = D / kCols * kBoxK;
  static constexpr int kQTile = D / kCols * kBoxQ;
  static constexpr int kV = kKTile;
  static constexpr int kStage0 = 2 * kKTile;
  static constexpr int kRows = kStage0 + kStages * 2 * kQTile;
  static constexpr int kBars = kRows + kStages * 2 * kBQ * 4;
  static constexpr int kSums = (kBars + 8 * (1 + 2 * kStages) + 15) / 16 * 16;
  static constexpr int kAlloc = kSums + kConsumers * 128 * D * 4 + 1024;
  static_assert(kAlloc <= 232448, "over the block's shared memory");
};

// flash_bwd_dq_wgmma_kernel's geometry: Q and dO of the block's kBQ rows
// (D / 64 boxes each), then per stage a K and a V tile of kBK keys, then
// the mbarriers: Q/dO full, then full and empty per stage.
template <int D>
struct Dq {
  static constexpr int kConsumers = 2;  // 64-row warpgroups
  static constexpr int kBQ = 64 * kConsumers;
  static constexpr int kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBoxQ = kBQ * kRow;
  static constexpr int kBoxK = kBK * kRow;
  static constexpr int kQTile = D / kCols * kBoxQ;
  static constexpr int kKTile = D / kCols * kBoxK;
  static constexpr int kDO = kQTile;
  static constexpr int kStage0 = 2 * kQTile;
  static constexpr int kBars = kStage0 + kStages * 2 * kKTile;
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kAlloc <= 232448, "over the block's shared memory");
};

// S (64 x 64, f32) (+)= A (64 x 16, smem) * B (64 x 16, smem)^T, bf16, both
// K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A (64 x 64) times B^T (64 x 64) over D, both K-major tiles of D / 64
// boxes whose rows are `box_a` and `box_b` bytes apart: D / 16 steps of
// 16 head-dim columns into a fresh accumulator.
template <int D>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           uint32_t box_a, uint32_t b,
                                           uint32_t box_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64(d, desc_k_major(a + (kk / 4) * box_a + col),
                 desc_k_major(b + (kk / 4) * box_b + col), kk > 0);
  }
}

// x0, x1 as two bf16 parts each, packed as wgmma A-fragment registers:
// hi = bf16(x), lo = bf16(x - hi), hi + lo = x to 2^-17.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// acc's values added into this thread's running sums (float4 slot i at
// sums[128 i]) and acc cleared: the fold.
template <int N>
__device__ __forceinline__ void fold_into(float (&acc)[N], float4* sums) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float4 r = sums[128 * i];
    r.x += acc[4 * i];
    r.y += acc[4 * i + 1];
    r.z += acc[4 * i + 2];
    r.w += acc[4 * i + 3];
    sums[128 * i] = r;
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
}

// The A fragment of k-step kk of a part: registers 4 kk .. 4 kk + 3.
__device__ __forceinline__ void frag(const uint32_t (&part)[16], int kk,
                                     uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = part[4 * kk + e];
}

// blockIdx.x -> (key tile, KV head, batch), key tile 0 (the most query
// tiles) first (kernels/flash_attention.py: BwdPlan).
template <int DR>
__global__ void __launch_bounds__(Dkdv<tile_d(DR)>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Shape sh,
                            float scale) {
  constexpr int D = tile_d(DR);
  using L = Dkdv<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full0 = kv_full + 8;             // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * L::kStages;  // empty[s] = empty0 + 8 s

  const int per = sh.n_kv_heads * sh.batch;
  const int kvh = static_cast<int>(blockIdx.x) % per % sh.n_kv_heads;
  const int b = static_cast<int>(blockIdx.x) % per / sh.n_kv_heads;
  const int k0 = static_cast<int>(blockIdx.x) / per * L::kBK;
  const int offset = sh.sk - sh.sq;
  const int n_q_tiles = (sh.sq + L::kBQ - 1) / L::kBQ;
  // the first query tile that sees a key of the block; then every tile
  // to the last, for each of the G query heads of the KV head
  const int first = max(k0 - offset, 0) / L::kBQ;
  const int n_per_head = n_q_tiles - first;
  const int n_trips = sh.group * n_per_head;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      // the TMA bytes (one arrival) and the 32 lanes that write the rows
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, 4 * L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: thread 0 issues every TMA load; warp 1 copies each tile's
    // lse (in log2 units) and delta rows, 0 past Sq
    if constexpr (L::kConsumers == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKTile);
      for (int c = 0; c < D / kCols; ++c) {
        tma_load(base + c * L::kBoxK, &kmap, kv_full, c * kCols, kvh, k0, b);
        tma_load(base + L::kV + c * L::kBoxK, &vmap, kv_full, c * kCols, kvh,
                 k0, b);
      }
      for (int j = 0; j < n_trips; ++j) {
        const int s = j % L::kStages;
        const int h = kvh * sh.group + j / n_per_head;
        const int q0 = (first + j % n_per_head) * L::kBQ;
        mbar_wait(empty0 + 8 * s, ((j / L::kStages) & 1) ^ 1);
        const uint32_t qs = base + L::kStage0 + 2 * s * L::kQTile;
        mbar_expect_tx(full0 + 8 * s, 2 * L::kQTile);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(qs + c * L::kBoxQ, &qmap, full0 + 8 * s, c * kCols, h, q0,
                   b);
          tma_load(qs + L::kQTile + c * L::kBoxQ, &dmap, full0 + 8 * s,
                   c * kCols, h, q0, b);
        }
      }
    } else if (warp == 1) {
      for (int j = 0; j < n_trips; ++j) {
        const int s = j % L::kStages;
        const int h = kvh * sh.group + j / n_per_head;
        const int q0 = (first + j % n_per_head) * L::kBQ;
        const long long rows =
            (static_cast<long long>(b) * sh.n_heads + h) * sh.sq;
        mbar_wait(empty0 + 8 * s, ((j / L::kStages) & 1) ^ 1);
        float* ls = reinterpret_cast<float*>(sbase + L::kRows +
                                             s * 2 * L::kBQ * 4);
#pragma unroll
        for (int i = lane; i < L::kBQ; i += 32) {
          const bool ok = q0 + i < sh.sq;
          ls[i] = ok ? lse[rows + q0 + i] * kLog2e : 0.f;
          ls[L::kBQ + i] = ok ? delta[rows + q0 + i] : 0.f;
        }
        mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup wgi owns keys k0 + 64 (wgi - 1) + [0, 64)
    if constexpr (L::kConsumers == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    const int t = threadIdx.x - 128 * wgi;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int key_wg = k0 + 64 * (wgi - 1);
    // accumulator fragment of S^T (keys x queries): element i of this
    // thread is key r0 + 8 ((i >> 1) & 1), query column 8 (i >> 2) + col0
    // + (i & 1) of the tile
    const int r0 = key_wg + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t k_wg = base + 64 * kRow * (wgi - 1);
    const uint32_t v_wg = k_wg + L::kV;
    const float scale_log2 = scale * kLog2e;

    // the fold: the tensor cores' f32 sums drop low bits of addends much
    // smaller than the sum (at S 4,096 and G 8 a key's dK and dV take 4,096
    // wgmma adds, and drifted up to 2.1e-4 from the plain backward's on a
    // unit-scale dO), so each kFoldTrips trips' products are added to f32
    // running sums in shared memory and the accumulators cleared
    float acc_k[D / 2], acc_v[D / 2];
    float4* sums_k =
        reinterpret_cast<float4*>(sbase + L::kSums) + (wgi - 1) * 32 * D + t;
    float4* sums_v = sums_k + 128 * (D / 8);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      sums_k[128 * i] = sums_v[128 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_trips; ++j) {
      const int s = j % L::kStages;
      const int q0 = (first + j % n_per_head) * L::kBQ;
      mbar_wait(full0 + 8 * s, (j / L::kStages) & 1);
      // a tile where every key of the warpgroup follows every query (or
      // lies past Sk) adds 0: skipped
      if (key_wg < sh.sk && key_wg <= offset + q0 + L::kBQ - 1) {
        const uint32_t qs = base + L::kStage0 + 2 * s * L::kQTile;
        const uint32_t dos = qs + L::kQTile;
        const float* ls = reinterpret_cast<const float*>(
            sbase + L::kRows + s * 2 * L::kBQ * 4);
        const float* ds = ls + L::kBQ;

        // S^T = K Q^T and dP^T = V dO^T, two groups: P^T is formed while
        // dP^T is in flight
        float st[32], dpt[32];
        wgmma_fence();
        product_ss<D>(st, k_wg, L::kBoxK, qs, L::kBoxQ);
        wgmma_commit();
        product_ss<D>(dpt, v_wg, L::kBoxK, dos, L::kBoxQ);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T = exp2(S^T D^-0.5 log2(e) - lse), 0 where masked (only on
        // tiles that cross the diagonal, Sq or Sk), kept in f32 for dS^T
        // and packed as two bf16 parts (A fragments)
        const bool edge = key_wg + 63 > offset + q0 || key_wg + 64 > sh.sk ||
                          q0 + L::kBQ > sh.sq;
        uint32_t p_hi[16], p_lo[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = 8 * (i >> 2) + col0;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          float p0 = ex2(fmaf(st[i], scale_log2, -l2.x));
          float p1 = ex2(fmaf(st[i + 1], scale_log2, -l2.y));
          if (edge) {
            const int key = r0 + 8 * ((i >> 1) & 1);
            const int qpos = offset + q0 + col;
            const bool kill = key >= sh.sk;
            if (kill || key > qpos || q0 + col >= sh.sq) p0 = 0.f;
            if (kill || key > qpos + 1 || q0 + col + 1 >= sh.sq) p1 = 0.f;
          }
          st[i] = p0;
          st[i + 1] = p1;
          split2(p0, p1, p_hi[i >> 1], p_lo[i >> 1]);
        }

        // dV += P^T dO, each part its own product: 4 steps of 16 query
        // rows, dO the MN-major B operand; dS^T is formed while it runs
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kBQ / 16; ++kk) {
          const uint64_t bdo = desc_mn_major(dos + kk * 16 * kRow, L::kBoxQ);
          uint32_t a[4];
          frag(p_hi, kk, a);
          wgmma_rs_bf16<D>(acc_v, a, bdo);
          frag(p_lo, kk, a);
          wgmma_rs_bf16<D>(acc_v, a, bdo);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dpt);

        // dS^T = P^T (dP^T - delta), as two bf16 parts
        uint32_t d_hi[16], d_lo[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(ds + 8 * (i >> 2) + col0);
          split2(st[i] * (dpt[i] - d2.x), st[i + 1] * (dpt[i + 1] - d2.y),
                 d_hi[i >> 1], d_lo[i >> 1]);
        }

        // dK += dS^T q, q the MN-major B operand
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kBQ / 16; ++kk) {
          const uint64_t bq = desc_mn_major(qs + kk * 16 * kRow, L::kBoxQ);
          uint32_t a[4];
          frag(d_hi, kk, a);
          wgmma_rs_bf16<D>(acc_k, a, bq);
          frag(d_lo, kk, a);
          wgmma_rs_bf16<D>(acc_k, a, bq);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if ((j + 1) % kFoldTrips == 0 || j + 1 == n_trips) {
        fold_into(acc_k, sums_k);
        fold_into(acc_v, sums_v);
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float4 rk = sums_k[128 * i], rv = sums_v[128 * i];
      acc_k[4 * i] = rk.x, acc_k[4 * i + 1] = rk.y;
      acc_k[4 * i + 2] = rk.z, acc_k[4 * i + 3] = rk.w;
      acc_v[4 * i] = rv.x, acc_v[4 * i + 1] = rv.y;
      acc_v[4 * i + 2] = rv.z, acc_v[4 * i + 3] = rv.w;
    }

    // dK (times D^-0.5) and dV of keys < Sk, (B, Sk, K, DR) contiguous
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + 8 * r;
      if (key >= sh.sk) continue;
      const long long off =
          ((static_cast<long long>(b) * sh.sk + key) * sh.n_kv_heads + kvh) *
          DR;
#pragma unroll
      for (int jb = 0; jb < DR / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * jb + col0) =
            __floats2bfloat162_rn(acc_k[i] * scale, acc_k[i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * jb + col0) =
            __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// blockIdx.x -> (query tile, head, batch): the last query tile first over
// every head and batch (the forward's launch_order at kBQ rows).
template <int DR>
__global__ void __launch_bounds__(Dq<tile_d(DR)>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, Shape sh,
                          float scale) {
  constexpr int D = tile_d(DR);
  using L = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * L::kStages;

  const int per = sh.n_heads * sh.batch;
  const int n_q_tiles = (sh.sq + L::kBQ - 1) / L::kBQ;
  const int qt = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = static_cast<int>(blockIdx.x) % per % sh.n_heads;
  const int b = static_cast<int>(blockIdx.x) % per / sh.n_heads;
  const int q0 = qt * L::kBQ;
  const int offset = sh.sk - sh.sq;
  // causal trip count: the key tiles up to the block's last row's position
  const int q_last = offset + min(q0 + L::kBQ, sh.sq) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min(q_last / L::kBK + 1, (sh.sk + L::kBK - 1) / L::kBK);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: one thread loads Q and dO once, then each K and V tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQTile);
      for (int c = 0; c < D / kCols; ++c) {
        tma_load(base + c * L::kBoxQ, &qmap, q_full, c * kCols, h, q0, b);
        tma_load(base + L::kDO + c * L::kBoxQ, &dmap, q_full, c * kCols, h,
                 q0, b);
      }
      const int kvh = h / sh.group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::kStages;
        mbar_wait(empty0 + 8 * s, ((j / L::kStages) & 1) ^ 1);
        const uint32_t ks = base + L::kStage0 + 2 * s * L::kKTile;
        mbar_expect_tx(full0 + 8 * s, 2 * L::kKTile);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(ks + c * L::kBoxK, &kmap, full0 + 8 * s, c * kCols, kvh,
                   j * L::kBK, b);
          tma_load(ks + L::kKTile + c * L::kBoxK, &vmap, full0 + 8 * s,
                   c * kCols, kvh, j * L::kBK, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wgi owns query rows q0 + 64 (wgi - 1) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x - 128 * wgi;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int row_wg = q0 + 64 * (wgi - 1);
    // accumulator fragment of S (rows x keys): element i of this thread is
    // row r0 + 8 ((i >> 1) & 1), key column 8 (i >> 2) + col0 + (i & 1)
    const int r0 = row_wg + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t q_wg = base + 64 * kRow * (wgi - 1);
    const uint32_t do_wg = q_wg + L::kDO;
    const float scale_log2 = scale * kLog2e;
    const long long rows =
        (static_cast<long long>(b) * sh.n_heads + h) * sh.sq;
    float lr[2], dr[2];  // the rows' lse (log2 units) and delta, 0 past Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lr[r] = row < sh.sq ? lse[rows + row] * kLog2e : 0.f;
      dr[r] = row < sh.sq ? delta[rows + row] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      const int k0 = j * L::kBK;
      mbar_wait(full0 + 8 * s, (j / L::kStages) & 1);
      // a tile whose every key follows every row of the warpgroup adds 0
      if (k0 <= offset + row_wg + 63) {
        const uint32_t ks = base + L::kStage0 + 2 * s * L::kKTile;
        const uint32_t vs = ks + L::kKTile;

        // S = Q K^T and dP = dO V^T, two groups: P is formed while dP is
        // in flight
        float sc[32], dp[32];
        wgmma_fence();
        product_ss<D>(sc, q_wg, L::kBoxQ, ks, L::kBoxK);
        wgmma_commit();
        product_ss<D>(dp, do_wg, L::kBoxQ, vs, L::kBoxK);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // P = exp2(S D^-0.5 log2(e) - lse), 0 where masked (only on tiles
        // that cross the diagonal or Sk)
        const bool edge = k0 + L::kBK - 1 > offset + row_wg ||
                          k0 + L::kBK > sh.sk;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = (i >> 1) & 1;
          float p0 = ex2(fmaf(sc[i], scale_log2, -lr[r]));
          float p1 = ex2(fmaf(sc[i + 1], scale_log2, -lr[r]));
          if (edge) {
            const int key = k0 + 8 * (i >> 2) + col0;
            const int qpos = offset + r0 + 8 * r;
            if (key > qpos || key >= sh.sk) p0 = 0.f;
            if (key + 1 > qpos || key + 1 >= sh.sk) p1 = 0.f;
          }
          sc[i] = p0;
          sc[i + 1] = p1;
        }
        wgmma_wait<0>();
        fence_regs(dp);

        // dS = P (dP - delta), as two bf16 parts
        uint32_t d_hi[16], d_lo[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = (i >> 1) & 1;
          split2(sc[i] * (dp[i] - dr[r]), sc[i + 1] * (dp[i + 1] - dr[r]),
                 d_hi[i >> 1], d_lo[i >> 1]);
        }

        // dQ += dS K: 4 steps of 16 keys, K the MN-major B operand
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kBK / 16; ++kk) {
          const uint64_t bk = desc_mn_major(ks + kk * 16 * kRow, L::kBoxK);
          uint32_t a[4];
          frag(d_hi, kk, a);
          wgmma_rs_bf16<D>(acc, a, bk);
          frag(d_lo, kk, a);
          wgmma_rs_bf16<D>(acc, a, bk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // dQ (times D^-0.5) of rows < Sq, (B, Sq, H, DR) contiguous; rows that
    // see no key get 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sh.sq) continue;
      __nv_bfloat16* out =
          dq + ((static_cast<long long>(b) * sh.sq + row) * sh.n_heads + h) *
                   DR;
#pragma unroll
      for (int jb = 0; jb < DR / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jb + col0) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The f32 tensor-core kernels (D = 64 and 128): three TF32 products
// ---------------------------------------------------------------------------

namespace tf {

using hopper::bar_sync;
using hopper::desc_k_major;
using hopper::fence_async_smem;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::swz;
using hopper::tma_load;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_tf32;
using hopper::wgmma_ss_tf32;
using hopper::wgmma_wait;

constexpr int kCols = 32;  // head-dim columns a TMA box: one 128-byte
                           // swizzle row of f32

// Trips whose dK / dV (dq: dQ) products one tensor-core accumulator sums
// before it is added into the f32 running sums (0: the running sums are
// the accumulator; tools/torch_flash_bwd_probe.py builds other values to
// compare, see the header).
constexpr int kFold = 1;

// flash_bwd_dkdv_wgmma_f32_kernel's geometry. Shared memory from a
// 1024-byte aligned base: K hi, K lo, V hi, V lo (kBK x D each, K-major,
// 128-byte swizzled as TMA writes them); the split stages, each q hi, q lo,
// dO hi, dO lo (kBQ x D) and the transposed hi and lo tiles (D rows of
// 2 kBQ columns: q^T, then dO^T); the raw ring (q, then dO, as TMA loads
// them); per split stage the trip's lse (log2 units) and delta rows; the
// mbarriers. The raw K and V tiles land where the split stages go, once.
template <int D>
struct Dkdv {
  static constexpr int kBK = 64;                  // keys a block
  static constexpr int kBQ = D == 64 ? 32 : 16;   // query rows a trip
  static constexpr int kStages = D == 64 ? 2 : 1; // split stages
  static constexpr int kRaw = 2;                  // raw q / dO stages
  static constexpr int kThreads = 384;  // producer, dV and dK warpgroups
  static constexpr bool kKRegs = D == 64;  // K's parts as A fragments too
  static constexpr int kKPart = kBK * D * 4;
  static constexpr int kQPart = kBQ * D * 4;
  static constexpr int kTPart = D * 2 * kBQ * 4;
  static constexpr int kStage = 4 * kQPart + 2 * kTPart;
  static constexpr int kSplit = 4 * kKPart;
  static constexpr int kRawOff = kSplit + kStages * kStage;
  static constexpr int kRows = kRawOff + kRaw * 2 * kQPart;
  static constexpr int kBars = kRows + kStages * 2 * kBQ * 4;
  // parts, K/V full, raw full per raw stage, full and empty per stage
  static constexpr int kAlloc = kBars + 8 * (2 + kRaw + 2 * kStages) + 1024;
  static_assert(2 * kKPart <= kStages * kStage, "raw K and V do not fit");
  static_assert(kAlloc <= 232448, "over the block's shared memory");
};

// flash_bwd_dq_wgmma_f32_kernel's geometry: q hi, q lo, dO hi, dO lo
// (kBQ x D each); the split stages, each K hi, K lo, V hi, V lo (kBK x D)
// and one transposed tile (D rows of 2 kBK columns: K^T hi, then K^T lo);
// the raw ring (K, then V); the mbarriers. The raw q and dO tiles land
// where the split stages and the raw ring go, once.
template <int D>
struct Dq {
  static constexpr int kBQ = 64;                  // query rows a block
  static constexpr int kBK = D == 64 ? 32 : 16;   // keys a trip
  static constexpr int kStages = D == 64 ? 2 : 1;
  static constexpr int kRaw = 2;
  static constexpr int kThreads = 256;  // producer and one consumer
  static constexpr int kQPart = kBQ * D * 4;
  static constexpr int kKPart = kBK * D * 4;
  static constexpr int kTPart = D * 2 * kBK * 4;
  static constexpr int kStage = 4 * kKPart + kTPart;
  static constexpr int kSplit = 4 * kQPart;
  static constexpr int kRawOff = kSplit + kStages * kStage;
  static constexpr int kBars = kRawOff + kRaw * 2 * kKPart;
  static constexpr int kAlloc = kBars + 8 * (2 + kRaw + 2 * kStages) + 1024;
  static_assert(2 * kQPart <= kBars - kSplit, "raw q and dO do not fit");
  static_assert(kAlloc <= 232448, "over the block's shared memory");
};

// Byte offset of column `col` (a multiple of 8) in a K-major tile of
// `kRows` rows: where a k8 step that starts there reads.
template <int kRows>
__device__ __forceinline__ uint32_t kstep(int col) {
  return (col >> 5) * (kRows * 128) + ((col & 31) >> 3) * 32;
}

// The slot of index t in its 8-group of a transposed tile: 0 2 4 6 1 3 5
// 7. The accumulator holds indices 2u and 2u + 1 of each 8-group where a
// TF32 A fragment holds k slots u and u + 4 (u = lane & 3), so the
// transposed B operand stores index 2u at slot u and 2u + 1 at u + 4, and
// no register moves between lanes.
__device__ __forceinline__ int perm8(int t) {
  return (t & ~7) | ((t & 1) << 2) | ((t & 7) >> 1);
}

// Two raw (kRows x D) f32 tiles of one head, rows row0 on, of maps a and
// b, by TMA to dst and the next tile; the bytes complete on `bar`.
template <int kRows, int D>
__device__ __forceinline__ void load_pair(uint32_t dst, uint32_t bar,
                                          const CUtensorMap* a,
                                          const CUtensorMap* b, int head,
                                          int row0, int batch) {
  constexpr int kTile = kRows * D * 4;
  mbar_expect_tx(bar, 2 * kTile);
  for (int c = 0; c < D / kCols; ++c) {
    tma_load(dst + c * kRows * 128, a, bar, c * kCols, head, row0, batch);
    tma_load(dst + kTile + c * kRows * 128, b, bar, c * kCols, head, row0,
             batch);
  }
}

// x as its TF32 hi and lo parts: hi is x rounded to TF32, to nearest with
// ties away from zero (cvt.rna's rounding, done here on the integer pipe),
// and lo = x - hi, exact in f32. wgmma reads lo's top 19 bits; whatever it
// does with the other 13 costs at most 2^-11 of lo, 2^-22 of x, the size
// of the lo lo term the products drop. Two cvt.rna an element held the
// producer's split and the consumers' fragments back on the conversion
// pipe (tools/torch_flash_bwd_probe.py; PERF.md, PR 26).
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

// `bytes` of raw f32 as hi and lo parts at the same offsets; t: the thread
// in the producer warpgroup.
template <int kBytes>
__device__ __forceinline__ void split_same(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo, int t) {
  const float4* r = reinterpret_cast<const float4*>(raw);
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
  static_assert(kBytes % (16 * 128) == 0, "whole float4s a thread");
#pragma unroll 8
  for (int it = 0; it < kBytes / (16 * 128); ++it) {
    const int i = t + 128 * it;
    const float4 x = r[i];
    float4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    h4[i] = h;
    l4[i] = l;
  }
}

// A raw (kRows x D) tile as hi and lo parts at its own offsets, and
// transposed: element (row, d) also to row d, column th_col + perm8(row)
// of th (its hi) and tl_col + perm8(row) of tl (its lo), tiles of D rows.
// A warp takes consecutive rows at one 4-column chunk: its reads, its
// float4 writes (8 rows, 8 distinct chunks a phase) and its transposed
// writes (consecutive columns of one row, or of rows 4 apart whose
// swizzles differ) are free of bank conflicts.
template <int kRows, int D>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo, uint8_t* th,
                                           int th_col, uint8_t* tl,
                                           int tl_col, int t) {
  static_assert(kRows * D % (4 * 128) == 0, "whole float4s a thread");
#pragma unroll
  for (int it = 0; it < kRows * D / (4 * 128); ++it) {
    const int f = t + 128 * it;
    const int row = f % kRows;
    const int d0 = 4 * (f / kRows);
    const uint32_t off = swz<kRows>(row, d0);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    float h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
    const int col = perm8(row);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float*>(th + swz<D>(d0 + c, th_col + col)) = h[c];
      *reinterpret_cast<float*>(tl + swz<D>(d0 + c, tl_col + col)) = l[c];
    }
  }
}

// C (64 x N) = A B^T over D, A (64 rows) and B (N rows) K-major hi and lo
// parts in shared memory: per k8 step A_lo B_hi + A_hi B_lo + A_hi B_hi
// (the small terms first) into a fresh accumulator.
template <int N, int D>
__device__ __forceinline__ void product_ss(float (&c)[N / 2], uint32_t a_hi,
                                           uint32_t a_lo, uint32_t b_hi,
                                           uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t oa = kstep<64>(8 * kk);
    const uint32_t ob = kstep<N>(8 * kk);
    wgmma_ss_tf32<N>(c, desc_k_major(a_lo + oa), desc_k_major(b_hi + ob),
                     kk > 0);
    wgmma_ss_tf32<N>(c, desc_k_major(a_hi + oa), desc_k_major(b_lo + ob), 1);
    wgmma_ss_tf32<N>(c, desc_k_major(a_hi + oa), desc_k_major(b_hi + ob), 1);
  }
}

// C (64 x D) (+)= A B^T over K: A's hi and lo parts in registers (k8 step
// kk: hi[kk], lo[kk]); B (D rows, K-major) at columns c_hi + 8 kk of tile
// b_hi (its hi part) and c_lo + 8 kk of b_lo (its lo part). `fresh`: the
// first product overwrites C.
template <int D, int K>
__device__ __forceinline__ void product_rs(float (&c)[D / 2],
                                           const uint32_t (&hi)[K / 8][4],
                                           const uint32_t (&lo)[K / 8][4],
                                           uint32_t b_hi, int c_hi,
                                           uint32_t b_lo, int c_lo,
                                           bool fresh) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint64_t bh = desc_k_major(b_hi + kstep<D>(c_hi + 8 * kk));
    wgmma_rs_tf32<D>(c, lo[kk], bh, kk > 0 || !fresh);
    wgmma_rs_tf32<D>(c, hi[kk], desc_k_major(b_lo + kstep<D>(c_lo + 8 * kk)),
                     1);
    wgmma_rs_tf32<D>(c, hi[kk], bh, 1);
  }
}

// An accumulator fragment x (64 x K) as TF32 A fragments, hi and lo:
// register e of k8 step kk is row 8 (e & 1), index 2 (lane & 3) + (e >> 1)
// of the step's 8, x[4 kk + 2 (e & 1) + (e >> 1)] (B stores that index at
// slot (lane & 3) + 4 (e >> 1): perm8).
template <int K>
__device__ __forceinline__ void split_frags(const float (&x)[K / 2],
                                            uint32_t (&hi)[K / 8][4],
                                            uint32_t (&lo)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split(x[4 * kk + ((e & 1) << 1) + (e >> 1)], h, l);
      hi[kk][e] = __float_as_uint(h);
      lo[kk][e] = __float_as_uint(l);
    }
  }
}

// The fold: a tensor-core accumulator's f32 sums drop low bits of addends
// much smaller than the sum, so the running sums are f32 registers and
// each kFold trips' products go into a fresh accumulator first (`pick`:
// the accumulator the products go into).
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N], const float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += c[i];
}
template <int N>
__device__ __forceinline__ auto pick(float (&acc)[N], float (&fresh)[N])
    -> float (&)[N] {
  if constexpr (kFold > 0) {
    return fresh;
  } else {
    return acc;
  }
}

// What a dkdv block's consumers share: shared memory, the ring's
// barriers, the block's keys and trips.
struct DkdvBlock {
  uint32_t base;
  uint8_t* sbase;
  uint32_t full0, empty0;
  int k0, kvh, b, offset, first, n_per_head, n_trips;
};

// One dkdv consumer warpgroup over the block's trips: kDV sums dV += P^T
// dO (dO^T the B operand), else dK += dS^T q (q^T), and writes it (dK
// times D^-0.5) for keys < Sk to `out`, (B, Sk, K, DR) contiguous.
template <int DR, bool kDV>
__device__ __forceinline__ void dkdv_consumer(const DkdvBlock blk,
                                              uint32_t parts, const Shape& sh,
                                              float scale, float* out) {
  constexpr int D = tile_d(DR);
  using L = Dkdv<D>;
  const int t = threadIdx.x % 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  // accumulator fragment of S^T (keys x queries): element i of this
  // thread is key r0 + 8 ((i >> 1) & 1), query column 8 (i >> 2) + col0 +
  // (i & 1) of the trip
  const int r0 = blk.k0 + 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t k_hi = blk.base;
  const uint32_t k_lo = blk.base + L::kKPart;
  const uint32_t v_hi = blk.base + 2 * L::kKPart;
  const uint32_t v_lo = blk.base + 3 * L::kKPart;
  const float scale_log2 = scale * kLog2e;
  constexpr int tcol = kDV ? L::kBQ : 0;  // dO^T or q^T in the T tiles

  float acc[D / 2], fresh[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = fresh[i] = 0.f;

  mbar_wait(parts, 0);
  // at D 64 K's hi and lo parts also as register A fragments (S^T as RS
  // products: only q's parts read from shared memory): register e of k8
  // step kk is key 16 warp + (lane >> 2) + 8 (e & 1) of the block, column
  // 8 kk + (lane & 3) + 4 (e >> 1)
  uint32_t kfh[L::kKRegs ? D / 8 : 1][4], kfl[L::kKRegs ? D / 8 : 1][4];
  if constexpr (L::kKRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = swz<L::kBK>(16 * warp + (lane >> 2) + 8 * (e & 1),
                                         8 * kk + (lane & 3) + 4 * (e >> 1));
        kfh[kk][e] = *reinterpret_cast<const uint32_t*>(blk.sbase + off);
        kfl[kk][e] = *reinterpret_cast<const uint32_t*>(blk.sbase +
                                                        L::kKPart + off);
      }
    }
  }
  for (int j = 0; j < blk.n_trips; ++j) {
    const int s = j % L::kStages;
    const int q0 = (blk.first + j % blk.n_per_head) * L::kBQ;
    mbar_wait(blk.full0 + 8 * s, (j / L::kStages) & 1);
    const uint32_t qh = blk.base + L::kSplit + s * L::kStage;
    const uint32_t ql = qh + L::kQPart;
    const uint32_t dh = qh + 2 * L::kQPart;
    const uint32_t dl = qh + 3 * L::kQPart;
    const uint32_t th = qh + 4 * L::kQPart;
    const uint32_t tl = th + L::kTPart;
    const float* ls = reinterpret_cast<const float*>(
        blk.sbase + L::kRows + s * 2 * L::kBQ * 4);
    const float* ds = ls + L::kBQ;

    // S^T = K q^T (and, for dK, dP^T = V dO^T), two groups: P^T is
    // formed while dP^T is in flight
    float st[L::kBQ / 2], dpt[L::kBQ / 2];
    wgmma_fence();
    if constexpr (L::kKRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t ob = kstep<L::kBQ>(8 * kk);
        wgmma_rs_tf32<L::kBQ>(st, kfl[kk], desc_k_major(qh + ob), kk > 0);
        wgmma_rs_tf32<L::kBQ>(st, kfh[kk], desc_k_major(ql + ob), 1);
        wgmma_rs_tf32<L::kBQ>(st, kfh[kk], desc_k_major(qh + ob), 1);
      }
    } else {
      product_ss<L::kBQ, D>(st, k_hi, k_lo, qh, ql);
    }
    wgmma_commit();
    if constexpr (kDV) {
      wgmma_wait<0>();
    } else {
      product_ss<L::kBQ, D>(dpt, v_hi, v_lo, dh, dl);
      wgmma_commit();
      wgmma_wait<1>();
    }
    fence_regs(st);

    // P^T = exp2(S^T D^-0.5 log2(e) - lse), 0 where masked (only on
    // trips that cross the diagonal, Sq or Sk)
    const bool edge = blk.k0 + L::kBK - 1 > blk.offset + q0 ||
                      blk.k0 + L::kBK > sh.sk || q0 + L::kBQ > sh.sq;
#pragma unroll
    for (int i = 0; i < L::kBQ / 2; i += 2) {
      const int col = 8 * (i >> 2) + col0;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      float p0 = ex2(fmaf(st[i], scale_log2, -l2.x));
      float p1 = ex2(fmaf(st[i + 1], scale_log2, -l2.y));
      if (edge) {
        const int key = r0 + 8 * ((i >> 1) & 1);
        const int qpos = blk.offset + q0 + col;
        const bool kill = key >= sh.sk;
        if (kill || key > qpos || q0 + col >= sh.sq) p0 = 0.f;
        if (kill || key > qpos + 1 || q0 + col + 1 >= sh.sq) p1 = 0.f;
      }
      st[i] = p0;
      st[i + 1] = p1;
    }

    // the A operand: P^T (dV) or dS^T = P^T (dP^T - delta) (dK), as TF32
    // hi and lo fragments
    if constexpr (!kDV) {
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < L::kBQ / 2; i += 2) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(ds + 8 * (i >> 2) + col0);
        st[i] *= dpt[i] - d2.x;
        st[i + 1] *= dpt[i + 1] - d2.y;
      }
    }
    uint32_t xh[L::kBQ / 8][4], xl[L::kBQ / 8][4];
    split_frags<L::kBQ>(st, xh, xl);

    // dV (+)= P^T dO with dO^T, or dK (+)= dS^T q with q^T, the K-major B
    // operand of the transposed tiles
    float(&c)[D / 2] = pick(acc, fresh);
    wgmma_fence();
    product_rs<D, L::kBQ>(c, xh, xl, th, tcol, tl, tcol,
                          kFold > 0 && j % kFold == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(c);
    __syncwarp();
    if (lane == 0) mbar_arrive(blk.empty0 + 8 * s);
    if (kFold > 0 && ((j + 1) % kFold == 0 || j + 1 == blk.n_trips)) {
      fold(acc, fresh);
    }
  }

  const float mul = kDV ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= sh.sk) continue;
    float* row = out + ((static_cast<long long>(blk.b) * sh.sk + key) *
                            sh.n_kv_heads + blk.kvh) * DR;
#pragma unroll
    for (int jb = 0; jb < DR / 8; ++jb) {
      const int i = 4 * jb + 2 * r;
      *reinterpret_cast<float2*>(row + 8 * jb + col0) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// blockIdx.x -> (key tile, KV head, batch), key tile 0 (the most query
// tiles) first (kernels/flash_attention.py: BwdPlan). Warpgroup 0 the
// producer, 1 dV, 2 dK.
template <int DR>
__global__ void __launch_bounds__(Dkdv<tile_d(DR)>::kThreads, 1)
flash_bwd_dkdv_wgmma_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap dmap,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk,
                                float* __restrict__ dv, Shape sh,
                                float scale) {
  constexpr int D = tile_d(DR);
  using L = Dkdv<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t parts = base + L::kBars;            // K and V split
  const uint32_t kv_full = parts + 8;                // raw K and V loaded
  const uint32_t raw0 = kv_full + 8;                 // raw[r] = raw0 + 8 r
  const uint32_t full0 = raw0 + 8 * L::kRaw;         // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * L::kStages;    // empty[s]

  const int per = sh.n_kv_heads * sh.batch;
  const int kvh = static_cast<int>(blockIdx.x) % per % sh.n_kv_heads;
  const int b = static_cast<int>(blockIdx.x) % per / sh.n_kv_heads;
  const int k0 = static_cast<int>(blockIdx.x) / per * L::kBK;
  const int offset = sh.sk - sh.sq;
  const int n_q_tiles = (sh.sq + L::kBQ - 1) / L::kBQ;
  // the first query tile that sees a key of the block; then every tile
  // to the last, for each of the G query heads of the KV head
  const int first = max(k0 - offset, 0) / L::kBQ;
  const int n_per_head = n_q_tiles - first;
  const int n_trips = sh.group * n_per_head;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(parts, 128);
    mbar_init(kv_full, 1);
    for (int r = 0; r < L::kRaw; ++r) mbar_init(raw0 + 8 * r, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: thread 0 issues the TMA loads; all 128 threads split K
    // and V once, then each trip's q and dO, and copy its lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    const int t = threadIdx.x;
    const auto trip_head = [&](int j) {
      return kvh * sh.group + j / n_per_head;
    };
    const auto trip_q0 = [&](int j) {
      return (first + j % n_per_head) * L::kBQ;
    };
    const auto load_raw = [&](int j) {
      const int r = j % L::kRaw;
      load_pair<L::kBQ, D>(base + L::kRawOff + r * 2 * L::kQPart,
                           raw0 + 8 * r, &qmap, &dmap, trip_head(j),
                           trip_q0(j), b);
    };
    if (t == 0) {
      load_pair<L::kBK, D>(base + L::kSplit, kv_full, &kmap, &vmap, kvh, k0,
                           b);
      for (int j = 0; j < min(L::kRaw, n_trips); ++j) load_raw(j);
    }
    mbar_wait(kv_full, 0);
    split_same<L::kKPart>(sbase + L::kSplit, sbase, sbase + L::kKPart, t);
    split_same<L::kKPart>(sbase + L::kSplit + L::kKPart,
                          sbase + 2 * L::kKPart, sbase + 3 * L::kKPart, t);
    fence_async_smem();
    mbar_arrive(parts);
    bar_sync(1, 128);  // raw K and V read before stage 0 is written
    for (int j = 0; j < n_trips; ++j) {
      const int r = j % L::kRaw;
      const int s = j % L::kStages;
      mbar_wait(raw0 + 8 * r, (j / L::kRaw) & 1);
      mbar_wait(empty0 + 8 * s, ((j / L::kStages) & 1) ^ 1);
      uint8_t* st = sbase + L::kSplit + s * L::kStage;
      uint8_t* th = st + 4 * L::kQPart;
      const uint8_t* rq = sbase + L::kRawOff + r * 2 * L::kQPart;
      split_tile<L::kBQ, D>(rq, st, st + L::kQPart, th, 0, th + L::kTPart, 0,
                            t);
      split_tile<L::kBQ, D>(rq + L::kQPart, st + 2 * L::kQPart,
                            st + 3 * L::kQPart, th, L::kBQ, th + L::kTPart,
                            L::kBQ, t);
      if (t < L::kBQ) {
        const int q0 = trip_q0(j);
        const long long rows =
            (static_cast<long long>(b) * sh.n_heads + trip_head(j)) * sh.sq;
        float* ls = reinterpret_cast<float*>(sbase + L::kRows +
                                             s * 2 * L::kBQ * 4);
        const bool ok = q0 + t < sh.sq;
        ls[t] = ok ? lse[rows + q0 + t] * kLog2e : 0.f;
        ls[L::kBQ + t] = ok ? delta[rows + q0 + t] : 0.f;
      }
      fence_async_smem();
      mbar_arrive(full0 + 8 * s);
      if (j + L::kRaw < n_trips) {
        bar_sync(1, 128);  // every producer thread is done with raw r
        if (t == 0) load_raw(j + L::kRaw);
      }
    }
  } else {
    // consumers: both own the block's 64 keys as the M side; warpgroup 1
    // sums dV += P^T dO, warpgroup 2 dK += dS^T q (each forms P^T). Each
    // runs its own instantiation: no wgmma register is defined on a path
    // that differs between them (ptxas would serialize the products)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    const DkdvBlock blk{base, sbase, full0, empty0, k0, kvh, b, offset,
                        first, n_per_head, n_trips};
    if (wgi == 1) {
      dkdv_consumer<DR, true>(blk, parts, sh, scale, dv);
    } else {
      dkdv_consumer<DR, false>(blk, parts, sh, scale, dk);
    }
  }
}

// blockIdx.x -> (64-row query tile, head, batch): the last query tile
// first over every head and batch (the forward's launch_order at 64 rows).
template <int DR>
__global__ void __launch_bounds__(Dq<tile_d(DR)>::kThreads, 1)
flash_bwd_dq_wgmma_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap dmap,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, Shape sh,
                              float scale) {
  constexpr int D = tile_d(DR);
  using L = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t parts = base + L::kBars;            // q and dO split
  const uint32_t q_full = parts + 8;                 // raw q and dO loaded
  const uint32_t raw0 = q_full + 8;                  // raw[r] = raw0 + 8 r
  const uint32_t full0 = raw0 + 8 * L::kRaw;         // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * L::kStages;    // empty[s]

  const int per = sh.n_heads * sh.batch;
  const int n_q_tiles = (sh.sq + L::kBQ - 1) / L::kBQ;
  const int qt = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = static_cast<int>(blockIdx.x) % per % sh.n_heads;
  const int b = static_cast<int>(blockIdx.x) % per / sh.n_heads;
  const int q0 = qt * L::kBQ;
  const int offset = sh.sk - sh.sq;
  // causal trip count: the key tiles up to the block's last row's position
  const int q_last = offset + min(q0 + L::kBQ, sh.sq) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min(q_last / L::kBK + 1, (sh.sk + L::kBK - 1) / L::kBK);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(parts, 128);
    mbar_init(q_full, 1);
    for (int r = 0; r < L::kRaw; ++r) mbar_init(raw0 + 8 * r, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: thread 0 issues the TMA loads; all 128 threads split q and
    // dO once, then each trip's K (also transposed) and V
    const int t = threadIdx.x;
    const int kvh = h / sh.group;
    if (n_tiles > 0) {
      if (t == 0) {
        load_pair<L::kBQ, D>(base + L::kSplit, q_full, &qmap, &dmap, h, q0,
                             b);
      }
      mbar_wait(q_full, 0);
      split_same<L::kQPart>(sbase + L::kSplit, sbase, sbase + L::kQPart, t);
      split_same<L::kQPart>(sbase + L::kSplit + L::kQPart,
                            sbase + 2 * L::kQPart, sbase + 3 * L::kQPart, t);
      fence_async_smem();
      mbar_arrive(parts);
      bar_sync(1, 128);  // raw q and dO read before the ring is written
      const auto load_raw = [&](int j) {
        const int r = j % L::kRaw;
        load_pair<L::kBK, D>(base + L::kRawOff + r * 2 * L::kKPart,
                             raw0 + 8 * r, &kmap, &vmap, kvh, j * L::kBK, b);
      };
      if (t == 0) {
        for (int j = 0; j < min(L::kRaw, n_tiles); ++j) load_raw(j);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int r = j % L::kRaw;
        const int s = j % L::kStages;
        mbar_wait(raw0 + 8 * r, (j / L::kRaw) & 1);
        mbar_wait(empty0 + 8 * s, ((j / L::kStages) & 1) ^ 1);
        uint8_t* st = sbase + L::kSplit + s * L::kStage;
        uint8_t* tt = st + 4 * L::kKPart;
        const uint8_t* rk = sbase + L::kRawOff + r * 2 * L::kKPart;
        split_tile<L::kBK, D>(rk, st, st + L::kKPart, tt, 0, tt, L::kBK, t);
        split_same<L::kKPart>(rk + L::kKPart, st + 2 * L::kKPart,
                              st + 3 * L::kKPart, t);
        fence_async_smem();
        mbar_arrive(full0 + 8 * s);
        if (j + L::kRaw < n_tiles) {
          bar_sync(1, 128);  // every producer thread is done with raw r
          if (t == 0) load_raw(j + L::kRaw);
        }
      }
    }
  } else {
    // the consumer: the block's 64 query rows as the M side
    const int t = threadIdx.x - 128;
    const int warp = t >> 5;
    const int lane = t & 31;
    // accumulator fragment of S (rows x keys): element i of this thread is
    // row r0 + 8 ((i >> 1) & 1), key column 8 (i >> 2) + col0 + (i & 1)
    const int r0 = q0 + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t q_hi = base;
    const uint32_t q_lo = base + L::kQPart;
    const uint32_t do_hi = base + 2 * L::kQPart;
    const uint32_t do_lo = base + 3 * L::kQPart;
    const float scale_log2 = scale * kLog2e;
    const long long rows =
        (static_cast<long long>(b) * sh.n_heads + h) * sh.sq;
    float lr[2], dr[2];  // the rows' lse (log2 units) and delta, 0 past Sq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lr[r] = row < sh.sq ? lse[rows + row] * kLog2e : 0.f;
      dr[r] = row < sh.sq ? delta[rows + row] : 0.f;
    }

    float acc[D / 2], fresh[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = fresh[i] = 0.f;

    if (n_tiles > 0) mbar_wait(parts, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::kStages;
      const int k0 = j * L::kBK;
      mbar_wait(full0 + 8 * s, (j / L::kStages) & 1);
      const uint32_t kh = base + L::kSplit + s * L::kStage;
      const uint32_t kl = kh + L::kKPart;
      const uint32_t vh = kh + 2 * L::kKPart;
      const uint32_t vl = kh + 3 * L::kKPart;
      const uint32_t tt = kh + 4 * L::kKPart;

      // S = q K^T and dP = dO V^T, two groups: P is formed while dP is in
      // flight
      float sc[L::kBK / 2], dp[L::kBK / 2];
      wgmma_fence();
      product_ss<L::kBK, D>(sc, q_hi, q_lo, kh, kl);
      wgmma_commit();
      product_ss<L::kBK, D>(dp, do_hi, do_lo, vh, vl);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P = exp2(S D^-0.5 log2(e) - lse), 0 where masked (only on tiles
      // that cross the diagonal or Sk)
      const bool edge = k0 + L::kBK - 1 > offset + q0 || k0 + L::kBK > sh.sk;
#pragma unroll
      for (int i = 0; i < L::kBK / 2; i += 2) {
        const int r = (i >> 1) & 1;
        float p0 = ex2(fmaf(sc[i], scale_log2, -lr[r]));
        float p1 = ex2(fmaf(sc[i + 1], scale_log2, -lr[r]));
        if (edge) {
          const int key = k0 + 8 * (i >> 2) + col0;
          const int qpos = offset + r0 + 8 * r;
          if (key > qpos || key >= sh.sk) p0 = 0.f;
          if (key + 1 > qpos || key + 1 >= sh.sk) p1 = 0.f;
        }
        sc[i] = p0;
        sc[i + 1] = p1;
      }
      wgmma_wait<0>();
      fence_regs(dp);

      // dS = P (dP - delta), as TF32 hi and lo fragments
#pragma unroll
      for (int i = 0; i < L::kBK / 2; ++i) {
        dp[i] = sc[i] * (dp[i] - dr[(i >> 1) & 1]);
      }
      uint32_t xh[L::kBK / 8][4], xl[L::kBK / 8][4];
      split_frags<L::kBK>(dp, xh, xl);

      // dQ (+)= dS K, K^T (hi, then lo) the K-major B operand
      float(&c)[D / 2] = pick(acc, fresh);
      wgmma_fence();
      product_rs<D, L::kBK>(c, xh, xl, tt, 0, tt, L::kBK,
                            kFold > 0 && j % kFold == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(c);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (kFold > 0 && ((j + 1) % kFold == 0 || j + 1 == n_tiles)) {
        fold(acc, fresh);
      }
    }

    // dQ (times D^-0.5) of rows < Sq, (B, Sq, H, DR) contiguous; rows that
    // see no key get 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sh.sq) continue;
      float* out =
          dq + ((static_cast<long long>(b) * sh.sq + row) * sh.n_heads + h) *
                   DR;
#pragma unroll
      for (int jb = 0; jb < DR / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        *reinterpret_cast<float2*>(out + 8 * jb + col0) =
            make_float2(acc[i] * scale, acc[i + 1] * scale);
      }
    }
  }
}

}  // namespace tf

// ---------------------------------------------------------------------------
// The short-sequence kernels (D = 8, 16 and 32, bf16 and f32): mma.sync
// ---------------------------------------------------------------------------

namespace mb {

using namespace hopper::strip;
using hopper::bits;
using hopper::ex2;
using hopper::smem_u32;
using hopper::tf32;

// x0, x1 as two bf16 parts each, packed as A-fragment registers: hi =
// bf16(x), lo = bf16(x - hi), hi + lo = x to 2^-17.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// x as the TF32 operands of three products: hi = tf32(x), lo = tf32(x -
// hi); hi + lo is x to 2^-22 of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// c = A B^T (16 x 32, f32, 4 n8 accumulators): A the warp's 16 strip rows
// at `a`, B the 32 rows of a tile at `b` (shared addresses, rows of D
// elements padded to Rows::kRS), both as stored (the row the M or N side,
// the head dim the depth). bf16: D/16 k16 steps of one product (the
// operands are bf16 inputs: exact in f32); at D 8 the step reads the 8
// zero columns of the padding. f32: D/8 k8 steps of three TF32 products of
// the operands' hi and lo parts, the smallest first (f32 precision; A_lo
// B_lo, 2^-22 of A B, dropped). Fragments by ldmatrix as the forward's:
// lane (g, t) gets row g, elements 2t, 2t + 1 (bf16) or t (f32) of each
// 8x8 matrix.
template <typename T, int D>
__device__ __forceinline__ void logits(float (&c)[4][4], uint32_t a,
                                       uint32_t b, int lane) {
  using R = Rows<T, D>;
  constexpr int kRS = R::kRS;
  zero(c);
  const int ra = (lane & 7) + (((lane >> 3) & 1) << 3);
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t x[4], ah[4], al[4];
      ldsm_x4(x, a + 4 * (ra * kRS + kk * 8 + (lane >> 4) * 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(__uint_as_float(x[e]), ah[e], al[e]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t y[4], bh[4], bl[4];
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 8 + (((lane >> 3) & 1) << 2);
        ldsm_x4(y, b + 4 * (row * kRS + col));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(y[e]), bh[e], bl[e]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float(&cc)[4] = c[2 * np + n];
          mma_tf32(cc, al, bh[2 * n], bh[2 * n + 1]);
          mma_tf32(cc, ah, bl[2 * n], bl[2 * n + 1]);
          mma_tf32(cc, ah, bh[2 * n], bh[2 * n + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk) {
      uint32_t x[4];
      ldsm_x4(x, a + 2 * (ra * kRS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t y[4];
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + (((lane >> 3) & 1) << 3);
        ldsm_x4(y, b + 2 * (row * kRS + col));
        mma_bf16(c[2 * np], x, y[0], y[1]);
        mma_bf16(c[2 * np + 1], x, y[2], y[3]);
      }
    }
  }
}

// c += X Y (16 x D, D/8 n8 accumulators): X (16 x 32, f32) in the
// accumulator layout of `logits`, Y the 32 rows of a tile (D columns) at
// shared address `y` (f32: also `ys`, the same tile as a pointer), the
// tile's row the depth. bf16: per 16 rows X's A fragment as two bf16
// parts (each its own product, f32 precision) and Y by ldmatrix.trans. f32:
// per 8 rows X's A fragment is the accumulator of n8 tile kk as c0, c2, c1,
// c3 (k slot t is row 2t, t + 4 row 2t + 1), so Y's B fragment is rows 2t
// and 2t + 1 at column g (scalar shared loads, no register moved between
// lanes), three TF32 products each.
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&c)[D / 8][4],
                                           const float (&x)[4][4], uint32_t y,
                                           const T* ys, int lane) {
  using R = Rows<T, D>;
  constexpr int kRS = R::kRS;
  if constexpr (std::is_same_v<T, float>) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(x[kk][0], ah[0], al[0]);
      split_tf32(x[kk][2], ah[1], al[1]);
      split_tf32(x[kk][1], ah[2], al[2]);
      split_tf32(x[kk][3], ah[3], al[3]);
      const float* y0 = ys + (8 * kk + 2 * t) * kRS + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t bh[2], bl[2];
        split_tf32(y0[8 * dn], bh[0], bl[0]);
        split_tf32(y0[kRS + 8 * dn], bh[1], bl[1]);
        mma_tf32(c[dn], al, bh[0], bh[1]);
        mma_tf32(c[dn], ah, bl[0], bl[1]);
        mma_tf32(c[dn], ah, bh[0], bh[1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* xc = x[2 * kk + (e >> 1)];
        const int r = e & 1;
        split_bf16(xc[2 * r], xc[2 * r + 1], hi[e], lo[e]);
      }
#pragma unroll
      for (int dp = 0; dp < (D + 15) / 16; ++dp) {
        uint32_t b[4];
        const int row = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = dp * 16 + ((lane >> 4) << 3);
        ldsm_x4_t(b, y + 2 * (row * kRS + col));
        mma_bf16(c[2 * dp], lo, b[0], b[1]);
        mma_bf16(c[2 * dp], hi, b[0], b[1]);
        if constexpr (D >= 16) {
          mma_bf16(c[2 * dp + 1], lo, b[2], b[3]);
          mma_bf16(c[2 * dp + 1], hi, b[2], b[3]);
        }
      }
    }
  }
}

// acc += c, f32 adds (the tensor cores' sums drop low bits of addends
// much smaller than the sum: each trip's products go into a fresh c)
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N][4],
                                     const float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += c[i][e];
  }
}

// The warp's 16 x D result (rows row0 + g and row0 + g + 8 of the
// accumulators, times mul) to out, rows of D elements `rs` apart, rows <
// n_rows only.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, long long rs,
                                           const float (&acc)[D / 8][4],
                                           float mul, int row0, int n_rows,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    T* o = out + row * rs + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float x0 = acc[dt][2 * r] * mul, x1 = acc[dt][2 * r + 1] * mul;
      if constexpr (std::is_same_v<T, float>) {
        *reinterpret_cast<float2*>(o + 8 * dt) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * dt) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// Shared memory of the dq kernel, bytes: the block's q rows, then its dO
// rows (as the forward's q region each), then per stage the K tiles of the
// KV heads and their V tiles (the forward's stage).
__host__ __device__ constexpr int dq_smem(int d, int es, int warps, int hb,
                                          int nkv, int stages) {
  return smem_bytes(d, es, warps, hb, nkv, stages) +
         es * q_elems(d + kVecBytes / es, warps, hb, kVecBytes / es);
}

// Shared memory of the dkdv kernel, bytes: the block's K strip rows, its V
// strip rows, per stage the q tiles of the hb query heads of a trip and
// their dO tiles, then per stage those heads' lse (log2 units) and delta
// rows (f32, kBK each).
__host__ __device__ constexpr int dkdv_smem(int d, int es, int warps, int hb,
                                            int stages) {
  return smem_bytes(d, es, warps, hb, hb, stages) +
         es * q_elems(d + kVecBytes / es, warps, hb, kVecBytes / es) +
         stages * 2 * hb * kBK * 4;
}

// dQ_i = D^-0.5 sum_j dS_ij k_j of a 16-row query strip of one (head,
// batch) a warp, packed as the forward's (hopper.cuh: unit_of;
// kernels/flash_attention.py: mma_units): the block copies its q and dO
// rows once, then each 32-key K and V tile of its KV heads through two
// stages (one where a strip visits one tile). Per tile a warp forms S = q
// K^T and dP = dO V^T (`logits`), P = exp2(S D^-0.5 log2(e) - lse) and dS
// = P (dP - delta) in f32 on the accumulators (0 where masked, only on
// tiles that cross the diagonal or Sk), and dQ += dS K (`accumulate`, K
// the tile), into a fresh accumulator folded into the f32 sums.
template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Shape sh, Pack pk, Strides qst, Strides kst,
                        Strides vst, Strides dst, float scale) {
  using R = Rows<T, D>;
  constexpr int kRS = R::kRS;
  constexpr int kEs = R::kEs;
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  const uint32_t sbase = smem_u32(sm);

  const int warps = pk.sb * pk.hb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Unit u = unit_of(pk, sh.batch, sh.group, sh.sq, sh.sk, warp);
  const int offset = sh.sk - sh.sq;
  const int q_sz = q_elems(kRS, warps, pk.hb, R::kVec);
  const int tile_sz = tile_elems(kRS, R::kVec);
  const int stage_sz = 2 * pk.nkv * tile_sz;
  const uint32_t q_warp = sbase + kEs * (warp * kRows * kRS + u.hw * R::kVec);
  const uint32_t do_warp = q_warp + kEs * q_sz;

  if constexpr (kEs == 2 && D % 16 != 0) {
    // the padding pieces that the k16 steps read as head-dim columns
    const int n = dq_smem(D, 2, warps, pk.hb, pk.nkv, pk.stages) / 16;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }
  copy_q<T, D>(sbase, q, u, pk, qst, sh.sq);
  copy_q<T, D>(sbase + kEs * q_sz, dO, u, pk, dst, sh.sq);
  if (u.n_tiles > 0) {
    copy_kv<T, D>(sbase + kEs * 2 * q_sz, k, v, u, pk, kst, vst, 0, sh.sk,
                  tile_sz);
  }
  cp_commit();

  // the rows' lse (log2 units) and delta, 0 past Sq
  const int h = u.h0 + u.hw;
  const long long rows =
      (static_cast<long long>(u.b) * sh.n_heads + h) * sh.sq;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = u.row0 + g + 8 * r;
    lr[r] = row < sh.sq ? lse[rows + row] * kLog2e : 0.f;
    dr[r] = row < sh.sq ? delta[rows + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < u.n_tiles; ++j) {
    if (j + 1 < u.n_tiles) {
      copy_kv<T, D>(sbase + kEs * (2 * q_sz + ((j + 1) & 1) * stage_sz), k,
                    v, u, pk, kst, vst, j + 1, sh.sk, tile_sz);
    }
    cp_commit();
    cp_wait<1>();     // every group but the newest: tile j (and q, dO)
    __syncthreads();
    if (j < u.my_trips) {
      const int kt_el = 2 * q_sz + (j & 1) * stage_sz + u.kvi * tile_sz;
      const uint32_t kt = sbase + kEs * kt_el;
      const uint32_t vt = kt + kEs * pk.nkv * tile_sz;
      float sc[4][4], dp[4][4];
      logits<T, D>(sc, q_warp, kt, lane);
      logits<T, D>(dp, do_warp, vt, lane);
      const int k0 = j * kBK;
      const int row_pos = offset + u.row0;
      const bool edge = k0 + kBK - 1 > row_pos || k0 + kBK > sh.sk;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          float p = ex2(fmaf(sc[nt][i], scale_log2, -lr[r]));
          if (edge) {
            const int key = k0 + 8 * nt + 2 * t + (i & 1);
            if (key > row_pos + g + 8 * r || key >= sh.sk) p = 0.f;
          }
          dp[nt][i] = p * (dp[nt][i] - dr[r]);
        }
      }
      float c[D / 8][4];
      zero(c);
      accumulate<T, D>(c, dp, kt, sm + kt_el, lane);
      fold(acc, c);
    }
    if (j + 1 < u.n_tiles) __syncthreads();  // stage j & 1 read by all
  }
  cp_wait<0>();

  // dQ (times D^-0.5) of rows < Sq, (B, Sq, H, D) contiguous; rows that
  // see no key get 0
  store_rows<T, D>(dq + (static_cast<long long>(u.b) * sh.sq * sh.n_heads +
                         h) * D,
                   static_cast<long long>(sh.n_heads) * D, acc, scale,
                   u.row0, sh.sq, lane);
}

// dK_j = D^-0.5 sum_i dS_ij q_i and dV_j = sum_i P_ij dO_i of a 16-key
// strip of one (KV head, batch) a warp. A block packs sb consecutive key
// strips of hb consecutive KV heads of one batch element
// (kernels/flash_attention.py: mma_bwd_plan); blockIdx.x -> (strip group
// x / (n_hg B), head group x % (n_hg B) % n_hg, batch x % (n_hg B) / n_hg),
// strip group 0 (the most query tiles) first; warp w takes strip w % sb of
// KV head w / sb. The block copies its K and V strips once, then, for each
// of the G query heads of its KV heads and each 32-row query tile from the
// first that sees one of its keys (a trip), the hb query heads' q and dO
// tiles and their lse and delta rows, through two stages (one where the
// plan has one trip). Per trip a warp forms S^T = K q^T and dP^T = V dO^T
// with its keys as the M side (`logits`), P^T and dS^T = P^T (dP^T -
// delta) on the accumulators (0 where masked), and dV += P^T dO, dK +=
// dS^T q (`accumulate`, dO and q the tiles), each into a fresh accumulator
// folded into the f32 sums. A trip where the warp's keys follow every
// query is skipped.
template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, Shape sh,
                          Pack pk, Strides qst, Strides kst, Strides vst,
                          Strides dst, float scale) {
  using R = Rows<T, D>;
  constexpr int kRS = R::kRS;
  constexpr int kEs = R::kEs;
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  const uint32_t sbase = smem_u32(sm);

  const int warps = pk.sb * pk.hb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the block's keys and KV heads (Unit's rows are keys here, its heads
  // KV heads; the trip's query heads are (kv0 + i) G + gi)
  Unit u;
  const int per = pk.n_hg * sh.batch;
  const int bid = static_cast<int>(blockIdx.x);
  u.h0 = u.kv0 = bid % per % pk.n_hg * pk.hb;
  u.b = bid % per / pk.n_hg;
  u.nkv = pk.hb;
  u.rows = pk.sb * kRows;
  u.row_blk = bid / per * u.rows;
  u.hw = u.kvi = warp / pk.sb;
  u.row0 = u.row_blk + (warp % pk.sb) * kRows;
  u.my_trips = u.n_tiles = 0;
  const int offset = sh.sk - sh.sq;
  const int n_q_tiles = (sh.sq + kBK - 1) / kBK;
  const int first = max(u.row_blk - offset, 0) / kBK;
  const int n_per_head = n_q_tiles - first;
  const int n_trips = sh.group * n_per_head;

  const int q_sz = q_elems(kRS, warps, pk.hb, R::kVec);
  const int tile_sz = tile_elems(kRS, R::kVec);
  const int stage_sz = 2 * pk.hb * tile_sz;
  const int strip_el = warp * kRows * kRS + u.hw * R::kVec;
  const uint32_t k_warp = sbase + kEs * strip_el;
  const uint32_t v_warp = k_warp + kEs * q_sz;
  float* lsd = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(sm) +
      kEs * (2 * q_sz + pk.stages * stage_sz));

  if constexpr (kEs == 2 && D % 16 != 0) {
    const int n = dkdv_smem(D, 2, warps, pk.hb, pk.stages) / 16;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }
  // trip j's q and dO tiles (cp.async) and its lse and delta rows (plain
  // stores, read after the barrier that follows the stage's wait) into
  // stage `st`
  const auto load_trip = [&](int j, int st) {
    const int gi = j / n_per_head;
    const int jt = first + j % n_per_head;
    copy_kv<T, D>(sbase + kEs * (2 * q_sz + st * stage_sz),
                  q + gi * qst.h, dO + gi * dst.h, u, pk,
                  Strides{qst.b, qst.s, qst.h * sh.group},
                  Strides{dst.b, dst.s, dst.h * sh.group}, jt, sh.sq,
                  tile_sz);
    float* ls = lsd + st * 2 * pk.hb * kBK;
    for (int c = threadIdx.x; c < pk.hb * kBK; c += blockDim.x) {
      const int row = jt * kBK + c % kBK;
      const int head = (u.h0 + c / kBK) * sh.group + gi;
      const long long at =
          (static_cast<long long>(u.b) * sh.n_heads + head) * sh.sq + row;
      const bool ok = row < sh.sq;
      ls[c] = ok ? lse[at] * kLog2e : 0.f;
      ls[pk.hb * kBK + c] = ok ? delta[at] : 0.f;
    }
  };
  copy_q<T, D>(sbase, k, u, pk, kst, sh.sk);
  copy_q<T, D>(sbase + kEs * q_sz, v, u, pk, vst, sh.sk);
  load_trip(0, 0);
  cp_commit();

  const float scale_log2 = scale * kLog2e;
  float acc_k[D / 8][4], acc_v[D / 8][4];
  zero(acc_k);
  zero(acc_v);

  for (int j = 0; j < n_trips; ++j) {
    if (j + 1 < n_trips) load_trip(j + 1, (j + 1) & 1);
    cp_commit();
    cp_wait<1>();     // every group but the newest: trip j (and K, V)
    __syncthreads();
    const int s = j & 1;
    const int q0 = (first + j % n_per_head) * kBK;
    if (u.row0 < sh.sk && u.row0 <= offset + min(q0 + kBK, sh.sq) - 1) {
      const int qt_el = 2 * q_sz + s * stage_sz + u.hw * tile_sz;
      const int dt_el = qt_el + pk.hb * tile_sz;
      const float* ls = lsd + s * 2 * pk.hb * kBK + u.hw * kBK;
      const float* ds = ls + pk.hb * kBK;
      float st[4][4], dpt[4][4];
      logits<T, D>(st, k_warp, sbase + kEs * qt_el, lane);
      logits<T, D>(dpt, v_warp, sbase + kEs * dt_el, lane);
      const bool edge = u.row0 + kRows - 1 > offset + q0 ||
                        u.row0 + kRows > sh.sk || q0 + kBK > sh.sq;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * nt + 2 * t + (i & 1);
          float p = ex2(fmaf(st[nt][i], scale_log2, -ls[col]));
          if (edge) {
            const int key = u.row0 + g + 8 * (i >> 1);
            if (key >= sh.sk || key > offset + q0 + col ||
                q0 + col >= sh.sq) {
              p = 0.f;
            }
          }
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - ds[col]);
        }
      }
      float c[D / 8][4];
      zero(c);
      accumulate<T, D>(c, st, sbase + kEs * dt_el, sm + dt_el, lane);
      fold(acc_v, c);
      zero(c);
      accumulate<T, D>(c, dpt, sbase + kEs * qt_el, sm + qt_el, lane);
      fold(acc_k, c);
    }
    if (j + 1 < n_trips) __syncthreads();  // stage j & 1 read by all
  }
  cp_wait<0>();

  // dK (times D^-0.5) and dV of keys < Sk, (B, Sk, K, D) contiguous
  const long long at =
      (static_cast<long long>(u.b) * sh.sk * sh.n_kv_heads + u.h0 + u.hw) * D;
  const long long rs = static_cast<long long>(sh.n_kv_heads) * D;
  store_rows<T, D>(dk + at, rs, acc_k, scale, u.row0, sh.sk, lane);
  store_rows<T, D>(dv + at, rs, acc_v, 1.f, u.row0, sh.sk, lane);
}

}  // namespace mb

// plan (kernels/flash_attention.py: BwdPlan.args), 114 values, 125 for
// the mma designs: batch, sq, sk, n_heads, n_kv_heads, d, dtype (0 f32, 1
// bf16), the dkdv kernel's query tiles and key tiles (mma: 32-row query
// tiles and 16-key strips), the (batch, seq, head) element strides of q,
// k, v, o and dO, the design (0: the f32 wgmma kernels, 1: the bf16 ones,
// at d 64, 112 and 128; 2: the f32 mma kernels, 3: the bf16 ones, at d 8,
// 16 and 32; it must be the dtype's and d's), the dq kernel's query tiles
// (mma: 16-row strips), then the TMA maps of q, k, v and dO for the dkdv
// kernel and again for the dq kernel, 11 values each (zeros for the mma
// designs); the mma designs append dkdv's packing (strips and KV heads a
// block, stages, blocks, shared-memory bytes) and dq's (strips and heads a
// block, KV heads a block, stages, blocks, shared-memory bytes)
constexpr int kPlanMaps = 26;
constexpr int kMapLongs = 11;
constexpr int kPlanMma = kPlanMaps + 8 * kMapLongs;

struct Args {
  Shape sh;
  int d, dtype, n_q_tiles, n_k_tiles, design, dq_q_tiles;
  Strides qst, kst, vst, ost, dst;
};

bool wide(int d) { return d == 64 || d == 112 || d == 128; }

// (dkdv query rows a trip, dkdv keys a block, dq query rows a block) of a
// design at D (the tile's D)
template <int D>
void tiles(int design, int& bq, int& bk, int& dq_bq) {
  if (design == 0) {
    bq = tf::Dkdv<D>::kBQ;
    bk = tf::Dkdv<D>::kBK;
    dq_bq = tf::Dq<D>::kBQ;
  } else {
    bq = wg::Dkdv<D>::kBQ;
    bk = wg::Dkdv<D>::kBK;
    dq_bq = wg::Dq<D>::kBQ;
  }
}

bool parse(const long long* p, Args& a) {
  a.sh = Shape{static_cast<int>(p[0]), static_cast<int>(p[1]),
               static_cast<int>(p[2]), static_cast<int>(p[3]),
               static_cast<int>(p[4]), 0};
  a.d = static_cast<int>(p[5]);
  a.dtype = static_cast<int>(p[6]);
  a.n_q_tiles = static_cast<int>(p[7]);
  a.n_k_tiles = static_cast<int>(p[8]);
  a.qst = Strides{p[9], p[10], p[11]};
  a.kst = Strides{p[12], p[13], p[14]};
  a.vst = Strides{p[15], p[16], p[17]};
  a.ost = Strides{p[18], p[19], p[20]};
  a.dst = Strides{p[21], p[22], p[23]};
  a.design = static_cast<int>(p[24]);
  a.dq_q_tiles = static_cast<int>(p[25]);
  const bool narrow = a.d == 8 || a.d == 16 || a.d == 32;
  if (a.sh.n_kv_heads <= 0 || a.sh.n_heads % a.sh.n_kv_heads != 0 ||
      (!wide(a.d) && !narrow) || (a.dtype != 0 && a.dtype != 1) ||
      a.design != (narrow ? 2 : 0) + a.dtype || a.sh.batch <= 0 ||
      a.sh.sq <= 0 || a.sh.sk <= 0) {
    return false;
  }
  int bq = mb::kBK, bk = mb::kRows, dq_bq = mb::kRows;
  if (a.d == 64) {
    tiles<64>(a.design, bq, bk, dq_bq);
  } else if (a.d == 112 || a.d == 128) {
    tiles<128>(a.design, bq, bk, dq_bq);
  }
  if (a.n_q_tiles != (a.sh.sq + bq - 1) / bq ||
      a.n_k_tiles != (a.sh.sk + bk - 1) / bk ||
      a.dq_q_tiles != (a.sh.sq + dq_bq - 1) / dq_bq) {
    return false;
  }
  a.sh.group = a.sh.n_heads / a.sh.n_kv_heads;
  return true;
}

template <typename T, int D>
int delta_launch(const void* o, const void* dO, float* delta, const Args& a,
                 cudaStream_t s) {
  constexpr int rows_per_block = kThreads / delta_lanes(D);
  const long long n_rows =
      static_cast<long long>(a.sh.batch) * a.sh.n_heads * a.sh.sq;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(static_cast<const T*>(o), a.ost,
                                      static_cast<const T*>(dO), a.dst, delta,
                                      a.sh);
  return static_cast<int>(cudaGetLastError());
}

// The four TMA maps of q, k, v and dO at `maps` (11 values each), with
// boxes of `cols` columns of `type` and `bq` query rows or `bk` keys;
// false where a map does not encode or does not name those boxes.
template <int D>
bool encode_qkvd(CUtensorMap (&m)[4], const void* q, const void* k,
                 const void* v, const void* dO, const long long* maps, int bq,
                 int bk, CUtensorMapDataType type, int cols) {
  return hopper::encode(&m[0], q, maps, D, type, cols, bq) &&
         hopper::encode(&m[1], k, maps + kMapLongs, D, type, cols, bk) &&
         hopper::encode(&m[2], v, maps + 2 * kMapLongs, D, type, cols, bk) &&
         hopper::encode(&m[3], dO, maps + 3 * kMapLongs, D, type, cols, bq);
}

// One launch of `kernel`, of geometry L, over `blocks` blocks with the
// four maps and the kernel's other arguments.
template <typename L, typename Kernel, typename... Rest>
int launch_maps(Kernel kernel, const CUtensorMap (&m)[4], long long blocks,
                std::atomic<unsigned long long>& opted, cudaStream_t s,
                Rest... rest) {
  const cudaError_t err = hopper::opt_in(kernel, L::kAlloc, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kAlloc, s>>>(
      m[0], m[1], m[2], m[3], rest...);
  return static_cast<int>(cudaGetLastError());
}

// dkdv of the f32 design (the tf kernel) or the bf16 one (wg) at the
// tensors' head dim DR (D 112 in D 128's tiles): a block per (key tile, KV
// head, batch)
template <int DR, bool kF32>
int dkdv_launch(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* delta, void* dk, void* dv,
                const Args& a, const long long* plan, float scale,
                cudaStream_t s) {
  constexpr int D = tile_d(DR);
  using L = std::conditional_t<kF32, tf::Dkdv<D>, wg::Dkdv<D>>;
  using Out = std::conditional_t<kF32, float, __nv_bfloat16>;
  CUtensorMap m[4];
  if (!encode_qkvd<DR>(m, q, k, v, dO, plan + kPlanMaps, L::kBQ, L::kBK,
                       kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       kF32 ? tf::kCols : wg::kCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> opted{0};
  const long long blocks =
      static_cast<long long>(a.n_k_tiles) * a.sh.n_kv_heads * a.sh.batch;
  if constexpr (kF32) {
    return launch_maps<L>(tf::flash_bwd_dkdv_wgmma_f32_kernel<DR>, m, blocks,
                          opted, s, lse, delta, static_cast<Out*>(dk),
                          static_cast<Out*>(dv), a.sh, scale);
  } else {
    return launch_maps<L>(wg::flash_bwd_dkdv_wgmma_kernel<DR>, m, blocks,
                          opted, s, lse, delta, static_cast<Out*>(dk),
                          static_cast<Out*>(dv), a.sh, scale);
  }
}

// dq of either wgmma design: a block per (query tile, head, batch)
template <int DR, bool kF32>
int dq_launch(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, const Args& a,
              const long long* plan, float scale, cudaStream_t s) {
  constexpr int D = tile_d(DR);
  using L = std::conditional_t<kF32, tf::Dq<D>, wg::Dq<D>>;
  using Out = std::conditional_t<kF32, float, __nv_bfloat16>;
  CUtensorMap m[4];
  if (!encode_qkvd<DR>(m, q, k, v, dO, plan + kPlanMaps + 4 * kMapLongs,
                       L::kBQ, L::kBK,
                       kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       kF32 ? tf::kCols : wg::kCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> opted{0};
  const long long blocks =
      static_cast<long long>(a.dq_q_tiles) * a.sh.n_heads * a.sh.batch;
  if constexpr (kF32) {
    return launch_maps<L>(tf::flash_bwd_dq_wgmma_f32_kernel<DR>, m, blocks,
                          opted, s, lse, delta, static_cast<Out*>(dq), a.sh,
                          scale);
  } else {
    return launch_maps<L>(wg::flash_bwd_dq_wgmma_kernel<DR>, m, blocks, opted,
                          s, lse, delta, static_cast<Out*>(dq), a.sh, scale);
  }
}

// The mma designs' packing from the plan (`mp`: strips and heads a block,
// then, for dq, KV heads a block; stages, blocks, shared-memory bytes),
// checked against what it implies: `n_strips` strips over `n_heads` heads
// (dkdv: key strips over the KV heads, one query head of each a trip; dq:
// query strips over the heads, as the forward's), `trips` the most tiles a
// block visits. false where it disagrees.
template <int D>
bool mma_pack(const long long* mp, bool dq, int n_strips, int n_heads,
              int group, int batch, int trips, int es, mb::Pack& pk,
              long long& blocks, int& smem) {
  pk = mb::Pack{static_cast<int>(mp[0]), static_cast<int>(mp[1]), 0, 0, 0,
                0};
  if (pk.sb < 1 || pk.hb < 1 || pk.sb * pk.hb > mb::kMaxWarps ||
      n_heads % pk.hb != 0) {
    return false;
  }
  int nkv = pk.hb;
  if (dq) {
    nkv = 0;
    for (int h0 = 0; h0 < n_heads; h0 += pk.hb) {
      const int n = (h0 + pk.hb - 1) / group - h0 / group + 1;
      nkv = n > nkv ? n : nkv;
    }
  }
  const long long* rest = mp + (dq ? 3 : 2);
  pk.nkv = nkv;
  pk.stages = trips > 1 ? 2 : 1;
  pk.n_sg = (n_strips + pk.sb - 1) / pk.sb;
  pk.n_hg = n_heads / pk.hb;
  blocks = static_cast<long long>(pk.n_sg) * pk.n_hg * batch;
  const int warps = pk.sb * pk.hb;
  smem = dq ? mb::dq_smem(D, es, warps, pk.hb, nkv, pk.stages)
            : mb::dkdv_smem(D, es, warps, pk.hb, pk.stages);
  return (!dq || mp[2] == nkv) && rest[0] == pk.stages &&
         rest[1] == blocks && rest[2] == smem;
}

template <typename T, int D>
int dkdv_mma_launch(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* delta,
                    void* dk, void* dv, const Args& a, const long long* plan,
                    float scale, cudaStream_t s) {
  constexpr int es = static_cast<int>(sizeof(T));
  mb::Pack pk;
  long long blocks;
  int smem;
  if (!mma_pack<D>(plan + kPlanMma, false, a.n_k_tiles, a.sh.n_kv_heads,
                   a.sh.group, a.sh.batch, a.sh.group * a.n_q_tiles, es, pk,
                   blocks, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = &mb::flash_bwd_dkdv_mma_kernel<T, D>;
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = hopper::opt_in(
      kernel, mb::dkdv_smem(D, es, mb::kMaxWarps, mb::kMaxWarps, 2), opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), pk.sb * pk.hb * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), a.sh, pk, a.qst, a.kst, a.vst,
      a.dst, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq_mma_launch(const void* q, const void* k, const void* v,
                  const void* dO, const float* lse, const float* delta,
                  void* dq, const Args& a, const long long* plan, float scale,
                  cudaStream_t s) {
  constexpr int es = static_cast<int>(sizeof(T));
  mb::Pack pk;
  long long blocks;
  int smem;
  const int n_tiles = (a.sh.sk + mb::kBK - 1) / mb::kBK;
  if (!mma_pack<D>(plan + kPlanMma + 5, true, a.dq_q_tiles, a.sh.n_heads,
                   a.sh.group, a.sh.batch, n_tiles, es, pk, blocks, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = &mb::flash_bwd_dq_mma_kernel<T, D>;
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = hopper::opt_in(
      kernel,
      mb::dq_smem(D, es, mb::kMaxWarps, mb::kMaxWarps, mb::kMaxWarps, 2),
      opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), pk.sb * pk.hb * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta,
      static_cast<T*>(dq), a.sh, pk, a.qst, a.kst, a.vst, a.dst, scale);
  return static_cast<int>(cudaGetLastError());
}

using DeltaFn = int (*)(const void*, const void*, float*, const Args&,
                        cudaStream_t);
using DkdvFn = int (*)(const void*, const void*, const void*, const void*,
                       const float*, const float*, void*, void*, const Args&,
                       const long long*, float, cudaStream_t);
using DqFn = int (*)(const void*, const void*, const void*, const void*,
                     const float*, const float*, void*, const Args&,
                     const long long*, float, cudaStream_t);

// The launch of each kernel for a parsed plan's design and head dim.
template <typename T>
DeltaFn delta_fn(int d) {
  switch (d) {
    case 8: return &delta_launch<T, 8>;
    case 16: return &delta_launch<T, 16>;
    case 32: return &delta_launch<T, 32>;
    case 64: return &delta_launch<T, 64>;
    case 112: return &delta_launch<T, 112>;
    default: return &delta_launch<T, 128>;
  }
}

DkdvFn dkdv_fn(const Args& a) {
  switch (a.design) {
    case 0:
      return a.d == 64    ? &dkdv_launch<64, true>
             : a.d == 112 ? &dkdv_launch<112, true>
                          : &dkdv_launch<128, true>;
    case 1:
      return a.d == 64    ? &dkdv_launch<64, false>
             : a.d == 112 ? &dkdv_launch<112, false>
                          : &dkdv_launch<128, false>;
    case 2:
      return a.d == 8    ? &dkdv_mma_launch<float, 8>
             : a.d == 16 ? &dkdv_mma_launch<float, 16>
                         : &dkdv_mma_launch<float, 32>;
    default:
      return a.d == 8    ? &dkdv_mma_launch<__nv_bfloat16, 8>
             : a.d == 16 ? &dkdv_mma_launch<__nv_bfloat16, 16>
                         : &dkdv_mma_launch<__nv_bfloat16, 32>;
  }
}

DqFn dq_fn(const Args& a) {
  switch (a.design) {
    case 0:
      return a.d == 64    ? &dq_launch<64, true>
             : a.d == 112 ? &dq_launch<112, true>
                          : &dq_launch<128, true>;
    case 1:
      return a.d == 64    ? &dq_launch<64, false>
             : a.d == 112 ? &dq_launch<112, false>
                          : &dq_launch<128, false>;
    case 2:
      return a.d == 8    ? &dq_mma_launch<float, 8>
             : a.d == 16 ? &dq_mma_launch<float, 16>
                         : &dq_mma_launch<float, 32>;
    default:
      return a.d == 8    ? &dq_mma_launch<__nv_bfloat16, 8>
             : a.d == 16 ? &dq_mma_launch<__nv_bfloat16, 16>
                         : &dq_mma_launch<__nv_bfloat16, 32>;
  }
}

}  // namespace

// Each launcher takes the plan above and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernels do not take (an empty axis
// included: the wrapper launches nothing then). delta and lse are
// (B, H, Sq) f32 contiguous; dq (B, Sq, H, D), dk and dv (B, Sk, K, D)
// contiguous in the operands' dtype. f32 takes the tf kernels at d 64,
// 112 and 128 and the mb f32 ones at d 8, 16 and 32, bf16 the wg and the
// mb bf16 ones; the delta kernel takes both.
extern "C" int flash_bwd_delta_launch(const void* o, const void* dO,
                                      float* delta, const long long* plan,
                                      void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = a.dtype == 1 ? delta_fn<__nv_bfloat16>(a.d)
                               : delta_fn<float>(a.d);
  return fn(o, dO, delta, a, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dO,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv,
                                     const long long* plan, float scale,
                                     void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  return dkdv_fn(a)(q, k, v, dO, lse, delta, dk, dv, a, plan, scale,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse, const float* delta,
                                   void* dq, const long long* plan,
                                   float scale, void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  return dq_fn(a)(q, k, v, dO, lse, delta, dq, a, plan, scale,
                  static_cast<cudaStream_t>(stream));
}
