// Causal grouped-query flash attention, forward (its backward is
// flash_attention_bwd.cu):
//   o[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, h / group, :] * D^-0.5)
//                   @ v[b, j, h / group, :]   over keys j <= i + (Sk - Sq)
// and, where the caller passes an lse buffer (training), each row's
// log-sum-exp m + log(max(l, 1e-30)) in f32, (B, H, Sq), from the
// epilogue's m and l, in every design. A null lse (serving, search)
// changes nothing else.
// with q (B, Sq, H, D), k and v (B, Sk, K, D), H = K * group, f32 or bf16,
// D in {8, 16, 32, 64, 112, 128}. Queries are the last Sq positions of the key
// axis. A query that sees no key (Sq > Sk) gives 0. The serving prefill's
// attention in every layer (models/attention.py: run_attention with
// impl="chunked").
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:33
// (_flash_kernel): the same online softmax with f32 m, l and acc, masked
// logits at -1e30 and p = 0 where masked, key tiles past the diagonal
// never loaded, and acc / max(l, 1e-30).
//
// Bound on this card: operations. The work is 4*B*H*D FLOPs per visible
// query-key pair (two products): 4.40 TFLOP per layer for one 32k prompt
// of llama3.2-1b (B 1, H 32, D 64), 4.45 ms at the dense bf16 tensor-core
// rate of 989.4 TFLOP/s (launch/roofline.py), against 0.3 GB of q, k, v
// and o (0.09 ms at 3.35 TB/s). In f32 each product is three TF32
// products (below): 26.67 ms at the dense TF32 rate of 494.7 TFLOP/s.
//
// Four kernels, chosen in flash_attention_launch by (dtype, D) alone; the
// Python plan (kernels/flash_attention.py: design) makes the same choice
// and the launcher refuses a plan that disagrees:
//
// * bf16 at D = 64, 112 and 128: flash_wgmma_kernel, on the tensor cores.
//   D 112 (kimi-k2's heads) runs in D 128's tiles (tc::tile_d): its TMA
//   boxes are two of 64 columns, and TMA fills the second one's columns
//   past 112 with zeros, so the products take 16 columns of zeros (a
//   seventh more tensor work than the head needs: D 128's time for D
//   112's output) and the epilogue stores 112 columns.
//   One block of three warpgroups per (128-row query tile, query head,
//   batch), launched heaviest query tile first (the last tile of a 32k
//   prompt visits 256 key tiles, the first one). Warpgroup 0 is the
//   producer: one thread loads the Q tile once and then each 128-key K
//   and V tile by TMA into a ring of kStages stages in dynamic shared
//   memory, each guarded by a full and an empty mbarrier; it gives its
//   registers away (setmaxnreg). Warpgroups 1 and 2 each own 64 query
//   rows and take the registers. Per key tile, S = Q K^T is D/16 wgmma
//   m64n128k16 with both operands in shared memory (K rows are
//   D-contiguous: the K-major B operand as stored); the online softmax
//   runs on the f32 accumulator fragment in registers (row max over the
//   4 threads that share a row, logits scaled by D^-0.5 log2(e) after the
//   product, exp2); P is split in registers into two bf16 parts, hi =
//   bf16(p) and lo = bf16(p - hi), each the register A operand of 8 wgmma
//   m64nDk16 with V from shared memory as the MN-major B operand
//   (transposed by the instruction). hi + lo is p to 2^-17, so P V has
//   f32 precision, as in the TPU kernel and the plain version. P rounded
//   to bf16 once, as FlashAttention does, moves outputs by several bf16
//   ulps from the f32-P result, and two computations of p that straddle
//   a rounding boundary of p differ as much, so no plain version holds it
//   within two ulps; the lo product, a third of the tensor work, is the
//   price. m, l and O stay in f32 registers. Only tiles that cross the
//   diagonal or the end of the key axis are masked. TMA loads 64-column
//   boxes with the 128-byte swizzle that the wgmma descriptors name, and
//   zero-fills rows past Sq and Sk; the epilogue writes rows < Sq from
//   registers. Shared memory: 80 KB at D = 64, 160 KB at D = 128.
// * f32 at D = 64, 112 and 128: flash_wgmma_f32_kernel (D 112 in D 128's
//   tiles, as the bf16 kernel takes it: K and V zero-filled by TMA past
//   column 112, q's loop writing zeros there), on the tensor cores at
//   f32 precision. wgmma reads f32 operands as TF32 (the top 19 bits), so
//   each operand x is split into hi = tf32(x), rounded to nearest with
//   cvt.rna, and lo = tf32(x - hi), and A B is taken as three products,
//   A_lo B_hi + A_hi B_lo + A_hi B_hi (the small terms first), accumulated
//   in f32; A_lo B_lo (2^-22 of A B) is dropped. One TF32 product would be
//   2^-11 off, far outside the f32 checks. The skeleton is the bf16
//   kernel's: one block per (query tile, head, batch), heaviest query tile
//   first, warpgroup 0 the producer, 64-row consumer warpgroups, the
//   softmax on the accumulator fragment, masks only on tiles that cross
//   the diagonal or the end of the key axis. What differs:
//   - TF32 wgmma reads both shared-memory operands K-major only. K is
//     K-major as stored, V is not (its rows are D-contiguous), so V must
//     be transposed in shared memory. The producer warpgroup does that in
//     the pass that splits: one thread loads each raw f32 K and V tile by
//     TMA (32-column boxes, the 128-byte swizzle row of f32) into a raw
//     ring; all 128 producer threads then write K's hi and lo at the raw
//     tile's own offsets and V's transposed (rows of D, keys contiguous),
//     into a split ring that the consumers read. Both passes are free of
//     bank conflicts: lanes take consecutive 16-byte chunks of K, and
//     consecutive keys of one V column.
//   - P, the A operand of P V, comes from the S accumulator in registers.
//     The TF32 A fragment holds keys t and t + 4 of each 8-key step where
//     the accumulator holds keys 2t and 2t + 1, so the transposed V stores
//     the keys of each 8-key group in the order 0 2 4 6 1 3 5 7 and no
//     register moves between lanes.
//   - O is not the accumulator of P V. The tensor cores' f32 sums drop
//     low bits of addends much smaller than the sum, so O accumulated in
//     the tensor cores over thousands of keys drifted towards the f32
//     tolerance; each tile's P V goes into a fresh accumulator and
//     O = O alpha + P V is one f32 fma per element.
//   - Shared memory. At D = 64 Q's hi and lo stay in registers as A
//     fragments, and the block holds two 64-row consumers (128 query
//     rows), 64-key tiles, two raw stages (32 KB each) and two split
//     stages (64 KB each): 192 KB. At D = 128 the fragments would not fit
//     in registers, so Q's parts go to shared memory (64 KB), with one
//     consumer (64 rows), 32-key tiles, one raw and two split stages:
//     224 KB.
// * bf16 at D = 8, 16 and 32: flash_mma_kernel, on the tensor cores by
//   warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate). Written for
//   the Meta-pipe encoder's 32-token sequences (B 4,096 x S 32 x H 8,
//   D 32: 2.2 GFLOP against 268 MB of q, k, v and o), which are bound by
//   bytes (0.080 ms at 3.35 TB/s) 36 times over, so what counts is bytes
//   in flight and full blocks, not the product's rate; wgmma's 64-row
//   tiles would leave half of each tile empty at S 32, and rows of two
//   heads cannot share one wgmma. A warp owns a 16-row query strip of one
//   (head, batch); a block packs `sb` consecutive strips of `hb`
//   consecutive heads of one batch element (kernels/flash_attention.py:
//   mma_plan; 2 strips x 4 heads = 8 warps at S 32, H 8), the strip group
//   with the most key tiles first. The block copies its query rows, and
//   each 32-key K and V tile of the KV heads its heads read (once for
//   all the query heads of a KV head), as bf16 into shared memory by
//   16-byte cp.async, neighbouring threads on neighbouring 16-byte
//   pieces of a row's heads; all of the first tile's copies are issued
//   before the first product, and each next tile's while the current
//   one is in use (two stages where a strip visits more than one tile).
//   Rows past Sq and Sk are zero-filled. Rows are padded by 16 bytes and
//   each head's region is skewed by 16 bytes, so the 8 rows of an
//   ldmatrix fall in 8 distinct 16-byte bank groups. The arithmetic is
//   the plain version's: q scaled by D^-0.5 in f32 before the product,
//   exp, f32 m, l and P. The operands that are f32 (scaled q, P) enter
//   the bf16 products as three bf16 parts that sum to them exactly, so
//   every product is exact and only the order of the f32 sums differs.
//   Two parts (P to 2^-17, as flash_wgmma_kernel takes it) hold one bf16
//   ulp per call, but round more outputs to the other neighbour than the
//   plain version does, and the Meta-pipe encoder's four layers carried
//   those flips past its bf16 check (chip_smoke.py: encoder_check); the
//   extra products cost nothing here, since the kernel waits on bytes. Per key tile a warp runs S as D/16 x 4 x 3 mma (its
//   Q fragment by ldmatrix, scaled and split in registers; K by
//   ldmatrix as stored); the online softmax runs on the accumulator
//   fragment (row max over the 4 threads of a row); P goes from the
//   accumulator to the A fragments in registers, and P V takes V by
//   ldmatrix.trans. Tiles past a strip's diagonal are not computed, and
//   past the block's last row not loaded. The
//   epilogue writes O, normalized, over the warp's own query rows in
//   shared memory; the block then stores whole rows of its heads as
//   16-byte vectors. Every base and stride must be a multiple of 16
//   bytes; the wrapper copies an operand that is not.
// * f32 at D = 8, 16 and 32: flash_mma_f32_kernel, the mma kernel's
//   skeleton (16-row strips of several heads a block, 16-byte cp.async copies of
//   f32 rows, two K/V stages where a strip visits more than one tile, the
//   epilogue through shared memory) with the products on the tensor cores
//   at f32 precision: mma.sync m16n8k8 TF32, each product taken as three,
//   A_lo B_hi + A_hi B_lo + A_hi B_hi of the operands' TF32 hi and lo
//   parts (split in registers, q scaled by D^-0.5 in f32 first), as
//   flash_wgmma_f32_kernel takes them. At the encoder's shape in f32
//   (537 MB of q, k, v and o, 0.160 ms at 3.35 TB/s, against 2.2 GFLOP,
//   6.6 as TF32 products, 0.013 ms) it is bound by bytes. The fragments:
//   - An 8x8 b16 matrix of ldmatrix is 8 rows of 4 floats, and lane (g =
//     lane / 4, t = lane % 4) receives float t of row g: the TF32 A
//     fragment of q (rows g, g + 8; columns t, t + 4) and the B fragment
//     of K as stored (key g; columns t, t + 4) load by ldmatrix.x4.
//   - The S accumulator holds keys 2t and 2t + 1 of each 8-key group,
//     the A fragment of P V wants k indices t and t + 4: a = c0, c2, c1,
//     c3 takes k index t as key 2t and t + 4 as key 2t + 1, and V's B
//     fragment is read at the same keys, V[2t][g] and V[2t + 1][g], by
//     scalar shared loads (ldmatrix.trans would tear the floats into
//     16-bit halves). No register moves between lanes.
//   - Rows are padded to D + 4 floats: the 8 rows of an ldmatrix fall in
//     8 distinct 16-byte bank groups, and the V reads (bank 8t + g, and
//     8t + g + D + 4 for key 2t + 1, mod 32) in 32 distinct banks.
//   - Each tile's P V goes into a fresh accumulator and O = O alpha +
//     P V is one f32 fma per element (the tensor cores' sums drop low
//     bits of addends much smaller than the sum; see the f32 wgmma
//     kernel). The softmax runs in log2 units, exp2 of s log2(e) - m.
//
// The Hopper helpers that the wgmma kernels share with the backward's
// (flash_attention_bwd.cu) live in hopper.cuh: the mbarriers, TMA loads
// and the tensor-map encoding, the wgmma descriptors, fences, commit and
// wait, the bf16 product with its A operand in registers, exp2, the TF32
// parts (tf32), swizzled f32 tile offsets (swz), named barriers, the
// async-proxy fence, the TF32 products (wgmma_ss_tf32, wgmma_rs_tf32),
// and the dynamic shared-memory opt-in.
#include <cuda.h>

#include <atomic>
#include <cmath>
#include <type_traits>
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::Strides;

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, D = 64 and 128)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;              // query rows per block (2 x 64)
constexpr int kBK = 128;              // keys per K/V tile
constexpr int kCols = 64;             // head-dim columns per TMA box: one
                                      // 128-byte swizzle row of bf16
constexpr int kBox = 128 * kCols * 2; // bytes of one 128-row box
constexpr int kStages = 2;            // depth of the K/V ring
constexpr int kThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;     // arrivals that free a ring stage
constexpr float kLog2e = 1.4426950408889634f;

// The head dim of a kernel's tiles (hopper.cuh): D 112 in D 128's.
using hopper::tile_d;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): Q, then per stage K and V, each
// D / 64 boxes of 128 rows x 128 bytes; then the mbarriers.
template <int D>
struct Layout {
  static constexpr int kTile = D / kCols * kBox;
  static constexpr int kKV = kTile;
  static constexpr int kBars = kKV + 2 * kStages * kTile;
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
};

using hopper::bits;
using hopper::desc_k_major;
using hopper::encode;
using hopper::ex2;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::opt_in;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_bf16;
using hopper::wgmma_wait_all;

// MN-major operand (V as B of P V): 64 head-dim columns per 128-byte row
// of a key, 8-key groups 1024 bytes apart, the next 64 columns one box
// (kBox bytes) on; a k16 step moves 16 keys = 2048 bytes.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return hopper::desc_mn_major(addr, kBox);
}

// S (64 x 128, f32) (+)= A (64 x 16, smem) * B (128 x 16, smem)^T.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The log-sum-exp of the thread's two rows r0 and r0 + 8 (lse: the (b, h)
// row of the (B, H, Sq) output), written by the first of the 4 threads
// that share a row: m (the running max, in log2 units) ln 2 + log(l),
// natural units, as the plain version's m + log(max(l, 1e-30)); -1e30,
// what that gives in f32, for a row that sees no key (l = 0).
__device__ __forceinline__ void write_lse(float* lse, const float (&m)[2],
                                          const float (&l)[2], int r0,
                                          int lane, int sq) {
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < sq) {
      lse[row] = l[r] > 0.f ? fmaf(m[r], 0.6931471805599453f, logf(l[r]))
                            : -1e30f;
    }
  }
}


// blockIdx.x -> (query tile, head, batch): the last query tile first over
// every head and batch, heads that share a KV head side by side
// (kernels/flash_attention.py: launch_order).
template <int DR>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int sq, int sk, int n_heads, int batch, int group,
                   int n_q_tiles, float scale_log2) {
  constexpr int D = tile_d(DR);
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8;              // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;    // empty[s] = empty0 + 8 s

  const int per = n_heads * batch;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = static_cast<int>(blockIdx.x) % per % n_heads;
  const int b = static_cast<int>(blockIdx.x) % per / n_heads;
  const int q0 = q_tile * kBQ;
  const int offset = sk - sq;
  // causal trip count: the key tiles up to the block's last query row
  const int q_last = offset + min(q0 + kBQ, sq) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min(q_last / kBK + 1, (sk + kBK - 1) / kBK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < D / kCols; ++c) {
        tma_load(base + c * kBox, &qmap, q_full, c * kCols, h, q0, b);
      }
      const int kvh = h / group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        const uint32_t ks = base + L::kKV + 2 * s * L::kTile;
        mbar_expect_tx(full0 + 8 * s, 2 * L::kTile);
        for (int c = 0; c < D / kCols; ++c) {
          tma_load(ks + c * kBox, &kmap, full0 + 8 * s, c * kCols, kvh,
                   j * kBK, b);
          tma_load(ks + L::kTile + c * kBox, &vmap, full0 + 8 * s, c * kCols,
                   kvh, j * kBK, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 (wg - 1) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int row_wg = q0 + 64 * (wg - 1);
    // accumulator fragment: element i of this thread is row
    // r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + col0 + (i & 1)
    const int r0 = row_wg + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t q_wg = base + 64 * 128 * (wg - 1);

    float acc[D / 2];
    float s[64];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(full0 + 8 * st, (j / kStages) & 1);
      const uint32_t ks = base + L::kKV + 2 * st * L::kTile;
      const uint32_t vs = ks + L::kTile;

      // S = Q K^T: D / 16 steps of 16 head-dim columns
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_qk(s, desc_k_major(q_wg + off), desc_k_major(ks + off),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const int k0 = j * kBK;
      if (k0 + kBK - 1 > offset + row_wg || k0 + kBK > sk) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = offset + r0 + 8 * ((i >> 1) & 1);
          if (key > qpos || key >= sk) s[i] = -INFINITY;
        }
      }

      // online softmax, in log2 units: m is the running max of
      // s * D^-0.5 * log2(e)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      // p = 0 where masked (s = -inf); l sums the f32 p. The product
      // takes p as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi),
      // whose sum is p to 2^-17: P V at f32 precision, as the TPU kernel
      // and the plain version compute it. Packed as wgmma's A fragment:
      // register 4 kk + e of k-step kk holds S elements 8 kk + 2 e, + 1.
      float psum[2] = {0.f, 0.f};
      uint32_t pa_hi[32], pa_lo[32];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = ex2(fmaf(s[i], scale_log2, -m[r]));
        const float p1 = ex2(fmaf(s[i + 1], scale_log2, -m[r]));
        psum[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        pa_hi[i >> 1] = bits(hi);
        pa_lo[i >> 1] = bits(__floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi)));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V: 8 steps of 16 keys, two products each
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc_mn_major(vs + kk * 16 * 128);
        const uint32_t hi[4] = {pa_hi[4 * kk], pa_hi[4 * kk + 1],
                                pa_hi[4 * kk + 2], pa_hi[4 * kk + 3]};
        const uint32_t lo[4] = {pa_lo[4 * kk], pa_lo[4 * kk + 1],
                                pa_lo[4 * kk + 2], pa_lo[4 * kk + 3]};
        wgmma_rs_bf16<D>(acc, hi, dv);
        wgmma_rs_bf16<D>(acc, lo, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // l over the 4 threads of each row, the row's log-sum-exp where it is
    // asked for, then acc / max(l, 1e-30)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 2);
    }
    if (lse != nullptr) {
      tc::write_lse(lse + (static_cast<long long>(b) * n_heads + h) * sq, m,
                    l, r0, lane, sq);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * sq + row) * n_heads + h) * DR;
#pragma unroll
      for (int jb = 0; jb < DR / 8; ++jb) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            acc[4 * jb + 2 * r] / l[r], acc[4 * jb + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb + col0) = v2;
      }
    }
  }
}

template <int DR>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int sq, int sk, int n_heads, int group,
           const long long* maps, int n_q_tiles, float scale,
           cudaStream_t stream) {
  constexpr int D = tile_d(DR);
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm;
  if (n_q_tiles != (sq + kBQ - 1) / kBQ ||
      !encode(&qm, q, maps, DR, kBf16, kCols, kBQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // an empty key axis loads no key tile (every row gives 0): its maps
  // are never read, and an empty tensor may have no address to encode
  if (sk == 0) {
    km = vm = qm;
  } else if (!encode(&km, k, maps + 11, DR, kBf16, kCols, kBK) ||
             !encode(&vm, v, maps + 22, DR, kBf16, kCols, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Layout<D>::kAlloc;
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = opt_in(flash_wgmma_kernel<DR>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(n_q_tiles) * n_heads * batch;
  flash_wgmma_kernel<DR><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, sq, sk, n_heads,
      batch, group, n_q_tiles, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The f32 tensor-core kernel (D = 64 and 128): three TF32 products
// ---------------------------------------------------------------------------

namespace tf {

using tc::desc_k_major;
using tc::ex2;
using tc::fence_regs;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::tma_load;
using tc::wgmma_commit;
using tc::wgmma_fence;
using tc::wgmma_wait_all;
using hopper::bar_sync;
using hopper::fence_async_smem;
using hopper::swz;
using hopper::tf32;
using hopper::wgmma_rs_tf32;
using hopper::wgmma_ss_tf32;

constexpr int kCols = 32;  // head-dim columns per TMA box: one 128-byte
                           // swizzle row of f32
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kConsumers = D == 64 ? 2 : 1;  // 64-row warpgroups
  static constexpr int kBQ = 64 * kConsumers;         // query rows per block
  static constexpr int kBK = D == 64 ? 64 : 32;       // keys per K/V tile
  static constexpr bool kQRegs = D == 64;  // Q's parts as A fragments
  static constexpr int kRaw = D == 64 ? 2 : 1;        // raw K/V stages
  static constexpr int kStages = 2;                   // split stages
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kTile = kBK * D * 4;           // one K or V tile
  // Shared memory from a 1024-byte aligned base: Q's hi and lo tiles per
  // consumer (64 rows x D, not at D = 64), the raw stages (K, then V), the
  // split stages (K hi, K lo, V^T hi, V^T lo), then the mbarriers: raw
  // full, split full, split empty.
  static constexpr int kQPart = 64 * D * 4;
  static constexpr int kRawOff = kQRegs ? 0 : kConsumers * 2 * kQPart;
  static constexpr int kSplitOff = kRawOff + kRaw * 2 * kTile;
  static constexpr int kBars = kSplitOff + kStages * 4 * kTile;
  static constexpr int kAlloc = kBars + 8 * (kRaw + 2 * kStages) + 1024;
  static_assert(kAlloc <= 232448, "over the block's shared memory");
};

// The producer's pass over one raw tile: K's hi and lo at the raw tile's
// own offsets, V transposed (row d of D, keys contiguous, each 8-key group
// in the order 0 2 4 6 1 3 5 7 that the P fragments take). `t`: the
// thread in the producer warpgroup.
template <int D>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* dst,
                                           int t) {
  using C = Cfg<D>;
  const float4* kr = reinterpret_cast<const float4*>(raw);
  float4* khi = reinterpret_cast<float4*>(dst);
  float4* klo = reinterpret_cast<float4*>(dst + C::kTile);
#pragma unroll 4
  for (int i = t; i < C::kTile / 16; i += 128) {
    const float4 x = kr[i];
    const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    khi[i] = h;
    klo[i] = make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z),
                         tf32(x.w - h.w));
  }
  const uint8_t* vr = raw + C::kTile;
  uint8_t* vhi = dst + 2 * C::kTile;
  uint8_t* vlo = dst + 3 * C::kTile;
#pragma unroll 2
  for (int f = t; f < C::kBK * D / 4; f += 128) {
    const int key = f % C::kBK;  // a warp: 32 consecutive keys
    const int d0 = 4 * (f / C::kBK);
    const float4 x =
        *reinterpret_cast<const float4*>(vr + swz<C::kBK>(key, d0));
    // the key's column in V^T: its 32-key box, then its slot in its group
    const int col = (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t off = swz<D>(d0 + c, col);
      const float h = tf32(xs[c]);
      *reinterpret_cast<float*>(vhi + off) = h;
      *reinterpret_cast<float*>(vlo + off) = tf32(xs[c] - h);
    }
  }
}

// Raw K and V tile j into raw stage j % kRaw, by TMA; the bytes complete
// on that stage's full barrier.
template <int D>
__device__ __forceinline__ void load_raw(uint32_t base, uint32_t raw_full0,
                                         const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, int j,
                                         int kvh, int b) {
  using C = Cfg<D>;
  const int r = j % C::kRaw;
  const uint32_t bar = raw_full0 + 8 * r;
  const uint32_t dst = base + C::kRawOff + 2 * r * C::kTile;
  mbar_expect_tx(bar, 2 * C::kTile);
  for (int c = 0; c < D / kCols; ++c) {
    tma_load(dst + c * C::kBK * 128, kmap, bar, c * kCols, kvh, j * C::kBK,
             b);
    tma_load(dst + C::kTile + c * C::kBK * 128, vmap, bar, c * kCols, kvh,
             j * C::kBK, b);
  }
}

// blockIdx.x -> (query tile, head, batch) as in the bf16 kernel.
template <int DR>
__global__ void __launch_bounds__(Cfg<tc::tile_d(DR)>::kThreads, 1)
flash_wgmma_f32_kernel(const float* __restrict__ q, Strides qst,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       float* __restrict__ o, float* __restrict__ lse,
                       int sq, int sk, int n_heads, int batch, int group,
                       int n_q_tiles, float scale) {
  constexpr int D = tc::tile_d(DR);
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t raw_full0 = base + C::kBars;            // + 8 r
  const uint32_t full0 = raw_full0 + 8 * C::kRaw;        // + 8 s
  const uint32_t empty0 = full0 + 8 * C::kStages;        // + 8 s

  const int per = n_heads * batch;
  const int q_tile = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = static_cast<int>(blockIdx.x) % per % n_heads;
  const int b = static_cast<int>(blockIdx.x) % per / n_heads;
  const int q0 = q_tile * C::kBQ;
  const int offset = sk - sq;
  // causal trip count: the key tiles up to the block's last query row
  const int q_last = offset + min(q0 + C::kBQ, sq) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min(q_last / C::kBK + 1, (sk + C::kBK - 1) / C::kBK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int r = 0; r < C::kRaw; ++r) mbar_init(raw_full0 + 8 * r, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 4 * C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: thread 0 loads raw K/V tiles by TMA, all 128 split them
    if constexpr (C::kConsumers == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    }
    const int t = threadIdx.x;
    const int kvh = h / group;
    if (t == 0) {
      for (int j = 0; j < min(C::kRaw, n_tiles); ++j) {
        load_raw<D>(base, raw_full0, &kmap, &vmap, j, kvh, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int r = j % C::kRaw;
      const int s = j % C::kStages;
      mbar_wait(raw_full0 + 8 * r, (j / C::kRaw) & 1);
      mbar_wait(empty0 + 8 * s, ((j / C::kStages) & 1) ^ 1);
      split_tile<D>(sbase + C::kRawOff + 2 * r * C::kTile,
                    sbase + C::kSplitOff + 4 * s * C::kTile, t);
      fence_async_smem();
      mbar_arrive(full0 + 8 * s);
      if (j + C::kRaw < n_tiles) {
        bar_sync(1, 128);  // every producer thread is done with raw r
        if (t == 0) {
          load_raw<D>(base, raw_full0, &kmap, &vmap, j + C::kRaw, kvh, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 (wg - 1) + [0, 64)
    if constexpr (C::kConsumers == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    }
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int row_wg = q0 + 64 * (wg - 1);
    // accumulator fragment: element i of this thread is row
    // r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + col0 + (i & 1)
    const int r0 = row_wg + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const float* qb = q + b * qst.b + h * qst.h;

    // Q scaled by D^-0.5 (as the plain version does) and split. At D = 64
    // as register A fragments: register e of k-step kk is row
    // r0 + 8 (e & 1), column 8 kk + (lane & 3) + 4 (e >> 1). At D = 128
    // as K-major hi and lo tiles of the warpgroup's 64 rows.
    constexpr int kQF = C::kQRegs ? D / 8 : 1;
    uint32_t qh[kQF][4], ql[kQF][4];
    const uint32_t q_hi = base + (wg - 1) * 2 * C::kQPart;
    const uint32_t q_lo = q_hi + C::kQPart;
    if constexpr (C::kQRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e & 1);
          const int col = 8 * kk + (lane & 3) + 4 * (e >> 1);
          const float x =
              row < sq && col < DR ? qb[row * qst.s + col] * scale : 0.f;
          const float hi = tf32(x);
          qh[kk][e] = __float_as_uint(hi);
          ql[kk][e] = __float_as_uint(tf32(x - hi));
        }
      }
    } else {
      uint8_t* qhi = sbase + (q_hi - base);
      for (int i = t; i < 64 * D; i += 128) {
        const int r = i / D;
        const int c = i % D;
        const int row = row_wg + r;
        const float x =
            row < sq && c < DR ? qb[row * qst.s + c] * scale : 0.f;
        const float hi = tf32(x);
        *reinterpret_cast<float*>(qhi + swz<64>(r, c)) = hi;
        *reinterpret_cast<float*>(qhi + C::kQPart + swz<64>(r, c)) =
            tf32(x - hi);
      }
      fence_async_smem();
      bar_sync(1 + wg, 128);
    }

    float acc[D / 2], pv[D / 2];
    float s[C::kBK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = pv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::kBK / 2; ++i) s[i] = 0.f;
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % C::kStages;
      mbar_wait(full0 + 8 * st, (j / C::kStages) & 1);
      const uint32_t khi = base + C::kSplitOff + 4 * st * C::kTile;
      const uint32_t klo = khi + C::kTile;
      const uint32_t vhi = klo + C::kTile;
      const uint32_t vlo = vhi + C::kTile;

      // S = Q K^T: D / 8 steps of 8 head-dim columns, three products each
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t off = (kk / 4) * C::kBK * 128 + (kk % 4) * 32;
        if constexpr (C::kQRegs) {
          wgmma_rs_tf32<64>(s, ql[kk], desc_k_major(khi + off), kk > 0);
          wgmma_rs_tf32<64>(s, qh[kk], desc_k_major(klo + off), 1);
          wgmma_rs_tf32<64>(s, qh[kk], desc_k_major(khi + off), 1);
        } else {
          const uint32_t qo = (kk / 4) * 64 * 128 + (kk % 4) * 32;
          wgmma_ss_tf32<32>(s, desc_k_major(q_lo + qo),
                            desc_k_major(khi + off), kk > 0);
          wgmma_ss_tf32<32>(s, desc_k_major(q_hi + qo),
                            desc_k_major(klo + off), 1);
          wgmma_ss_tf32<32>(s, desc_k_major(q_hi + qo),
                            desc_k_major(khi + off), 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const int k0 = j * C::kBK;
      if (k0 + C::kBK - 1 > offset + row_wg || k0 + C::kBK > sk) {
#pragma unroll
        for (int i = 0; i < C::kBK / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = offset + r0 + 8 * ((i >> 1) & 1);
          if (key > qpos || key >= sk) s[i] = -INFINITY;
        }
      }

      // online softmax in log2 units: m is the running max of s log2(e)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < C::kBK / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * kLog2e);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      // p = 0 where masked (s = -inf); l sums the f32 p. The A fragment of
      // k-step kk: registers (r0, key 2t), (r0 + 8, key 2t), (r0, key
      // 2t + 1), (r0 + 8, key 2t + 1) of its 8 keys, t = lane & 3, which
      // V^T holds in slots t and t + 4.
      float psum[2] = {0.f, 0.f};
      uint32_t ph[C::kBK / 8][4], pl[C::kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < C::kBK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * kk + ((e & 1) << 1) + (e >> 1);
          const int r = (i >> 1) & 1;
          const float p = ex2(fmaf(s[i], kLog2e, -m[r]));
          psum[r] += p;
          const float hi = tf32(p);
          ph[kk][e] = __float_as_uint(hi);
          pl[kk][e] = __float_as_uint(tf32(p - hi));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];

      // pv = P V: kBK / 8 steps of 8 keys, three products each, into a
      // fresh accumulator; then O = O alpha + pv on the CUDA cores. The
      // tensor cores' f32 sums drop low bits of small addends, which over
      // a 32k key axis of O (a thousand tiles) would add up.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kBK / 8; ++kk) {
        const uint32_t off = (kk / 4) * D * 128 + (kk % 4) * 32;
        wgmma_rs_tf32<D>(pv, pl[kk], desc_k_major(vhi + off), kk > 0);
        wgmma_rs_tf32<D>(pv, ph[kk], desc_k_major(vlo + off), 1);
        wgmma_rs_tf32<D>(pv, ph[kk], desc_k_major(vhi + off), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
      }
    }

    // l over the 4 threads of each row, the row's log-sum-exp where it is
    // asked for, then acc / max(l, 1e-30)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 2);
    }
    if (lse != nullptr) {
      tc::write_lse(lse + (static_cast<long long>(b) * n_heads + h) * sq, m,
                    l, r0, lane, sq);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sq) continue;
      float* orow =
          o + ((static_cast<long long>(b) * sq + row) * n_heads + h) * DR;
#pragma unroll
      for (int jb = 0; jb < DR / 8; ++jb) {
        *reinterpret_cast<float2*>(orow + 8 * jb + col0) = make_float2(
            acc[4 * jb + 2 * r] / l[r], acc[4 * jb + 2 * r + 1] / l[r]);
      }
    }
  }
}

template <int DR>
int launch(const void* q, Strides qst, const void* k, const void* v, void* o,
           float* lse, int batch, int sq, int sk, int n_heads, int group,
           const long long* maps, int n_q_tiles, float scale,
           cudaStream_t stream) {
  constexpr int D = tc::tile_d(DR);
  using C = Cfg<D>;
  constexpr auto kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (n_q_tiles != (sq + C::kBQ - 1) / C::kBQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // q is read through its strides; an empty key axis loads no key tile
  CUtensorMap km{}, vm{};
  if (sk > 0 && (!tc::encode(&km, k, maps + 11, DR, kF32, kCols, C::kBK) ||
                 !tc::encode(&vm, v, maps + 22, DR, kF32, kCols, C::kBK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err =
      tc::opt_in(flash_wgmma_f32_kernel<DR>, C::kAlloc, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(n_q_tiles) * n_heads * batch;
  flash_wgmma_f32_kernel<DR><<<static_cast<unsigned>(blocks), C::kThreads,
                              C::kAlloc, stream>>>(
      static_cast<const float*>(q), qst, km, vm, static_cast<float*>(o), lse,
      sq, sk, n_heads, batch, group, n_q_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

// ---------------------------------------------------------------------------
// The short-sequence tensor-core kernel (bf16, D = 16 and 32): mma.sync
// ---------------------------------------------------------------------------

namespace mk {

using namespace hopper::strip;
using tc::bits;
using tc::ex2;
using tc::smem_u32;
using hopper::tf32;

constexpr float kLog2e = 1.4426950408889634f;

// Register e of three A fragments (part 0 the largest): two f32 values
// each as three bf16 parts, hi = bf16(x), mid = bf16(x - hi) and lo =
// bf16(x - hi - mid), whose sum is x exactly (8 significant bits each;
// both differences are exact in f32) but near f32's smallest normals. Operands split so make every
// product exact and the sums f32: the logits and P V of the plain version
// up to the order of the sums.
__device__ __forceinline__ void split3(float x0, float x1,
                                       uint32_t (&parts)[3][4], int e) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    parts[i][e] = bits(h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// x as the TF32 operands of the three products: hi = tf32(x) and lo =
// tf32(x - hi); hi + lo is x to 2^-22 of it.
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

// Logits past the causal diagonal or the key axis to -inf: s holds the
// 4 n8 accumulators of keys k0 .. k0 + 31 for the strip whose first row
// is at key position row_pos. Only a tile that crosses the diagonal or
// the end of the key axis is masked.
__device__ __forceinline__ void mask_tile(float (&s)[kBK / 8][4], int k0,
                                          int row_pos, int sk, int g,
                                          int t) {
  if (k0 + kBK - 1 <= row_pos && k0 + kBK <= sk) return;
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * nt + 2 * t + (i & 1);
      const int qpos = row_pos + g + 8 * (i >> 1);
      if (key > qpos || key >= sk) s[nt][i] = -INFINITY;
    }
  }
}

// The max of rows g and g + 8 over the tile's accumulators, across the 4
// lanes that share a row.
__device__ __forceinline__ void row_max(const float (&s)[kBK / 8][4],
                                        float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::kFullMask, mx[r], 2));
  }
}

// l of rows g and g + 8 summed over the 4 lanes of each row, and at least
// 1e-30 (a row that sees no key divides 0 by it)
__device__ __forceinline__ void row_denominators(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(repro::kFullMask, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
}

// The log-sum-exp of the warp's rows row0 + g and row0 + g + 8 (lse: the
// (b, h) row of the (B, H, Sq) output) from their running max m (natural
// units, or log2 units where kLog2) and l after row_denominators: m +
// log(l) in natural units, the plain version's m + log(max(l, 1e-30));
// -1e30, what that gives in f32, for a row that sees no key (l clamped to
// 1e-30). Written by the first of the 4 lanes of a row, after the
// epilogue (O's registers are free by then: at the 80 registers of three
// blocks an SM, a write before it spilled), with the fast log (MUFU.LG2,
// about 1e-7 off: well inside LSE_TOL).
template <bool kLog2>
__device__ __forceinline__ void write_lse(float* lse, const float (&m)[2],
                                          const float (&l)[2], int row0,
                                          int g, int t, int sq) {
  if (t != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < sq) {
      const float mn = kLog2 ? m[r] * 0.6931471805599453f : m[r];
      lse[row] = l[r] > 1e-30f ? mn + __logf(l[r]) : -1e30f;
    }
  }
}

// Whole rows < Sq of the block's heads from the query-row region of
// shared memory (normalized O) to o, 16 bytes a thread.
template <typename T, int D>
__device__ __forceinline__ void store_o(T* o, const T* sm, const Unit& u,
                                        const Pack& pk, int sq,
                                        int n_heads) {
  using R = Rows<T, D>;
  const int n_q = u.rows * pk.hb * R::kCh;
  for (int c = threadIdx.x; c < n_q; c += blockDim.x) {
    const int ch = c % R::kCh;
    const int hh = c / R::kCh % pk.hb;
    const int r = c / (R::kCh * pk.hb);
    const int qi = u.row_blk + r;
    if (qi >= sq) continue;
    *reinterpret_cast<uint4*>(
        o + ((static_cast<long long>(u.b) * sq + qi) * n_heads + u.h0 + hh) *
                D +
        ch * R::kVec) =
        *reinterpret_cast<const uint4*>(
            sm + (hh * u.rows + r) * R::kRS + hh * R::kVec + ch * R::kVec);
  }
}

// Fragments: g = lane / 4 and t = lane % 4. An accumulator c of an n8
// tile holds row g in c[0..1] (columns 2t, 2t + 1) and row g + 8 in
// c[2..3]; an A fragment a[0..3] holds (row g, k 2t..), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..). Three blocks of 8 warps an SM (up
// to 85 registers a thread): the more blocks in flight, the more bytes,
// but at four (64 registers) D = 32 spills. At D = 8 (qwen2-0.5b's smoke
// heads) a row is one 16-byte piece and its padding piece: the padding is
// zeroed once, so the k16 product of Q K^T reads 8 zero columns past the
// head dim, and P V takes the one n8 tile of the k16 step's V fragments.
// kLse: the training instantiation, which also writes each row's lse
// (write_lse) and runs two blocks an SM (up to 128 registers: at 80 the
// lse's registers spilled); serving's and search's null-lse launches take
// the kLse = false one, whose code has no lse in it.
template <int D, bool kLse>
__global__ void __launch_bounds__(kMaxWarps * 32, kLse ? 2 : 3)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int n_heads, int batch, int group, Pack pk,
                 Strides qst, Strides kst, Strides vst, float scale) {
  using R = Rows<__nv_bfloat16, D>;
  constexpr int kRS = R::kRS;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const uint32_t sbase = smem_u32(sm);

  const int warps = pk.sb * pk.hb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Unit u = unit_of(pk, batch, group, sq, sk, warp);
  const int offset = sk - sq;

  const int q_sz = q_elems(kRS, warps, pk.hb, R::kVec);
  const int tile_sz = tile_elems(kRS, R::kVec);
  const int stage_sz = 2 * pk.nkv * tile_sz;
  const uint32_t q_warp = sbase + 2 * (warp * kRows * kRS + u.hw * R::kVec);

  if constexpr (D % 16 != 0) {
    // the padding pieces that the k16 steps read as head-dim columns
    const int n = smem_bytes(D, 2, warps, pk.hb, pk.nkv, pk.stages) / 16;
    for (int i = tid; i < n; i += blockDim.x) smem4[i] = make_float4(0, 0,
                                                                     0, 0);
    __syncthreads();
  }
  copy_q<__nv_bfloat16, D>(sbase, q, u, pk, qst, sq);
  if (u.n_tiles > 0) {
    copy_kv<__nv_bfloat16, D>(sbase + 2 * q_sz, k, v, u, pk, kst, vst, 0,
                              sk, tile_sz);
  }
  cp_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < u.n_tiles; ++j) {
    if (j + 1 < u.n_tiles) {
      copy_kv<__nv_bfloat16, D>(
          sbase + 2 * (q_sz + ((j + 1) & 1) * stage_sz), k, v, u, pk, kst,
          vst, j + 1, sk, tile_sz);
    }
    cp_commit();
    cp_wait<1>();     // every group but the newest: tile j (and q)
    __syncthreads();
    if (j < u.my_trips) {
      const uint32_t kt = sbase + 2 * (q_sz + (j & 1) * stage_sz +
                                       u.kvi * tile_sz);
      const uint32_t vt = kt + 2 * pk.nkv * tile_sz;

      // S = (Q D^-0.5) K^T: per k-step the strip's A fragment, scaled in
      // f32 and split into three parts, then 4 n8 tiles of keys, the
      // smallest part first
      float s[kBK / 8][4];
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk) {
        uint32_t qa[4], qp[3][4];
        const int r = (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4(qa, q_warp + 2 * (r * kRS + kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&qa[e]);
          split3(__low2float(x) * scale, __high2float(x) * scale, qp, e);
        }
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t kb[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + (((lane >> 3) & 1) << 3);
          ldsm_x4(kb, kt + 2 * (key * kRS + col));
#pragma unroll
          for (int part = 2; part >= 0; --part) {
            mma_bf16(s[2 * np], qp[part], kb[0], kb[1]);
            mma_bf16(s[2 * np + 1], qp[part], kb[2], kb[3]);
          }
        }
      }

      mask_tile(s, j * kBK, offset + u.row0, sk, g, t);

      // online softmax: m is the running max of the logits
      float mx[2];
      row_max(s, mx);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = __expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dt][i] *= alpha[i >> 1];
      }

      // O += P V, 16 keys a k-step: p = 0 where masked (s = -inf), l sums
      // the f32 p, and P's A fragment of k-step kk, from the accumulators
      // of n8 tiles 2 kk and 2 kk + 1, is split into three parts
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t pp[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* c = s[2 * kk + (e >> 1)];
          const int r = e & 1;
          const float p0 = __expf(c[2 * r] - m[r]);
          const float p1 = __expf(c[2 * r + 1] - m[r]);
          psum[r] += p0 + p1;
          split3(p0, p1, pp, e);
        }
#pragma unroll
        for (int dp = 0; dp < (D + 15) / 16; ++dp) {
          uint32_t vb[4];
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = dp * 16 + ((lane >> 4) << 3);
          ldsm_x4_t(vb, vt + 2 * (key * kRS + col));
#pragma unroll
          for (int part = 2; part >= 0; --part) {
            mma_bf16(acc[2 * dp], pp[part], vb[0], vb[1]);
            if constexpr (D >= 16) {
              mma_bf16(acc[2 * dp + 1], pp[part], vb[2], vb[3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
    }
    if (j + 1 < u.n_tiles) __syncthreads();  // stage j & 1 read by all
  }
  cp_wait<0>();
  __syncthreads();  // every copy landed and every tile read

  // acc / max(l, 1e-30) over the warp's own query rows in shared memory
  row_denominators(l);
  __nv_bfloat16* ow = sm + warp * kRows * kRS + u.hw * R::kVec;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8 * r) * kRS + 8 * dt +
                                         2 * t) =
          __floats2bfloat162_rn(acc[dt][2 * r] / l[r],
                                acc[dt][2 * r + 1] / l[r]);
    }
  }
  __syncthreads();
  store_o<__nv_bfloat16, D>(o, sm, u, pk, sq, n_heads);
  if constexpr (kLse) {
    write_lse<false>(lse + (static_cast<long long>(u.b) * n_heads + u.h0 +
                            u.hw) * sq,
                     m, l, u.row0, g, t, sq);
  }
}

// The same skeleton in f32 (rows of D + 4 floats, 4 floats a cp.async
// piece), the products m16n8k8 TF32, three a product of split operands.
// TF32 fragments (k8): A a[0..3] holds (row g, k t), (g + 8, t), (g,
// t + 4), (g + 8, t + 4); B b[0..1] holds (k t, n g), (k t + 4, n g).
// kLse as in flash_mma_kernel.
template <int D, bool kLse>
__global__ void __launch_bounds__(kMaxWarps * 32, kLse ? 2 : 3)
flash_mma_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int n_heads,
                     int batch, int group, Pack pk, Strides qst, Strides kst,
                     Strides vst, float scale) {
  using R = Rows<float, D>;
  constexpr int kRS = R::kRS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const uint32_t sbase = smem_u32(sm);

  const int warps = pk.sb * pk.hb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Unit u = unit_of(pk, batch, group, sq, sk, warp);
  const int offset = sk - sq;

  const int q_sz = q_elems(kRS, warps, pk.hb, R::kVec);
  const int tile_sz = tile_elems(kRS, R::kVec);
  const int stage_sz = 2 * pk.nkv * tile_sz;
  const uint32_t q_warp = sbase + 4 * (warp * kRows * kRS + u.hw * R::kVec);

  copy_q<float, D>(sbase, q, u, pk, qst, sq);
  if (u.n_tiles > 0) {
    copy_kv<float, D>(sbase + 4 * q_sz, k, v, u, pk, kst, vst, 0, sk,
                      tile_sz);
  }
  cp_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m[2] = {-1e30f, -1e30f};  // the running max of s log2(e)
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < u.n_tiles; ++j) {
    if (j + 1 < u.n_tiles) {
      copy_kv<float, D>(sbase + 4 * (q_sz + ((j + 1) & 1) * stage_sz), k, v,
                        u, pk, kst, vst, j + 1, sk, tile_sz);
    }
    cp_commit();
    cp_wait<1>();     // every group but the newest: tile j (and q)
    __syncthreads();
    if (j < u.my_trips) {
      const int kt_el = q_sz + (j & 1) * stage_sz + u.kvi * tile_sz;
      const uint32_t kt = sbase + 4 * kt_el;
      const float* vs = sm + kt_el + pk.nkv * tile_sz;

      // S = (Q D^-0.5) K^T: per k-step of 8 columns the strip's A
      // fragment, scaled in f32 and split, then per 16 keys K's two B
      // fragments by one ldmatrix, split; three products an n8 tile, the
      // smallest first
      float s[kBK / 8][4];
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t qa[4], qh[4], ql[4];
        const int r = (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4(qa, q_warp + 4 * (r * kRS + kk * 8 + (lane >> 4) * 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split2(__uint_as_float(qa[e]) * scale, qh[e], ql[e]);
        }
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t kb[4], kh[4], kl[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 8 + (((lane >> 3) & 1) << 2);
          ldsm_x4(kb, kt + 4 * (key * kRS + col));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split2(__uint_as_float(kb[e]), kh[e], kl[e]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float(&c)[4] = s[2 * np + n];
            mma_tf32(c, ql, kh[2 * n], kh[2 * n + 1]);
            mma_tf32(c, qh, kl[2 * n], kl[2 * n + 1]);
            mma_tf32(c, qh, kh[2 * n], kh[2 * n + 1]);
          }
        }
      }

      mask_tile(s, j * kBK, offset + u.row0, sk, g, t);

      // online softmax in log2 units
      float mx[2];
      row_max(s, mx);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r] * kLog2e);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }

      // pv = P V into a fresh accumulator, 8 keys a k-step: p = 0 where
      // masked (s = -inf), l sums the f32 p. P's A fragment of k-step kk
      // is n8 tile kk's accumulator as c0, c2, c1, c3 (k index t is key
      // 2t, t + 4 is key 2t + 1), so V's B fragment is V[2t][g] and
      // V[2t + 1][g] of the step's keys and the n8 tile's columns
      float pv[D / 8][4];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0.f;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = ex2(fmaf(s[kk][i], kLog2e, -m[i >> 1]));
        }
        psum[0] += p[0] + p[1];
        psum[1] += p[2] + p[3];
        uint32_t ph[4], pl[4];
        split2(p[0], ph[0], pl[0]);
        split2(p[2], ph[1], pl[1]);
        split2(p[1], ph[2], pl[2]);
        split2(p[3], ph[3], pl[3]);
        const float* v0 = vs + (8 * kk + 2 * t) * kRS + g;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          uint32_t vh[2], vl[2];
          split2(v0[8 * dn], vh[0], vl[0]);
          split2(v0[kRS + 8 * dn], vh[1], vl[1]);
          mma_tf32(pv[dn], pl, vh[0], vh[1]);
          mma_tf32(pv[dn], ph, vl[0], vl[1]);
          mma_tf32(pv[dn], ph, vh[0], vh[1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[dn][i] = fmaf(acc[dn][i], alpha[i >> 1], pv[dn][i]);
        }
      }
    }
    if (j + 1 < u.n_tiles) __syncthreads();  // stage j & 1 read by all
  }
  cp_wait<0>();
  __syncthreads();  // every copy landed and every tile read

  // acc / max(l, 1e-30) over the warp's own query rows in shared memory
  row_denominators(l);
  float* ow = sm + warp * kRows * kRS + u.hw * R::kVec;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float2*>(ow + (g + 8 * r) * kRS + 8 * dt + 2 * t) =
          make_float2(acc[dt][2 * r] / l[r], acc[dt][2 * r + 1] / l[r]);
    }
  }
  __syncthreads();
  store_o<float, D>(o, sm, u, pk, sq, n_heads);
  if constexpr (kLse) {
    write_lse<true>(lse + (static_cast<long long>(u.b) * n_heads + u.h0 +
                           u.hw) * sq,
                    m, l, u.row0, g, t, sq);
  }
}

template <typename T, int D, bool kLse>
auto kernel_of() {
  if constexpr (std::is_same_v<T, float>) {
    return &flash_mma_f32_kernel<D, kLse>;
  } else {
    return &flash_mma_kernel<D, kLse>;
  }
}

// `mp`: the plan's strips and heads a block, KV heads a block, stages and
// shared-memory bytes, checked against the packing they imply. T: f32
// (flash_mma_f32_kernel) or bf16 (flash_mma_kernel).
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int sq, int sk, int n_heads, int group, Strides qst,
           Strides kst, Strides vst, const long long* mp, long long blocks,
           float scale, cudaStream_t stream) {
  constexpr int es = static_cast<int>(sizeof(T));
  Pack pk{static_cast<int>(mp[0]), static_cast<int>(mp[1]),
          static_cast<int>(mp[2]), static_cast<int>(mp[3]), 0, 0};
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (pk.sb < 1 || pk.hb < 1 || pk.sb * pk.hb > kMaxWarps ||
      n_heads % pk.hb != 0) {
    return bad;
  }
  int nkv = 0;
  for (int h0 = 0; h0 < n_heads; h0 += pk.hb) {
    const int n = (h0 + pk.hb - 1) / group - h0 / group + 1;
    nkv = n > nkv ? n : nkv;
  }
  pk.n_sg = ((sq + kRows - 1) / kRows + pk.sb - 1) / pk.sb;
  pk.n_hg = n_heads / pk.hb;
  const int stages = (sk + kBK - 1) / kBK > 1 ? 2 : 1;
  const int warps = pk.sb * pk.hb;
  const int smem = smem_bytes(D, es, warps, pk.hb, nkv, stages);
  if (pk.nkv != nkv || pk.stages != stages || mp[4] != smem ||
      static_cast<long long>(pk.n_sg) * pk.n_hg * batch != blocks) {
    return bad;
  }
  // the training instantiation where the caller asks for the lse
  const bool with_lse = lse != nullptr;
  const auto kernel = with_lse ? kernel_of<T, D, true>()
                               : kernel_of<T, D, false>();
  static std::atomic<unsigned long long> opted[2];
  const cudaError_t err = tc::opt_in(
      kernel, smem_bytes(D, es, kMaxWarps, kMaxWarps, kMaxWarps, 2),
      opted[with_lse]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, n_heads,
      batch, group, pk, qst, kst, vst, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mk
}  // namespace

// q: (batch, sq, n_heads, d) and k, v: (batch, sk, n_kv_heads, d), each
// with a contiguous last dim; o: (batch, sq, n_heads, d) contiguous. `plan`
// is the host's launch plan (kernels/flash_attention.py: FlashPlan.args),
// 51 values: batch, sq, sk, n_heads, n_kv_heads, d, dtype (0 = float32,
// 1 = bfloat16), design (0 = the bf16 tensor-core kernel, d 64, 112 and
// 128; 1 = the mma_f32 kernel, f32 at d 8, 16 and 32; 2 = the f32
// tensor-core kernel, d 64, 112 and 128; 3 = the mma kernel, bf16 at d 8,
// 16 and 32), query tiles per head (designs 0 and 2; designs 1 and 3:
// their block count), the element strides (batch, seq, head) of q, k and
// v, then the q, k and v tensor maps, 11 values each (design 0; design 2:
// k and v); designs 1 and 3 append 5 values, their packing (mk::launch).
// `lse`: null, or the
// (batch, n_heads, sq) f32 log-sum-exp of every query row, written by
// every design (the training forward; flash_attention_bwd.cu reads it).
// Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape, type or plan
// the kernels do not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const long long* plan, float scale,
                                      void* stream) {
  const int batch = static_cast<int>(plan[0]), sq = static_cast<int>(plan[1]),
            sk = static_cast<int>(plan[2]),
            n_heads = static_cast<int>(plan[3]),
            n_kv_heads = static_cast<int>(plan[4]),
            d = static_cast<int>(plan[5]), dtype = static_cast<int>(plan[6]),
            design = static_cast<int>(plan[7]),
            n_q_tiles = static_cast<int>(plan[8]);
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || (dtype != 0 &&
                                                       dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = d == 64 || d == 112 || d == 128;
  if (design != (wide ? (dtype == 1 ? 0 : 2) : (dtype == 1 ? 3 : 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || sq <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int group = n_heads / n_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
  const long long* maps = plan + 18;
  const Strides qst{plan[9], plan[10], plan[11]},
      kst{plan[12], plan[13], plan[14]}, vst{plan[15], plan[16], plan[17]};
  if (design == 0) {
    const auto fn = d == 64    ? &tc::launch<64>
                    : d == 112 ? &tc::launch<112>
                               : &tc::launch<128>;
    return fn(q, k, v, o, lse, batch, sq, sk, n_heads, group, maps,
              n_q_tiles, scale, s);
  }
  if (design == 2) {
    const auto fn = d == 64    ? &tf::launch<64>
                    : d == 112 ? &tf::launch<112>
                               : &tf::launch<128>;
    return fn(q, qst, k, v, o, lse, batch, sq, sk, n_heads, group, maps,
              n_q_tiles, scale, s);
  }
  // designs 1 (f32) and 3 (bf16): the mma kernels at d 8, 16 and 32
  const long long* mp = plan + 51;
  const auto fn = design == 1 ? (d == 8    ? &mk::launch<float, 8>
                                 : d == 16 ? &mk::launch<float, 16>
                                           : &mk::launch<float, 32>)
                              : (d == 8    ? &mk::launch<__nv_bfloat16, 8>
                                 : d == 16 ? &mk::launch<__nv_bfloat16, 16>
                                           : &mk::launch<__nv_bfloat16, 32>);
  if (d != 8 && d != 16 && d != 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(q, k, v, o, lse, batch, sq, sk, n_heads, group, qst, kst, vst, mp,
            plan[8], scale, s);
}
