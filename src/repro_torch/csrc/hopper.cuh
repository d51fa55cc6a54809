// Hopper building blocks shared by the flash attention kernels
// (flash_attention.cu's wgmma forward kernels, flash_attention_bwd.cu's
// wgmma backward kernels): shared-memory addresses, mbarriers, TMA tensor
// loads and the host-side tensor-map encoding, wgmma shared-memory
// descriptors of 128-byte-swizzled tiles, the wgmma fences, commit and
// wait, the bf16 product with its A operand in registers (and the packing
// of its bf16 pairs), exp2, the f32 operands' TF32 parts, swizzled f32
// tile offsets, named barriers and proxy fences, the TF32 products, the
// dynamic shared-memory opt-in, and the mma designs' packing, copies and
// mma.sync products (namespace strip).
// Everything here is for sm_90a.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map (D, heads, S, B) into shared memory; the bytes
// complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), and the
// swizzle mode in bits 62-63 (1 = 128 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (rows contiguous along the product's depth: Q or K as A
// or B of Q K^T): rows of 128 bytes, 8-row groups 1024 bytes apart; a k16
// step moves 32 bytes along the row.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// MN-major B operand (rows along the product's depth, contiguous along
// its N: V of P V, as TMA stores it): 64 bf16 columns per 128-byte row,
// 8-row groups 1024 bytes apart, the next 64 columns `box` bytes on (one
// TMA box of the tile's rows); a k16 step moves 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t box) {
  return smem_desc(addr, box, 1024);
}

// 2^x by the fast approximate unit (the softmax in log2 units).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 pair as the 32-bit register that an A fragment takes.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Returns once at most the N most recently committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, bf16 in registers) * B (16 x N, smem,
// MN-major), N 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

// ---------------------------------------------------------------------------
// f32 operands on the tensor cores: TF32 parts, 128-byte-swizzled f32 tiles
// that the producer warpgroups write, and the TF32 products (the f32 wgmma
// forward in flash_attention.cu, the f32 backward in flash_attention_bwd.cu)
// ---------------------------------------------------------------------------

// x rounded to TF32 (to nearest, ties away from zero), as f32 with the
// low 13 bits clear: what wgmma reads of it is all of it. An f32 operand
// x enters a product as hi = tf32(x) and lo = tf32(x - hi).
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// Generic-proxy writes to shared memory made visible to wgmma's reads
// (the async proxy), and the reads before a TMA overwrite ordered.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A named barrier over `threads` threads (a warpgroup's 128).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of f32 element (row, col) in a K-major tile of `kRows` rows
// whose columns go in boxes of 32 (128 bytes a row, one TMA box each),
// 128-byte swizzled: the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <int kRows>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (col >> 5) * (kRows * 128) + row * 128 +
         ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// D (64 x N, f32) (+)= A (64 x 8, smem) * B (N x 8, smem)^T, TF32, both
// K-major; N 16 or 32.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32, "N is 16 or 32");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// D (64 x N, f32) (+)= A (64 x 8, registers) * B (N x 8, smem, K-major)^T,
// TF32; N 32, 64 or 128. Register e of A holds row 8 (e & 1) + the
// thread's row, column (lane & 3) + 4 (e >> 1).
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "N is 32, 64 or 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
}

// A (B, S, heads, D) tensor's element strides; the head dim is contiguous.
struct Strides {
  long long b, s, h;
};

// The head dim of a wgmma kernel's tiles for a tensor's head dim `d`: D 112
// (kimi-k2's) runs in D 128's layout and products, its columns past 112
// zero in shared memory (TMA fills a box's columns past the tensor's last
// with zeros, and the f32 forward's q loop writes zeros there), so they add
// nothing to a product over D and give output columns that are never
// stored.
__host__ __device__ constexpr int tile_d(int d) { return d == 112 ? 128 : d; }

// ---------------------------------------------------------------------------
// The mma designs (flash_attention.cu's flash_mma_kernel and
// flash_mma_f32_kernel, flash_attention_bwd.cu's mma backward): a warp owns
// a 16-row strip of one (head, batch), a block packs several strips and
// heads (kernels/flash_attention.py: mma_plan), rows come into padded
// shared-memory rows by 16-byte cp.async copies, and the products are
// warp-level mma.sync on the tensor cores.
// ---------------------------------------------------------------------------

namespace strip {

constexpr int kRows = 16;      // rows a warp owns: one m16 strip
constexpr int kBK = 32;        // rows of a tile a strip visits (keys of the
                               // forward and dq; queries of dkdv)
constexpr int kMaxWarps = 8;
constexpr int kVecBytes = 16;  // a cp.async piece; also the padding past
                               // each shared row and each head's skew

// The plan's packing (kernels/flash_attention.py: MmaPlan): strips and
// heads a block, the most tile heads a block reads, tile stages, strip and
// head groups.
struct Pack {
  int sb, hb, nkv, stages, n_sg, n_hg;
};

// A head's row of D elements of T in shared memory: kVec elements (16
// bytes) a piece, padded by one piece.
template <typename T, int D>
struct Rows {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kVec = kVecBytes / kEs;
  static constexpr int kRS = D + kVec;  // bf16: 80 or 48 bytes; f32: 144
                                        // or 80
  static constexpr int kCh = D / kVec;  // pieces of a head's row
};

// Shared memory in elements, rows of rs = D + pad (pad: one 16-byte
// piece): the block's strip rows (warp w = hw * sb + sw at rows 16 w,
// head hw's rows skewed by hw * pad); a tile of kBK rows of one head.
__host__ __device__ constexpr int q_elems(int rs, int warps, int hb,
                                          int pad) {
  return warps * kRows * rs + hb * pad;
}
__host__ __device__ constexpr int tile_elems(int rs, int pad) {
  return kBK * rs + pad;
}
// bytes of the forward's layout at element size es: the strip rows, then
// per stage the K tiles of the KV heads and their V tiles
__host__ __device__ constexpr int smem_bytes(int d, int es, int warps,
                                             int hb, int nkv, int stages) {
  return es * (q_elems(d + kVecBytes / es, warps, hb, kVecBytes / es) +
               stages * 2 * nkv *
                   tile_elems(d + kVecBytes / es, kVecBytes / es));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !ok
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, which lands in r[i]: lane (g, t) receives the 32 bits t of
// row g (two bf16, or one f32).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// The same, transposed: lane (g, t) receives elements g of rows 2t and
// 2t + 1 (bf16).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// C (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
// Fragments (g = lane / 4, t = lane % 4): C holds row g in c[0..1]
// (columns 2t, 2t + 1) and row g + 8 in c[2..3]; A holds (row g, k 2t..),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B (k 2t.., n g),
// (k 2t + 8.., n g).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col). A holds
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, n g),
// (k t + 4, n g).
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Key tiles that the query rows up to `last` (past Sq: up to the last
// row) visit: those holding keys up to its position, none when it
// precedes every key.
__device__ __forceinline__ int trips(int last, int sq, int sk) {
  const int q_last = sk - sq + min(last, sq - 1);
  return q_last < 0 ? 0 : min(q_last / kBK + 1, (sk + kBK - 1) / kBK);
}

// What a block and one of its warps own. blockIdx.x -> (strip group, head
// group, batch), as mma_units; warp w takes strip w % sb of head w / sb of
// the block.
struct Unit {
  int b, h0, kv0, nkv;   // batch; the block's first head and KV head, and
                         // its KV heads
  int rows, row_blk;     // the block's strip rows and its first row
  int hw, row0, kvi;     // the warp's head in the block, first row, KV head
  int my_trips, n_tiles; // key tiles of the warp's strip and of the block
};

__device__ __forceinline__ Unit unit_of(const Pack& pk, int batch, int group,
                                        int sq, int sk, int warp) {
  Unit u;
  const int per = pk.n_hg * batch;
  const int bid = static_cast<int>(blockIdx.x);
  const int sg = pk.n_sg - 1 - bid / per;
  u.h0 = bid % per % pk.n_hg * pk.hb;
  u.b = bid % per / pk.n_hg;
  u.kv0 = u.h0 / group;
  u.nkv = (u.h0 + pk.hb - 1) / group - u.kv0 + 1;
  u.rows = pk.sb * kRows;
  u.row_blk = sg * u.rows;
  u.hw = warp / pk.sb;
  u.row0 = u.row_blk + (warp % pk.sb) * kRows;
  u.kvi = (u.h0 + u.hw) / group - u.kv0;
  u.my_trips = u.row0 < sq ? trips(u.row0 + kRows - 1, sq, sk) : 0;
  u.n_tiles = trips(u.row_blk + u.rows - 1, sq, sk);
  return u;
}

// The block's strip rows of x into shared memory at sbase: piece ch of
// head hh (u.h0 + hh) of row r, zero past n_rows.
template <typename T, int D>
__device__ __forceinline__ void copy_q(uint32_t sbase, const T* x,
                                       const Unit& u, const Pack& pk,
                                       Strides st, int n_rows) {
  using R = Rows<T, D>;
  const int n_q = u.rows * pk.hb * R::kCh;
  for (int c = threadIdx.x; c < n_q; c += blockDim.x) {
    const int ch = c % R::kCh;
    const int hh = c / R::kCh % pk.hb;
    const int r = c / (R::kCh * pk.hb);
    const int qi = u.row_blk + r;
    const bool ok = qi < n_rows;
    cp16(sbase + R::kEs * ((hh * u.rows + r) * R::kRS + hh * R::kVec +
                              ch * R::kVec),
         x + u.b * st.b + (ok ? qi : 0) * st.s + (u.h0 + hh) * st.h +
             ch * R::kVec,
         ok);
  }
}

// Tile j (kBK rows) of u.nkv heads (u.kv0 on) of a and of b into the stage
// at at (the a tiles, then pk.nkv b tiles of tile_sz elements), zero past
// n_rows.
template <typename T, int D>
__device__ __forceinline__ void copy_kv(uint32_t at, const T* a, const T* b,
                                        const Unit& u, const Pack& pk,
                                        Strides ast, Strides bst, int j,
                                        int n_rows, int tile_sz) {
  using R = Rows<T, D>;
  const uint32_t bt = at + R::kEs * pk.nkv * tile_sz;
  const int n = kBK * u.nkv * R::kCh;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int ch = c % R::kCh;
    const int i = c / R::kCh % u.nkv;
    const int r = c / (R::kCh * u.nkv);
    const int kj = j * kBK + r;
    const bool ok = kj < n_rows;
    const long long row = ok ? kj : 0;
    const uint32_t dst = R::kEs * (i * tile_sz + r * R::kRS + ch * R::kVec);
    cp16(at + dst,
         a + u.b * ast.b + row * ast.s + (u.kv0 + i) * ast.h + ch * R::kVec,
         ok);
    cp16(bt + dst,
         b + u.b * bst.b + row * bst.s + (u.kv0 + i) * bst.h + ch * R::kVec,
         ok);
  }
}

}  // namespace strip

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the kernel libraries link only
// the CUDA runtime, so it is looked up once through the runtime's
// entry-point query.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// g: a plan's map (kernels/flash_attention.py: TensorMap.packed): dims
// (D, heads, S, B), byte strides of dims 1-3, box (cols, 1, rows, 1) with
// `cols` one 128-byte swizzle row of the element type.
inline bool encode(CUtensorMap* map, const void* ptr, const long long* g,
                   int d, CUtensorMapDataType type, int cols, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || g[0] != d || g[7] != cols || g[8] != 1 ||
      g[9] != rows || g[10] != 1) {
    return false;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g[0]),
                              static_cast<cuuint64_t>(g[1]),
                              static_cast<cuuint64_t>(g[2]),
                              static_cast<cuuint64_t>(g[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(g[4]),
                                 static_cast<cuuint64_t>(g[5]),
                                 static_cast<cuuint64_t>(g[6])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Above 48 KB a launch needs the opt-in, once per card per kernel (a bit
// per device below 64; others opt in on every call).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem,
                   std::atomic<unsigned long long>& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (opted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) opted.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace hopper
