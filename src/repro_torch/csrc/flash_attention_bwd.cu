// Causal grouped-query flash attention, backward (the FlashAttention-2
// algorithm, P recomputed from q, k and the forward's log-sum-exp):
//   s_ij   = q_i . k_j D^-0.5,  P_ij = exp(s_ij - lse_i), 0 where masked
//   delta_i = dO_i . o_i                                   (delta kernel)
//   dV_j   = sum_i P_ij dO_i                                (dkdv kernels)
//   dS_ij  = P_ij (dO_i . v_j - delta_i)
//   dK_j   = D^-0.5 sum_i dS_ij q_i                         (dkdv kernels)
//   dQ_i   = D^-0.5 sum_j dS_ij k_j                         (dq kernels)
// with q, o, dO (B, Sq, H, D), k and v (B, Sk, K, D), H = K * G, f32 or
// bf16, D 64 or 128, the queries the last Sq positions of the key axis
// (key j visible to query i when j <= i + Sk - Sq), lse (B, H, Sq) f32 from
// flash_attention.cu's wgmma kernels (m + log(max(l, 1e-30)); -1e30 for a
// row that sees no key). dK and dV of a KV head sum over the G query heads
// that read it. A masked pair, and a row that sees no key, add exactly 0.
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
// bf16 tensor-core rate of 989.4 TFLOP/s. Two kernels rather than dQ
// folded into the dkdv pass with f32 atomics: 7 products a tile pair
// instead of 5, but deterministic gradients.
//
// Two designs, by dtype (kernels/flash_attention.py: bwd_plan):
//
// * bf16: flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel, on
//   the tensor cores, the skeleton of flash_attention.cu's
//   flash_wgmma_kernel: warpgroup 0 the producer (one thread issues TMA
//   loads of 128-byte-swizzled boxes into a ring of stages, each with a
//   full and an empty mbarrier; it gives its registers away by setmaxnreg
//   where there are two consumers), 64-row consumer warpgroups, blocks
//   heaviest first, masks only on tiles that cross the diagonal, Sq or
//   Sk. P and dS are formed in f32 on the accumulator fragment, and enter
//   the register-A (RS) products as two bf16 parts, hi = bf16(x) and lo =
//   bf16(x - hi), each its own wgmma: hi + lo is x to 2^-17, and the other
//   operand is a bf16 input, so each product is exact in f32 and only the
//   order of the f32 sums differs from the plain version's; the outputs
//   round once to bf16. P rounded to bf16 once (FlashAttention-2/3) would
//   move outputs by several bf16 ulps from the f32-P gradient. The price:
//   dkdv issues 6 product units a tile pair against the 4 of its bound, dq
//   4 against 3.
//   - dkdv: a block per (key tile, KV head, batch), key tile 0 (the most
//     query tiles) first; 128 keys and two consumers at D 64, 64 keys and
//     one consumer at D 128 (dK and dV alone are 128 registers a thread
//     there). The block loads its K and V tile once; the producer streams,
//     for each of the G query heads and each 64-row query tile from the
//     first that sees the block's keys (bwd_plan.first_q_tile), the q and
//     dO tiles by TMA, while producer warp 1 copies the tile's lse (log2
//     units) and delta rows into the stage. Each consumer takes its 64
//     keys as the M side: S^T = K q^T and dP^T = V dO^T as SS wgmma
//     m64n64k16 (K and V the K-major A operand as stored, q and dO the
//     K-major B operand as stored), P^T = exp2(S^T D^-0.5 log2(e) - lse)
//     and dS^T = P^T (dP^T - delta) on the accumulator, the query the
//     column (lse and delta read per column from shared memory), then dV
//     += P^T dO and dK += dS^T q as RS wgmma m64nDk16, the A fragments the
//     accumulator's registers packed as the forward packs P, dO and q read
//     from the same stage as the MN-major B operand (the forward's V).
//     The products go in three commit groups so that the exp and the
//     splits overlap the tensor cores: S^T, then dP^T (P^T is formed while
//     it runs), then dV (dS^T is formed while it runs), then dK. A tile
//     where all of a consumer's keys follow all its queries is skipped. dK and dV stay in f32 registers across all G x query-tile
//     trips and are written once, dK times D^-0.5, with no atomics: the
//     result does not depend on block order. Shared memory: 83 KB at D 64
//     (3 stages), 131 KB at D 128.
//   - dq: a block per (128-row query tile, head, batch), the last tile
//     first, two consumers of 64 rows; q and dO load once, each 64-key K
//     and V tile streams through a two-stage ring over the causal key
//     tiles. S = q K^T and dP = dO V^T as SS wgmma in two commit groups
//     (P formed while dP runs), dS in registers, dQ += dS K as RS wgmma
//     with K the MN-major B operand; dQ written once, times D^-0.5. Shared memory: 65 KB at D 64, 129 KB at D 128.
// * f32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, the first design
//   (f32 FMAs on the CUDA cores, 67 TFLOP/s peak), kept for f32 until a
//   tensor-core f32 backward (three TF32 products) is written. 256
//   threads a block, 64-row query tiles and 64-key tiles, converted to f32
//   into shared memory with rows padded to D + 4 floats (the float4 reads
//   of 8 neighbouring rows fall in 8 distinct 16-byte bank groups). A
//   thread (ty = tid / 16, tx = tid % 16) owns the 4 x 4 elements (ty + 16
//   a, tx + 16 b) of each 64 x 64 product S and dP, taken as dot products
//   over D in float4 steps, and rows ty + 16 a, columns 4 tx + 64 c .. + 3
//   of each 64 x D accumulator (dK and dV, or dQ), taken as outer
//   products over the tile's rows (P and dS from shared memory). The
//   block geometry and order are the bf16 design's at 64 keys: dkdv a
//   block per (key tile, KV head, batch) over the G heads' query tiles
//   from the first that sees its keys, dK and dV in registers, written
//   once; dq a block per (query tile, head, batch), the last first.
//   Operands are read through their (batch, seq, head) strides, four
//   elements a load: base and strides must be multiples of 4 elements
//   (the wrapper copies an operand that is not).
// * flash_bwd_delta_kernel (either dtype): D / 4 threads a row, four
//   elements each, a shuffle reduction; (B, H, Sq) f32.
//
// The wgmma kernels read q, k, v and dO by TMA: every base and stride a
// multiple of 16 bytes, the head dim contiguous; the wrapper copies an
// operand that is not (a scalar loss's zero-stride dO among them).
#include <cuda_bf16.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows a tile
constexpr int kBK = 64;  // keys a tile
constexpr int kPS = kBK + 4;  // row pitch of the P / dS tiles (floats)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

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
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

template <int D>
struct Tiles {
  static constexpr int kP = D + 4;  // row pitch of a q / k / v / dO tile
  static constexpr int kTile = 64 * kP;
  static constexpr int kC = D / 64;  // float4 columns a thread owns, / 16
};

// rows [r0, r0 + 64) of one head of a (B, S, heads, D) tensor into a
// padded f32 tile; zeros from row n on
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int kPer = D / 4;
  for (int c = threadIdx.x; c < 64 * kPer; c += kThreads) {
    const int r = c / kPer;
    const int col = 4 * (c % kPer);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(src + (r0 + r) * row_stride + col);
    store4(dst + r * Tiles<D>::kP + col, x);
  }
}

// lse (in log2 units) and delta of query rows [q0, q0 + 64) of one (b, h)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int sq) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool ok = q0 + i < sq;
    lse_s[i] = ok ? lse[q0 + i] * kLog2e : 0.f;
    delta_s[i] = ok ? delta[q0 + i] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T at (ty + 16 a, tx + 16 b), unscaled
template <int D>
__device__ __forceinline__ void dots(float (&s)[4][4], float (&dp)[4][4],
                                     const float* qs, const float* dos,
                                     const float* ks, const float* vs,
                                     int ty, int tx) {
  constexpr int P = Tiles<D>::kP;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = lds4(qs + (ty + 16 * a) * P + d);
      da[a] = lds4(dos + (ty + 16 * a) * P + d);
      kb[a] = lds4(ks + (tx + 16 * a) * P + d);
      vb[a] = lds4(vs + (tx + 16 * a) * P + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = dot4(s[a][b], qa[a], kb[b]);
        dp[a][b] = dot4(dp[a][b], da[a], vb[b]);
      }
    }
  }
}

// P and dS of the tile's (ty + 16 a, tx + 16 b): 0 past Sq or Sk and past
// the diagonal
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_s,
                                      const float* delta_s, int ty, int tx,
                                      int q0, int k0, const Shape& sh,
                                      float scale_log2) {
  const int offset = sh.sk - sh.sq;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const int row = q0 + i;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int key = k0 + tx + 16 * b;
      const bool ok = row < sh.sq && key < sh.sk && key <= row + offset;
      const float p = ok ? ex2(fmaf(s[a][b], scale_log2, -lse_s[i])) : 0.f;
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - delta_s[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, Strides qst,
                      const T* __restrict__ k, Strides kst,
                      const T* __restrict__ v, Strides vst,
                      const T* __restrict__ dO, Strides dst,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Shape sh, float scale) {
  using L = Tiles<D>;
  constexpr int P = L::kP;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + L::kTile;
  float* qs = vs + L::kTile;
  float* dos = qs + L::kTile;
  float* ps = dos + L::kTile;   // P, [query row][key]
  float* dss = ps + kBQ * kPS;  // dS, [query row][key]
  float* lse_s = dss + kBQ * kPS;
  float* delta_s = lse_s + kBQ;

  const int per = sh.n_kv_heads * sh.batch;
  const int kt = static_cast<int>(blockIdx.x) / per;
  const int kvh = static_cast<int>(blockIdx.x) % per % sh.n_kv_heads;
  const int b = static_cast<int>(blockIdx.x) % per / sh.n_kv_heads;
  const int k0 = kt * kBK;
  const int offset = sh.sk - sh.sq;
  const int n_q_tiles = (sh.sq + kBQ - 1) / kBQ;
  const int first = max(k0 - offset, 0) / kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float scale_log2 = scale * kLog2e;

  load_tile<T, D>(ks, k + b * kst.b + kvh * kst.h, kst.s, k0, sh.sk);
  load_tile<T, D>(vs, v + b * vst.b + kvh * vst.h, vst.s, k0, sh.sk);

  float4 acc_k[4][L::kC], acc_v[4][L::kC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c) {
      acc_k[a][c] = acc_v[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int g = 0; g < sh.group; ++g) {
    const int h = kvh * sh.group + g;
    const long long rows = (static_cast<long long>(b) * sh.n_heads + h) *
                           sh.sq;
    for (int qt = first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's P, dS, q and dO are read
      load_tile<T, D>(qs, q + b * qst.b + h * qst.h, qst.s, q0, sh.sq);
      load_tile<T, D>(dos, dO + b * dst.b + h * dst.h, dst.s, q0, sh.sq);
      load_rows(lse_s, delta_s, lse + rows, delta + rows, q0, sh.sq);
      __syncthreads();

      float s[4][4], dp[4][4];
      dots<D>(s, dp, qs, dos, ks, vs, ty, tx);
      probs(s, dp, lse_s, delta_s, ty, tx, q0, k0, sh, scale_log2);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          ps[(ty + 16 * a) * kPS + tx + 16 * bb] = s[a][bb];
          dss[(ty + 16 * a) * kPS + tx + 16 * bb] = dp[a][bb];
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T q: this thread's keys ty + 16 a
      const int n_rows = min(kBQ, sh.sq - q0);
      for (int i = 0; i < n_rows; ++i) {
        float pj[4], dsj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = ps[i * kPS + ty + 16 * a];
          dsj[a] = dss[i * kPS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < L::kC; ++c) {
          const float4 dov = lds4(dos + i * P + 4 * tx + 64 * c);
          const float4 qv = lds4(qs + i * P + 4 * tx + 64 * c);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            axpy4(acc_v[a][c], pj[a], dov);
            axpy4(acc_k[a][c], dsj[a], qv);
          }
        }
      }
    }
  }

  // dK and dV of keys < Sk: (B, Sk, K, D) contiguous
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= sh.sk) continue;
    const long long off =
        ((static_cast<long long>(b) * sh.sk + key) * sh.n_kv_heads + kvh) * D;
#pragma unroll
    for (int c = 0; c < L::kC; ++c) {
      float4 x = acc_k[a][c];
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      store4(dk + off + 4 * tx + 64 * c, x);
      store4(dv + off + 4 * tx + 64 * c, acc_v[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, Strides qst,
                    const T* __restrict__ k, Strides kst,
                    const T* __restrict__ v, Strides vst,
                    const T* __restrict__ dO, Strides dst,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Shape sh, float scale) {
  using L = Tiles<D>;
  constexpr int P = L::kP;
  constexpr int kPT = kBQ + 4;  // row pitch of dS^T
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + L::kTile;
  float* ks = dos + L::kTile;
  float* vs = ks + L::kTile;
  float* dst_s = vs + L::kTile;  // dS^T, [key][query row]
  float* lse_s = dst_s + kBK * kPT;
  float* delta_s = lse_s + kBQ;

  const int per = sh.n_heads * sh.batch;
  const int n_q_tiles = (sh.sq + kBQ - 1) / kBQ;
  const int qt = n_q_tiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = static_cast<int>(blockIdx.x) % per % sh.n_heads;
  const int b = static_cast<int>(blockIdx.x) % per / sh.n_heads;
  const int kvh = h / sh.group;
  const int q0 = qt * kBQ;
  const int offset = sh.sk - sh.sq;
  // causal trip count: the key tiles up to the tile's last row's position
  const int q_last = offset + min(q0 + kBQ, sh.sq) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min(q_last / kBK + 1, (sh.sk + kBK - 1) / kBK);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float scale_log2 = scale * kLog2e;
  const long long rows =
      (static_cast<long long>(b) * sh.n_heads + h) * sh.sq;

  load_tile<T, D>(qs, q + b * qst.b + h * qst.h, qst.s, q0, sh.sq);
  load_tile<T, D>(dos, dO + b * dst.b + h * dst.h, dst.s, q0, sh.sq);
  load_rows(lse_s, delta_s, lse + rows, delta + rows, q0, sh.sq);

  float4 acc[4][L::kC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c) acc[a][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's K and dS^T are read
    load_tile<T, D>(ks, k + b * kst.b + kvh * kst.h, kst.s, k0, sh.sk);
    load_tile<T, D>(vs, v + b * vst.b + kvh * vst.h, vst.s, k0, sh.sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    dots<D>(s, dp, qs, dos, ks, vs, ty, tx);
    probs(s, dp, lse_s, delta_s, ty, tx, q0, k0, sh, scale_log2);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        dst_s[(tx + 16 * bb) * kPT + ty + 16 * a] = dp[a][bb];
      }
    }
    __syncthreads();

    // dQ += dS K: this thread's query rows ty + 16 a
    const int n_keys = min(kBK, sh.sk - k0);
    for (int jj = 0; jj < n_keys; ++jj) {
      float dsj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsj[a] = dst_s[jj * kPT + ty + 16 * a];
#pragma unroll
      for (int c = 0; c < L::kC; ++c) {
        const float4 kv = lds4(ks + jj * P + 4 * tx + 64 * c);
#pragma unroll
        for (int a = 0; a < 4; ++a) axpy4(acc[a][c], dsj[a], kv);
      }
    }
  }

  // dQ of rows < Sq: (B, Sq, H, D) contiguous; rows that see no key get 0
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sh.sq) continue;
    const long long off =
        ((static_cast<long long>(b) * sh.sq + row) * sh.n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < L::kC; ++c) {
      float4 x = acc[a][c];
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      store4(dq + off + 4 * tx + 64 * c, x);
    }
  }
}

// delta[(b H + h) Sq + i] = dO[b, i, h, :] . o[b, i, h, :], D / 4 threads
// a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, Strides ost,
                       const T* __restrict__ dO, Strides dst,
                       float* __restrict__ delta, Shape sh) {
  constexpr int kLanes = D / 4;
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
    acc = dot4(0.f, load4(o + b * ost.b + i * ost.s + h * ost.h + 4 * lane),
               load4(dO + b * dst.b + i * dst.s + h * dst.h + 4 * lane));
  }
#pragma unroll
  for (int w = kLanes / 2; w > 0; w /= 2) {
    acc += __shfl_xor_sync(repro::kFullMask, acc, w);
  }
  if (r < n_rows && lane == 0) delta[r] = acc;
}

template <int D>
constexpr int dkdv_smem() {
  return (4 * Tiles<D>::kTile + 2 * kBQ * kPS + 2 * kBQ) * 4;
}
template <int D>
constexpr int dq_smem() {
  return (4 * Tiles<D>::kTile + kBK * (kBQ + 4) + 2 * kBQ) * 4;
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

// flash_bwd_dkdv_wgmma_kernel's geometry. Shared memory from a 1024-byte
// aligned base: the block's K and V tiles (D / 64 boxes of kBK rows each),
// then per stage a q and a dO tile (D / 64 boxes of kBQ rows each), then
// per stage the tile's lse (log2 units) and delta rows, then the
// mbarriers: K/V full, then full and empty per stage.
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
  static constexpr int kAlloc = kBars + 8 * (1 + 2 * kStages) + 1024;
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

// The A fragment of k-step kk of a part: registers 4 kk .. 4 kk + 3.
__device__ __forceinline__ void frag(const uint32_t (&part)[16], int kk,
                                     uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = part[4 * kk + e];
}

// blockIdx.x -> (key tile, KV head, batch), key tile 0 (the most query
// tiles) first (kernels/flash_attention.py: BwdPlan).
template <int D>
__global__ void __launch_bounds__(Dkdv<D>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Shape sh,
                            float scale) {
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

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

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
    }

    // dK (times D^-0.5) and dV of keys < Sk, (B, Sk, K, D) contiguous
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r0 + 8 * r;
      if (key >= sh.sk) continue;
      const long long off =
          ((static_cast<long long>(b) * sh.sk + key) * sh.n_kv_heads + kvh) *
          D;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
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
template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, Shape sh,
                          float scale) {
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

    // dQ (times D^-0.5) of rows < Sq, (B, Sq, H, D) contiguous; rows that
    // see no key get 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= sh.sq) continue;
      __nv_bfloat16* out =
          dq + ((static_cast<long long>(b) * sh.sq + row) * sh.n_heads + h) *
                   D;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jb + col0) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
      }
    }
  }
}

}  // namespace wg

// plan (kernels/flash_attention.py: BwdPlan.args), 114 values: batch, sq,
// sk, n_heads, n_kv_heads, d, dtype (0 f32, 1 bf16), the dkdv kernel's
// query tiles and key tiles, the (batch, seq, head) element strides of q,
// k, v, o and dO, the design (0: the CUDA-core kernels, f32; 1: the wgmma
// kernels, bf16), the dq kernel's query tiles, then the TMA maps of q, k,
// v and dO for the dkdv kernel and again for the dq kernel, 11 values
// each (design 1; zeros for design 0)
constexpr int kPlanMaps = 26;
constexpr int kMapLongs = 11;

struct Args {
  Shape sh;
  int d, dtype, n_q_tiles, n_k_tiles, design, dq_q_tiles;
  Strides qst, kst, vst, ost, dst;
};

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
  if (a.sh.n_kv_heads <= 0 || a.sh.n_heads % a.sh.n_kv_heads != 0 ||
      (a.d != 64 && a.d != 128) || (a.dtype != 0 && a.dtype != 1) ||
      a.design != a.dtype || a.sh.batch <= 0 || a.sh.sq <= 0 ||
      a.sh.sk <= 0) {
    return false;
  }
  // the tiles of the design's kernels
  const int bq = kBQ;
  const int bk = a.design == 0 ? kBK : (a.d == 64 ? wg::Dkdv<64>::kBK
                                                  : wg::Dkdv<128>::kBK);
  const int dq_bq = a.design == 0 ? kBQ : wg::Dq<64>::kBQ;
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
  constexpr int rows_per_block = kThreads / (D / 4);
  const long long n_rows =
      static_cast<long long>(a.sh.batch) * a.sh.n_heads * a.sh.sq;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(static_cast<const T*>(o), a.ost,
                                      static_cast<const T*>(dO), a.dst, delta,
                                      a.sh);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkdv_launch(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* delta, void* dk, void* dv,
                const Args& a, float scale, cudaStream_t s) {
  constexpr int smem = dkdv_smem<D>();
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err =
      hopper::opt_in(flash_bwd_dkdv_kernel<float, D>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.n_k_tiles) * a.sh.n_kv_heads * a.sh.batch;
  flash_bwd_dkdv_kernel<float, D><<<static_cast<unsigned>(blocks), kThreads,
                                    smem, s>>>(
      static_cast<const float*>(q), a.qst, static_cast<const float*>(k),
      a.kst, static_cast<const float*>(v), a.vst,
      static_cast<const float*>(dO), a.dst, lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), a.sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, const Args& a,
              float scale, cudaStream_t s) {
  constexpr int smem = dq_smem<D>();
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err =
      hopper::opt_in(flash_bwd_dq_kernel<float, D>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.n_q_tiles) * a.sh.n_heads * a.sh.batch;
  flash_bwd_dq_kernel<float, D><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, s>>>(
      static_cast<const float*>(q), a.qst, static_cast<const float*>(k),
      a.kst, static_cast<const float*>(v), a.vst,
      static_cast<const float*>(dO), a.dst, lse, delta,
      static_cast<float*>(dq), a.sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// The four TMA maps of q, k, v and dO at `maps` (11 values each), with
// boxes of `bq` query rows and `bk` keys; false where a map does not
// encode or does not name those boxes.
template <int D>
bool encode_qkvd(CUtensorMap (&m)[4], const void* q, const void* k,
                 const void* v, const void* dO, const long long* maps, int bq,
                 int bk) {
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return hopper::encode(&m[0], q, maps, D, kBf16, wg::kCols, bq) &&
         hopper::encode(&m[1], k, maps + kMapLongs, D, kBf16, wg::kCols, bk) &&
         hopper::encode(&m[2], v, maps + 2 * kMapLongs, D, kBf16, wg::kCols,
                        bk) &&
         hopper::encode(&m[3], dO, maps + 3 * kMapLongs, D, kBf16, wg::kCols,
                        bq);
}

template <int D>
int dkdv_wgmma_launch(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dk, void* dv, const Args& a,
                      const long long* plan, float scale, cudaStream_t s) {
  using L = wg::Dkdv<D>;
  CUtensorMap m[4];
  if (!encode_qkvd<D>(m, q, k, v, dO, plan + kPlanMaps, L::kBQ, L::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = hopper::opt_in(wg::flash_bwd_dkdv_wgmma_kernel<D>,
                                         L::kAlloc, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.n_k_tiles) * a.sh.n_kv_heads * a.sh.batch;
  wg::flash_bwd_dkdv_wgmma_kernel<D><<<static_cast<unsigned>(blocks),
                                       L::kThreads, L::kAlloc, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_wgmma_launch(const void* q, const void* k, const void* v,
                    const void* dO, const float* lse, const float* delta,
                    void* dq, const Args& a, const long long* plan,
                    float scale, cudaStream_t s) {
  using L = wg::Dq<D>;
  CUtensorMap m[4];
  if (!encode_qkvd<D>(m, q, k, v, dO, plan + kPlanMaps + 4 * kMapLongs,
                      L::kBQ, L::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err =
      hopper::opt_in(wg::flash_bwd_dq_wgmma_kernel<D>, L::kAlloc, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.dq_q_tiles) * a.sh.n_heads * a.sh.batch;
  wg::flash_bwd_dq_wgmma_kernel<D><<<static_cast<unsigned>(blocks),
                                     L::kThreads, L::kAlloc, s>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq),
      a.sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher takes the plan above and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernels do not take (an empty axis
// included: the wrapper launches nothing then). delta and lse are
// (B, H, Sq) f32 contiguous; dq (B, Sq, H, D), dk and dv (B, Sk, K, D)
// contiguous in the operands' dtype. bf16 takes the wgmma kernels, f32 the
// CUDA-core ones; the delta kernel takes both.
extern "C" int flash_bwd_delta_launch(const void* o, const void* dO,
                                      float* delta, const long long* plan,
                                      void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1) {
    return a.d == 64 ? delta_launch<__nv_bfloat16, 64>(o, dO, delta, a, s)
                     : delta_launch<__nv_bfloat16, 128>(o, dO, delta, a, s);
  }
  return a.d == 64 ? delta_launch<float, 64>(o, dO, delta, a, s)
                   : delta_launch<float, 128>(o, dO, delta, a, s);
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dO,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv,
                                     const long long* plan, float scale,
                                     void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.design == 1) {
    return a.d == 64 ? dkdv_wgmma_launch<64>(q, k, v, dO, lse, delta, dk, dv,
                                             a, plan, scale, s)
                     : dkdv_wgmma_launch<128>(q, k, v, dO, lse, delta, dk, dv,
                                              a, plan, scale, s);
  }
  return a.d == 64
             ? dkdv_launch<64>(q, k, v, dO, lse, delta, dk, dv, a, scale, s)
             : dkdv_launch<128>(q, k, v, dO, lse, delta, dk, dv, a, scale, s);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse, const float* delta,
                                   void* dq, const long long* plan,
                                   float scale, void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.design == 1) {
    return a.d == 64 ? dq_wgmma_launch<64>(q, k, v, dO, lse, delta, dq, a,
                                           plan, scale, s)
                     : dq_wgmma_launch<128>(q, k, v, dO, lse, delta, dq, a,
                                            plan, scale, s);
  }
  return a.d == 64 ? dq_launch<64>(q, k, v, dO, lse, delta, dq, a, scale, s)
                   : dq_launch<128>(q, k, v, dO, lse, delta, dq, a, scale, s);
}
