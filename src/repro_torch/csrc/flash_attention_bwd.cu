// Causal grouped-query flash attention, backward (the FlashAttention-2
// algorithm, P recomputed from q, k and the forward's log-sum-exp):
//   s_ij   = q_i . k_j D^-0.5,  P_ij = exp(s_ij - lse_i), 0 where masked
//   delta_i = dO_i . o_i                                   (delta kernel)
//   dV_j   = sum_i P_ij dO_i                                (dkdv kernel)
//   dS_ij  = P_ij (dO_i . v_j - delta_i)
//   dK_j   = D^-0.5 sum_i dS_ij q_i                         (dkdv kernel)
//   dQ_i   = D^-0.5 sum_j dS_ij k_j                         (dq kernel)
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
// logits, P and dS in f32 in every product.
//
// Bound on this card: operations. The backward takes five products over
// the visible pairs (S recomputed, dP, dV, dK, dQ), 10 B H D FLOPs a
// pair: 0.344 TFLOP a layer of llama3.2-1b at B 2 x S 4,096 (H 32, D
// 64), 0.35 ms at the dense bf16 tensor-core rate. This first design is
// correct and simple, not fast: every product is f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), out of shared-memory tiles, so P and dS enter
// the products at f32 precision with no splitting; dkdv recomputes S and
// dP (4 products a tile pair) and dq recomputes them again (3), 7 in all.
// A tensor-core redesign is queued (ROADMAP.md Queue 2).
//
// Design. 256 threads a block, 64-row query tiles and 64-key tiles,
// converted to f32 into shared memory with rows padded to D + 4 floats
// (the float4 reads of 8 neighbouring rows fall in 8 distinct 16-byte
// bank groups). A thread (ty = tid / 16, tx = tid % 16) owns the 4 x 4
// elements (ty + 16 a, tx + 16 b) of each 64 x 64 product S and dP, taken
// as dot products over D in float4 steps, and rows ty + 16 a, columns
// 4 tx + 64 c .. + 3 of each 64 x D accumulator (dK and dV, or dQ), taken
// as outer products over the tile's rows (P and dS from shared memory).
// * flash_bwd_dkdv_kernel: one block per (key tile, KV head, batch), key
//   tile 0 (the most query tiles) first. It loads its K and V tile once,
//   then for each of the G query heads of its group visits the query
//   tiles from the first that sees its keys (kernels/flash_attention.py:
//   bwd_plan, first_q_tile) to the last: loads q, dO, lse and delta,
//   computes S and dP, writes P and dS to shared memory, and adds P^T dO
//   to dV and dS^T q to dK in registers. dK and dV are written once, no
//   atomics: the result does not depend on block order.
// * flash_bwd_dq_kernel: one block per (query tile, head, batch), the
//   last query tile first, over its causal key tiles (the forward's trip
//   count): S, dP, dS (stored transposed), dQ += dS K; dQ written once.
// * flash_bwd_delta_kernel: D / 4 threads a row, four elements each, a
//   shuffle reduction; (B, H, Sq) f32.
// Operands are read through their (batch, seq, head) strides, four
// elements a load: base and strides must be multiples of 4 elements
// (the wrapper copies an operand that is not).
#include <cuda_bf16.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "common.cuh"

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 c = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&c);
  *reinterpret_cast<uint2*>(p) = u;
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

// plan (kernels/flash_attention.py: BwdPlan.args): batch, sq, sk,
// n_heads, n_kv_heads, d, dtype (0 f32, 1 bf16), query tiles, key tiles,
// then the (batch, seq, head) element strides of q, k, v, o and dO
struct Args {
  Shape sh;
  int d, dtype, n_q_tiles, n_k_tiles;
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
  if (a.sh.n_kv_heads <= 0 || a.sh.n_heads % a.sh.n_kv_heads != 0 ||
      (a.d != 64 && a.d != 128) || (a.dtype != 0 && a.dtype != 1) ||
      a.sh.batch <= 0 || a.sh.sq <= 0 || a.sh.sk <= 0 ||
      a.n_q_tiles != (a.sh.sq + kBQ - 1) / kBQ ||
      a.n_k_tiles != (a.sh.sk + kBK - 1) / kBK) {
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

template <typename T, int D>
int dkdv_launch(const void* q, const void* k, const void* v, const void* dO,
                const float* lse, const float* delta, void* dk, void* dv,
                const Args& a, float scale, cudaStream_t s) {
  constexpr int smem = dkdv_smem<D>();
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = opt_in(flash_bwd_dkdv_kernel<T, D>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.n_k_tiles) * a.sh.n_kv_heads * a.sh.batch;
  flash_bwd_dkdv_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads,
                                smem, s>>>(
      static_cast<const T*>(q), a.qst, static_cast<const T*>(k), a.kst,
      static_cast<const T*>(v), a.vst, static_cast<const T*>(dO), a.dst, lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), a.sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, const Args& a,
              float scale, cudaStream_t s) {
  constexpr int smem = dq_smem<D>();
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<T, D>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.n_q_tiles) * a.sh.n_heads * a.sh.batch;
  flash_bwd_dq_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem,
                              s>>>(
      static_cast<const T*>(q), a.qst, static_cast<const T*>(k), a.kst,
      static_cast<const T*>(v), a.vst, static_cast<const T*>(dO), a.dst, lse,
      delta, static_cast<T*>(dq), a.sh, scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_DISPATCH(a, fn, ...)                                         \
  ((a).dtype == 1                                                          \
       ? ((a).d == 64 ? fn<__nv_bfloat16, 64>(__VA_ARGS__)                 \
                      : fn<__nv_bfloat16, 128>(__VA_ARGS__))               \
       : ((a).d == 64 ? fn<float, 64>(__VA_ARGS__)                         \
                      : fn<float, 128>(__VA_ARGS__)))

}  // namespace

// Each launcher takes the plan above and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernels do not take (an empty axis
// included: the wrapper launches nothing then). delta and lse are
// (B, H, Sq) f32 contiguous; dq (B, Sq, H, D), dk and dv (B, Sk, K, D)
// contiguous in the operands' dtype.
extern "C" int flash_bwd_delta_launch(const void* o, const void* dO,
                                      float* delta, const long long* plan,
                                      void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH(a, delta_launch, o, dO, delta, a,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dO,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv,
                                     const long long* plan, float scale,
                                     void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH(a, dkdv_launch, q, k, v, dO, lse, delta, dk, dv, a,
                        scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse, const float* delta,
                                   void* dq, const long long* plan,
                                   float scale, void* stream) {
  Args a;
  if (!parse(plan, a)) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH(a, dq_launch, q, k, v, dO, lse, delta, dq, a, scale,
                        static_cast<cudaStream_t>(stream));
}
