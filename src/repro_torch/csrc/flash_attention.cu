// Causal grouped-query flash attention, forward only:
//   o[b, i, h, :] = softmax_j(q[b, i, h, :] . k[b, j, h / group, :] * D^-0.5)
//                   @ v[b, j, h / group, :]   over keys j <= i + (Sk - Sq)
// with q (B, Sq, H, D), k and v (B, Sk, K, D), H = K * group, f32 or bf16,
// D in {16, 32, 64, 128}. Queries are the last Sq positions of the key
// axis. A query that sees no key (Sq > Sk) gives 0. The serving prefill's
// attention in every layer (models/attention.py: run_attention with
// impl="chunked").
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:33
// (_flash_kernel): the same online softmax with f32 m, l and acc, scale
// applied to q before the product, masked logits at -1e30, p = 0 where
// masked, key tiles past the diagonal skipped, and acc / max(l, 1e-30).
//
// Bound on this card: operations. The work is 4*B*H*D FLOPs per visible
// query-key pair (two products), about 4.4 TFLOP per layer for one 32k
// prompt of llama3.2-1b, against 0.3 GB of q, k, v and o. This design runs
// the products on the CUDA cores in f32 (67 TFLOP/s peak), so it is many
// times slower than the tensor cores' bound (989 TFLOP/s bf16): the
// tensor-core version (wgmma, TMA-fed K/V ring) is a later change.
//
// Design: one block of 4 warps per (64-row query tile, head, batch).
// The query tile, scaled, and each 32-key K/V tile are staged in shared
// memory as f32 (dynamic shared memory: 75 KB at D = 128, over the 48 KB
// static limit). Each warp owns 16 query rows; for the logits, lane j owns
// key j of the tile and reads q rows as broadcast float4s; K rows are
// padded to D + 4 floats so the lanes' float4 reads hit distinct banks.
// The running max is a warp reduction per row; each lane keeps a partial
// row sum l and the final l is one reduction at the end. p goes through a
// per-warp shared strip so that, for p @ v, lane d owns output dims
// d, d + 32, ... and reads p as broadcast float4s. acc stays in registers.
// Tiles past the block's last query row are never loaded.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 32;               // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr float kNeg = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 4) + kBK * (D + 4) + kBK * D +
                          kWarps * kRows * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int n_heads, int group, Strides qst, Strides kst, Strides vst,
             float scale) {
  constexpr int kP = D + 4;            // padded row, float4-aligned
  constexpr int kT = (D + 31) / 32;    // output dims per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kP] scaled queries
  float* ks = qs + kBQ * kP;                    // [kBK][kP]
  float* vs = ks + kBK * kP;                    // [kBK][D]
  float* ps = vs + kBK * D;                     // [kWarps][kRows][kBK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = sk - sq;
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + (h / group) * kst.h;
  const T* vb = v + b * vst.b + (h / group) * vst.h;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i % D;
    const int qi = q0 + r;
    qs[r * kP + c] = qi < sq ? to_f32(qb[qi * qst.s + c]) * scale : 0.f;
  }

  // causal trip count: the tiles holding keys up to the block's last query
  const int q_last = offset + min(q0 + kBQ, sq) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min((q_last + kBK) / kBK, (sk + kBK - 1) / kBK);

  const int row0 = warp * kRows;
  float* pw = ps + warp * kRows * kBK;
  float m[kRows], l[kRows], acc[kRows][kT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[r][t] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile is fully read (and qs staged)
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int r = i / D;
      const int c = i % D;
      const int kj = k0 + r;
      const bool ok = kj < sk;
      ks[r * kP + c] = ok ? to_f32(kb[kj * kst.s + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vb[kj * vst.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ks + lane * kP;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (row0 + r) * kP + c);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = offset + q0 + row0 + r;
      const bool vis = kpos < sk && kpos <= qpos;
      const float x = vis ? s[r] : kNeg;
      float mx = x;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, w));
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = vis ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int t = 0; t < kT; ++t) acc[r][t] *= alpha;
      m[r] = m_new;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][kT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const int d = lane + 32 * t;
          vv[jj][t] = d < D ? vs[(j + jj) * D + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          float a = acc[r][t];
          a = fmaf(p4.x, vv[0][t], a);
          a = fmaf(p4.y, vv[1][t], a);
          a = fmaf(p4.z, vv[2][t], a);
          a = fmaf(p4.w, vv[3][t], a);
          acc[r][t] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float lt = l[r];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      lt += __shfl_xor_sync(repro::kFullMask, lt, w);
    }
    const int qi = q0 + row0 + r;
    if (qi >= sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * sq + qi) * n_heads + h) * D;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int d = lane + 32 * t;
      if (d < D) store(orow + d, acc[r][t] / denom);
    }
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int batch, int sq, int sk, int n_heads, int group,
                 Strides qst, Strides kst, Strides vst, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a launch needs the opt-in, on the current card
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, n_heads, group,
      qst, kst, vst, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int batch, int sq, int sk, int n_heads, int group, Strides qst,
             Strides kst, Strides vst, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_typed<T, 16>(q, k, v, o, batch, sq, sk, n_heads, group,
                                 qst, kst, vst, scale, stream);
    case 32:
      return launch_typed<T, 32>(q, k, v, o, batch, sq, sk, n_heads, group,
                                 qst, kst, vst, scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, batch, sq, sk, n_heads, group,
                                 qst, kst, vst, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, batch, sq, sk, n_heads, group,
                                  qst, kst, vst, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (batch, sq, n_heads, d) and k, v: (batch, sk, n_kv_heads, d), each
// with the strides given (elements) and a contiguous last dim; o:
// (batch, sq, n_heads, d) contiguous. dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or type
// the kernel does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int sk, int n_heads, int n_kv_heads, int d, int dtype, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || (dtype != 0 &&
                                                       dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || sq <= 0 || n_heads <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh},
      vst{v_sb, v_ss, v_sh};
  const int group = n_heads / n_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(d, q, k, v, o, batch, sq, sk, n_heads, group, qst,
                           kst, vst, scale, s);
  }
  return launch_d<__nv_bfloat16>(d, q, k, v, o, batch, sq, sk, n_heads, group,
                                 qst, kst, vst, scale, s);
}
