// RWKV6's WKV recurrence, per batch row b and head h, with the state S a
// (Dk, Dk) matrix:
//   o_t[j]    = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//   S_t[i, j] = exp(logw_t[i]) S_{t-1}[i, j] + k_t[i] v_t[j]
// from S_0 = s0[b, h], returning o (B, L, H, Dk) f32 and S_L (B, H, Dk, Dk)
// f32. rwkv6-7b's time-mix layers reach it through kernels/wkv.py (wkv),
// in a prefill and in every decode step (L = 1).
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as
// jax.lax.associative_scan over chunks, src/repro/models/rwkv.py:122
// (wkv_chunked; :109 wkv_sequential), its TPU form of the CUDA WKV
// kernel's sequential loop that this is (rwkv.py:8-13).
//
// Bound on this card, at rwkv6-7b's layer (B 1, L 4,096, H 64, Dk 64): the
// bytes. r, k, v and logw are read once (268 MB) and o written once (67
// MB): about 0.10 ms; the f32 work (about 5 operations an (i, j) a step,
// 5.4 GFLOP) about 0.08 ms.
//
// Design: the recurrence runs in order over t with S in registers. The
// columns j of S evolve apart (S[:, j] needs only v_t[j]), so a block owns
// kCols = 16 columns of one head, and each column's Dk rows are split over
// kGroups lanes of a warp (8 rows a lane at Dk 64): o_t[j] is a shuffle sum
// over those lanes of sum_i r_i (S_ij) + v_j sum_i r_i u_i k_i. That puts
// 256 blocks of 128 threads on rwkv6-7b's 64 heads at B 1 (one block of Dk
// threads a head, a column each, would give 64 blocks: half of the SMs
// idle). A tile of kSteps = 16 steps of r, k, exp(logw) and u * k (all Dk
// rows) and of v (the block's columns) is staged in shared memory, the
// next tile's loads issued into registers before the current tile's steps
// run. Each lane keeps its part of o for every step of a tile in registers
// and the shuffle sums run after the tile's steps, off the recurrence's
// path (of the shapes measured on an H100 at rwkv6-7b's layer, PERF.md,
// Findings, the fastest); o goes out a tile at a time. A lane reads its
// rows as 16-byte chunks q * kGroups + g, so the lanes of a quarter warp
// read 128 contiguous bytes (no bank conflict). Every lane reads its rows
// of r, k, exp(logw) and u * k from shared memory each step, for each of
// the columns a warp holds: that traffic, not the arithmetic, is what a
// next design would cut.
#include "common.cuh"

namespace {

constexpr int kCols = 16;   // columns of S a block
constexpr int kSteps = 16;  // steps a tile

// lanes a column: 8 at Dk 64, 4 at Dk 16
template <int DK>
constexpr int kGroupsOf = DK == 64 ? 8 : 4;

struct WkvArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* logw;
  const float* u;
  const float* s0;
  float* o;
  float* s_out;
  int l;
  int h;
};

template <int DK>
__global__ void __launch_bounds__(kCols * kGroupsOf<DK>)
    wkv_kernel(WkvArgs p) {
  constexpr int kGroups = kGroupsOf<DK>;         // lanes a column
  constexpr int kRows = DK / kGroups;           // rows a lane: 8 or 4
  constexpr int kChunks = kRows / 4;            // its 16-byte chunks
  constexpr int kThreads = kCols * kGroups;     // 128 or 64
  constexpr int kPer = kSteps * DK / kThreads;  // r, k, logw a thread
  constexpr int kPerV = kSteps * kCols / kThreads;  // v, o a thread
  static_assert(kThreads % 32 == 0 && kThreads % DK == 0 && kRows % 4 == 0 &&
                    kPerV >= 1 && DK % kCols == 0,
                "tile shape");
  __shared__ __align__(16) float s_r[kSteps][DK];
  __shared__ __align__(16) float s_k[kSteps][DK];
  __shared__ __align__(16) float s_w[kSteps][DK];
  __shared__ __align__(16) float s_uk[kSteps][DK];
  __shared__ float s_v[kSteps][kCols];
  __shared__ float s_o[kSteps][kCols];

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kCols;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int col = tid / kGroups;  // this lane's column in the block
  const int g = tid % kGroups;    // its row group
  const int j = j0 + col;
  const long long row_stride = static_cast<long long>(p.h) * DK;  // a step
  const long long base0 =
      (static_cast<long long>(b) * p.l * p.h + hh) * DK;  // (b, 0, hh, 0)
  // every thread stages the same channel of r, k and logw: kThreads is a
  // multiple of DK
  const float uc = p.u[hh * DK + tid % DK];

  float s[kRows];
  const long long sbase = (static_cast<long long>(b) * p.h + hh) * DK * DK;
#pragma unroll
  for (int q = 0; q < kChunks; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[q * 4 + e] = p.s0[sbase + (4 * (q * kGroups + g) + e) * DK + j];

  float r_r[kPer], r_k[kPer], r_lw[kPer], r_v[kPerV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / DK, c = e % DK;
      const bool ok = t0 + t < p.l;
      const long long idx = base0 + (t0 + t) * row_stride + c;
      r_r[i] = ok ? p.r[idx] : 0.f;
      r_k[i] = ok ? p.k[idx] : 0.f;
      r_lw[i] = ok ? p.logw[idx] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / kCols, c = e % kCols;
      const bool ok = t0 + t < p.l;
      r_v[i] = ok ? p.v[base0 + (t0 + t) * row_stride + j0 + c] : 0.f;
    }
  };

  // step t of the staged tile: the lane's rows of S advanced, its part of
  // o_t[j] (S before the update)
  auto step = [&](int t, float* st) {
    const float vj = s_v[t][col];
    float acc = 0.f, ruk = 0.f;
    float4 kk[kChunks], ww[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int c = 4 * (q * kGroups + g);
      const float4 r4 = *reinterpret_cast<const float4*>(&s_r[t][c]);
      const float4 u4 = *reinterpret_cast<const float4*>(&s_uk[t][c]);
      kk[q] = *reinterpret_cast<const float4*>(&s_k[t][c]);
      ww[q] = *reinterpret_cast<const float4*>(&s_w[t][c]);
      acc = fmaf(r4.x, st[q * 4 + 0], acc);
      acc = fmaf(r4.y, st[q * 4 + 1], acc);
      acc = fmaf(r4.z, st[q * 4 + 2], acc);
      acc = fmaf(r4.w, st[q * 4 + 3], acc);
      ruk = fmaf(r4.x, u4.x, ruk);
      ruk = fmaf(r4.y, u4.y, ruk);
      ruk = fmaf(r4.z, u4.z, ruk);
      ruk = fmaf(r4.w, u4.w, ruk);
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      st[q * 4 + 0] = fmaf(ww[q].x, st[q * 4 + 0], kk[q].x * vj);
      st[q * 4 + 1] = fmaf(ww[q].y, st[q * 4 + 1], kk[q].y * vj);
      st[q * 4 + 2] = fmaf(ww[q].z, st[q * 4 + 2], kk[q].z * vj);
      st[q * 4 + 3] = fmaf(ww[q].w, st[q * 4 + 3], kk[q].w * vj);
    }
    return fmaf(vj, ruk, acc);
  };

  const int n_tiles = (p.l + kSteps - 1) / kSteps;
  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kSteps;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / DK, c = e % DK;
      s_r[t][c] = r_r[i];
      s_k[t][c] = r_k[i];
      s_w[t][c] = expf(r_lw[i]);
      s_uk[t][c] = uc * r_k[i];
    }
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int e = i * kThreads + tid;
      s_v[e / kCols][e % kCols] = r_v[i];
    }
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(t0 + kSteps);
    // every step of the tile, its lane's part of o kept in a register;
    // past the prompt's end logw and k are 0, so S stays as it is
    float op[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) op[t] = step(t, s);
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      float ov = op[t];
#pragma unroll
      for (int o = kGroups / 2; o > 0; o /= 2)
        ov += __shfl_xor_sync(repro::kFullMask, ov, o);
      if (g == t % kGroups) s_o[t][col] = ov;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerV; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / kCols, c = e % kCols;
      if (t0 + t < p.l)
        p.o[base0 + (t0 + t) * row_stride + j0 + c] = s_o[t][c];
    }
  }
#pragma unroll
  for (int q = 0; q < kChunks; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p.s_out[sbase + (4 * (q * kGroups + g) + e) * DK + j] = s[q * 4 + e];
}

template <int DK>
int launch(const WkvArgs& p, int batch, cudaStream_t s) {
  constexpr int kThreads = kCols * kGroupsOf<DK>;
  const dim3 grid(DK / kCols, p.h, batch);
  wkv_kernel<DK><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, logw, o: (batch, l, h, dk) f32 contiguous; u: (h, dk) f32;
// s0, s_out: (batch, h, dk, dk) f32. dk: 16 or 64. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for anything else.
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* logw, const float* u, const float* s0,
                          float* o, float* s_out, int batch, int l, int h,
                          int dk, void* stream) {
  if (batch < 1 || batch > 65535 || l < 1 || h < 1 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WkvArgs p{r, k, v, logw, u, s0, o, s_out, l, h};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dk == 16) return launch<16>(p, batch, s);
  if (dk == 64) return launch<64>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
