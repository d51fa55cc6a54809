// Mamba's selective scan: for every batch row b and channel d of d_inner,
// from h_0 = h0[b, d],
//   h_t[n] = exp(dt_t A[d, n]) h_{t-1}[n] + dt_t x_t B_t[n]
//   y_t    = sum_n C_t[n] h_t[n]
// returning y (B, L, di) f32 and h_L (B, di, N) f32. Jamba's Mamba layers
// reach it through kernels/ssm_scan.py (ssm_scan), in a prefill (L tokens)
// and in every decode step (L = 1).
//
// Replaces no Pallas kernel: the JAX package runs the scan as
// jax.lax.associative_scan over chunks, src/repro/models/ssm.py:91
// (ssm_scan_chunked; :135 ssm_scan_sequential in decode), its TPU form of
// the CUDA selective-scan kernel that this is (ssm.py:3-12).
//
// Bound on this card, at Jamba's layer (B 1, L 4,096, di 8,192, N 16): the
// bytes (dt and y in f32, x in bf16, each once), about 0.10 ms. Each
// (t, d, n) takes one exponential, 537 M: about 0.13 ms on the 132 SMs'
// special-function units alone (16 ex2 a clock an SM), but a share of them
// can run as a polynomial on the FMA pipe beside the other f32 work (about
// 7 operations an element), which brings the compute floor to about
// 0.09 ms (chip_smoke.py, exp_bound_s).
//
// Design: the recurrence runs in order over t with each channel's states
// in registers. A channel's N states are split over N / 2 lanes of a warp
// (2 states a lane), and y's sum over n is a shuffle sum over those lanes:
// that puts 32 * N / 2 threads on a block's 32 channels, 256 blocks of 256
// threads at Jamba's B 1 (one thread a channel would give 64 blocks of
// 128, half of the SMs idle). B_t and C_t are shared by every channel of
// a batch row: a block stages them, with dt and x, for a tile of kSteps
// steps in shared memory, dt, x and y by rows of 32 channels (coalesced
// across d). The next tile's loads are issued into registers before the
// current tile's steps run, so their latency hides behind the recurrence.
// Each lane keeps its part of y for every step of a tile in registers and
// the shuffle sums run after the tile's steps, off the recurrence's path.
// Of the shapes measured on an H100 at Jamba's layer (PERF.md, Findings:
// 4 or 1 states a lane, y summed every step), this one was the fastest.
// log2(e) is folded into A, so each decay is one ex2 (ex2.approx.ftz: a
// decay under 2^-126 is 0). x is read in its own dtype (bf16 or f32). B
// and C are read through their batch and time strides (each row of N
// contiguous), as torch.split leaves them in an f32 model.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kStates = 2;    // states a lane
constexpr int kChannels = 32;  // channels a block
constexpr int kSteps = 32;     // steps a tile
constexpr float kLog2e = 1.4426950408889634f;

struct ScanArgs {
  const float* dt;
  const void* x;
  const float* bmat;
  const float* cmat;
  const float* a;
  const float* h0;
  float* y;
  float* h_out;
  int l;
  int di;
  long long b_sb, b_st, c_sb, c_st;  // strides of B and C: batch, time
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int N, typename XT>
__global__ void __launch_bounds__(kChannels * N / kStates)
    ssm_scan_kernel(ScanArgs p) {
  constexpr int kLanes = N / kStates;           // lanes a channel
  constexpr int kThreads = kChannels * kLanes;  // 128 (N 8) or 256 (N 16)
  constexpr int kPer = kSteps * kChannels / kThreads;  // dt, x, y a thread
  constexpr int kPerBC = kSteps * N / kThreads;        // B, C a thread
  static_assert(kThreads % 32 == 0 && kPerBC >= 1, "tile shape");
  __shared__ float s_dt[kSteps][kChannels];
  __shared__ float s_x[kSteps][kChannels];
  __shared__ __align__(16) float s_b[kSteps][N];
  __shared__ __align__(16) float s_c[kSteps][N];
  __shared__ float s_y[kSteps][kChannels];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = tid / kLanes;
  const int lane = tid % kLanes;
  const int d = d0 + ch;
  const XT* x = static_cast<const XT*>(p.x);
  const long long row0 = static_cast<long long>(b) * p.l;  // (b, t = 0)

  float h[kStates], a2[kStates];
  const long long hbase =
      (static_cast<long long>(b) * p.di + d) * N + lane * kStates;
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const bool live = d < p.di;
    h[k] = live ? p.h0[hbase + k] : 0.f;
    a2[k] = live ? p.a[static_cast<long long>(d) * N + lane * kStates + k] *
                       kLog2e
                 : 0.f;
  }

  float r_dt[kPer], r_x[kPer], r_b[kPerBC], r_c[kPerBC];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / kChannels, c = e % kChannels;
      const bool ok = t0 + t < p.l && d0 + c < p.di;
      const long long idx = (row0 + t0 + t) * p.di + d0 + c;
      r_dt[i] = ok ? p.dt[idx] : 0.f;
      r_x[i] = ok ? to_float(x[idx]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerBC; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / N, n = e % N;
      const bool ok = t0 + t < p.l;
      const long long tt = t0 + t;
      r_b[i] = ok ? p.bmat[b * p.b_sb + tt * p.b_st + n] : 0.f;
      r_c[i] = ok ? p.cmat[b * p.c_sb + tt * p.c_st + n] : 0.f;
    }
  };

  // step t of the staged tile: the lane's states advanced, its part of y
  auto step = [&](int t, float* hs, const float* as) {
    const float dtv = s_dt[t][ch];
    const float dx = dtv * s_x[t][ch];
    const float2 bv = *reinterpret_cast<const float2*>(&s_b[t][lane * 2]);
    const float2 cv = *reinterpret_cast<const float2*>(&s_c[t][lane * 2]);
    hs[0] = fmaf(ex2(dtv * as[0]), hs[0], dx * bv.x);
    hs[1] = fmaf(ex2(dtv * as[1]), hs[1], dx * bv.y);
    return fmaf(cv.y, hs[1], cv.x * hs[0]);
  };

  const int n_tiles = (p.l + kSteps - 1) / kSteps;
  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kSteps;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      s_dt[e / kChannels][e % kChannels] = r_dt[i];
      s_x[e / kChannels][e % kChannels] = r_x[i];
    }
#pragma unroll
    for (int i = 0; i < kPerBC; ++i) {
      const int e = i * kThreads + tid;
      s_b[e / N][e % N] = r_b[i];
      s_c[e / N][e % N] = r_c[i];
    }
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(t0 + kSteps);
    // every step of the tile, its lane's part of y kept in a register;
    // past the prompt's end dt and B are 0, so h stays as it is
    float yp[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) yp[t] = step(t, h, a2);
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      float yv = yp[t];
#pragma unroll
      for (int o = kLanes / 2; o > 0; o /= 2)
        yv += __shfl_xor_sync(repro::kFullMask, yv, o);
      if (lane == t % kLanes) s_y[t][ch] = yv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      const int t = e / kChannels, c = e % kChannels;
      if (t0 + t < p.l && d0 + c < p.di)
        p.y[(row0 + t0 + t) * p.di + d0 + c] = s_y[t][c];
    }
  }
  if (d < p.di) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) p.h_out[hbase + k] = h[k];
  }
}

template <int N, typename XT>
int launch(const ScanArgs& p, int batch, cudaStream_t s) {
  const dim3 grid((p.di + kChannels - 1) / kChannels, batch);
  ssm_scan_kernel<N, XT><<<grid, kChannels * N / kStates, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dt, y: (batch, l, di) f32 contiguous; x: the same shape, bf16 where
// x_bf16 else f32; bmat, cmat: (batch, l, n) f32, element (b, t, k) at
// b * sb + t * st + k; a: (di, n) f32; h0, h_out: (batch, di, n) f32.
// n: 8 or 16. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// anything else.
extern "C" int ssm_scan_launch(const float* dt, const void* x,
                               const float* bmat, const float* cmat,
                               const float* a, const float* h0, float* y,
                               float* h_out, int batch, int l, int di, int n,
                               int x_bf16, long long b_sb, long long b_st,
                               long long c_sb, long long c_st, void* stream) {
  if (batch < 1 || batch > 65535 || l < 1 || di < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs p{dt, x, bmat, cmat, a, h0, y, h_out, l, di,
                   b_sb, b_st, c_sb, c_st};
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 8)
    return x_bf16 ? launch<8, __nv_bfloat16>(p, batch, s)
                  : launch<8, float>(p, batch, s);
  if (n == 16)
    return x_bf16 ? launch<16, __nv_bfloat16>(p, batch, s)
                  : launch<16, float>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
