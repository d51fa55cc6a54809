// Row fingerprint: (N, W) int32 lanes -> (N, 2) int32, the change-detection
// hash of VersionedStore.update / ReleaseSession.apply / head rebuilds.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint.py:29
// (_fingerprint_kernel). The bits must equal the reference exactly: they go
// into the release digest chain.
//
// Bound on this card: bytes. It reads N*W*4 bytes and writes N*8 bytes and
// does about 5 integer operations per lane read, far below the card's
// operations-per-byte balance.
//
// Design: one thread per row, looping over the W lanes. All arithmetic is
// on uint32_t (signed overflow is undefined in C++, unsigned wraps, and the
// bits are those of the reference's int32 wraparound); the final `>> 7` is
// taken on the value cast to int32_t, an arithmetic shift as in the
// reference. Neighbouring threads read rows W*4 bytes apart, so at W = 64
// a warp's loads are uncoalesced (each lane read touches its own sector,
// served again from L1 on the next lanes); staging row tiles through
// shared memory is a later optimization.
#include "common.cuh"

namespace {

constexpr uint32_t kFnv1Init = 0x811C9DC5u;  // -2128831035 as int32
constexpr uint32_t kFnv1Mul = 0x01000193u;   // 16777619
constexpr uint32_t kFnv2Init = 0xAA050E95u;  // -1442509163 as int32
constexpr uint32_t kFnv2Mul = 0x165667B1u;   // 374761393

__global__ void fingerprint_kernel(const int32_t* __restrict__ lanes,
                                   int2* __restrict__ out, long long n,
                                   int w) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int32_t* row = lanes + i * w;
  uint32_t h1 = kFnv1Init;
  uint32_t h2 = kFnv2Init;
  for (int j = 0; j < w; ++j) {
    const uint32_t x = static_cast<uint32_t>(__ldg(row + j));
    h1 = (h1 ^ x) * kFnv1Mul;
    h2 = (h2 * kFnv2Mul) ^ (x + static_cast<uint32_t>(j + 1));
  }
  h1 ^= h2 << 13;
  h2 ^= static_cast<uint32_t>(static_cast<int32_t>(h1) >> 7);
  out[i] = make_int2(static_cast<int32_t>(h1), static_cast<int32_t>(h2));
}

}  // namespace

// lanes: (n, w) int32 contiguous; out: (n, 2) int32 contiguous.
extern "C" int fingerprint_launch(const int32_t* lanes, int32_t* out,
                                  long long n, int w, int block,
                                  void* stream) {
  if (n > 0) {
    const long long grid = (n + block - 1) / block;
    fingerprint_kernel<<<static_cast<unsigned>(grid), block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        lanes, reinterpret_cast<int2*>(out), n, w);
  }
  return static_cast<int>(cudaGetLastError());
}
