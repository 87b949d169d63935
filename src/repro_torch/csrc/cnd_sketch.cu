// Hand-written Hopper kernels for the CND sketch (paper Algorithm 1).
//
//   B3 cnd_bitmaps:  items (K, n, f) int32 -> (K, H, m/32) packed bitmaps
//   B4 cnd_popcount: (rows, W) bitmaps -> (rows,) set-bit counts
//
// Replaces src/repro/kernels/cnd_sketch.py::cnd_bitmaps and ::cnd_popcount
// (the Pallas TPU kernels). The TPU has no scatter unit, so its kernel sets
// bits with a one-hot compare of every item against every bitmap word. The
// H100 has shared-memory atomics, so B3 is the paper's own loop: hash each
// item H times and atomicOr one bit.
//
// * What bounds it on the H100: the bytes are small (at K=256, n=320, f=16
//   the items are 5.2 MB and the bitmaps 0.8 MB: 1.8 us at 3.35 TB/s), the
//   integer work about as small (H * (f + 1) avalanche mixes per item, each
//   about ten integer operations). What held the first kernel back was
//   latency: a thread hashed one item's H seeds one after another, each a
//   chain of f + 1 dependent mixes with a runtime prime lookup and a
//   runtime `% m`, in two passes over n = 320 items of 256 threads.
// * Design: one block per node. The node's H * m/32 words (3 KB at H=3,
//   m=8192) live in shared memory; every atomicOr lands there, and the
//   block writes its bitmaps out once after a barrier. At the path's f = 16
//   and H = 3 a thread hashes one item, its three chains interleaved (three
//   independent mixes in flight a step), every step's prime and salt a
//   compile-time constant, the item's words in four 16-byte loads; a block
//   of n threads (up to 1024) covers a node in one pass. Any other f or H
//   takes one (item, seed) chain a thread, n * H threads a block (timed
//   side by side at the path's shape, slower than the interleaved
//   chains). m a power of two takes a mask for `% m`. The hash is the
//   exact uint32 arithmetic of src/repro/core/sketch.py::_mix32, so the
//   bits match bit for bit. Every node is sketched in one launch.
// * B4 gives one warp to each bitmap row: __popc per word and a warp
//   shuffle reduction. It is bound by the bitmap bytes and by its launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSaltBase = 0x7F4A7C15u;
constexpr int kMaxThreads = 1024;

// _mix32's five primes, taken by seed % 5
__host__ __device__ constexpr uint32_t prime(int i) {
  return i == 0 ? 0x9E3779B1u
       : i == 1 ? 0x85EBCA77u
       : i == 2 ? 0xC2B2AE3Du
       : i == 3 ? 0x27D4EB2Fu
                : 0x165667B1u;
}

// xxhash-style avalanche: mix32(x, seed) = avalanche(x, seed * kGolden +
// kSaltBase, prime(seed % 5))
__device__ __forceinline__ uint32_t avalanche(uint32_t x, uint32_t salt,
                                              uint32_t p) {
  x ^= salt;
  x *= p;
  x ^= x >> 15;
  x *= 0x85EBCA77u;
  x ^= x >> 13;
  x *= 0xC2B2AE3Du;
  x ^= x >> 16;
  return x;
}

// a node's bitmaps in shared memory: zeroed, one atomicOr per (item, seed)
// chain, written out once
__device__ __forceinline__ void set_bit(uint32_t* s_bm, int words, int s,
                                        uint32_t hv, int m, bool pow2) {
  const uint32_t x = avalanche(
      hv, static_cast<uint32_t>(101 + s) * kGolden + kSaltBase,
      prime((101 + s) % 5));
  const uint32_t bit = pow2 ? x & static_cast<uint32_t>(m - 1)
                            : x % static_cast<uint32_t>(m);
  atomicOr(&s_bm[s * words + (bit >> 5)], 1u << (bit & 31u));
}

// F features and H seeds known at compile time (the path's f = 16, H = 3):
// a thread hashes one item's H chains interleaved, every prime and salt a
// constant; the item's words come in F / 4 16-byte loads
template <int F, int H>
__global__ void cnd_bitmaps_unrolled(const int32_t* __restrict__ items,
                                     uint32_t* __restrict__ out, int n,
                                     int m) {
  static_assert(F % 4 == 0, "an item is loaded as 16-byte vectors");
  extern __shared__ uint32_t s_bm[];   // H * (m / 32) words
  const int words = m >> 5;
  for (int w = threadIdx.x; w < H * words; w += blockDim.x) s_bm[w] = 0u;
  __syncthreads();
  const int32_t* node = items + (size_t)blockIdx.x * n * F;
  const bool pow2 = (m & (m - 1)) == 0;
  for (int it = threadIdx.x; it < n; it += blockDim.x) {
    const int4* row = reinterpret_cast<const int4*>(node + (size_t)it * F);
    uint32_t x[F];
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const int4 v = row[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    uint32_t hv[H];
#pragma unroll
    for (int s = 0; s < H; ++s) hv[s] = 0u;
#pragma unroll
    for (int j = 0; j < F; ++j) {
#pragma unroll
      for (int s = 0; s < H; ++s) {
        hv[s] = avalanche(hv[s] * 31u + x[j],
                          static_cast<uint32_t>(s + j) * kGolden + kSaltBase,
                          prime((s + j) % 5));
      }
    }
#pragma unroll
    for (int s = 0; s < H; ++s) set_bit(s_bm, words, s, hv[s], m, pow2);
  }
  __syncthreads();
  uint32_t* dst = out + (size_t)blockIdx.x * H * words;
  for (int w = threadIdx.x; w < H * words; w += blockDim.x) dst[w] = s_bm[w];
}

// any f and h: a thread hashes one (item, seed) chain, hv = mix32(hv * 31 +
// row[j], s + j) for j < f, and the block's n * h threads run the node's
// chains in one pass
__global__ void cnd_bitmaps_chains(const int32_t* __restrict__ items,
                                   uint32_t* __restrict__ out, int n, int f,
                                   int h, int m) {
  extern __shared__ uint32_t s_bm[];   // h * (m / 32) words
  const int words = m >> 5;
  for (int w = threadIdx.x; w < h * words; w += blockDim.x) s_bm[w] = 0u;
  __syncthreads();
  const int32_t* node = items + (size_t)blockIdx.x * n * f;
  const bool pow2 = (m & (m - 1)) == 0;
  for (int c = threadIdx.x; c < n * h; c += blockDim.x) {
    const int s = c / n, it = c - s * n;   // chain c: item it, seed s
    const int32_t* row = node + (size_t)it * f;
    const uint32_t base = static_cast<uint32_t>(s) * kGolden + kSaltBase;
    uint32_t hv = 0u;
    for (int j = 0; j < f; ++j) {
      hv = avalanche(hv * 31u + static_cast<uint32_t>(row[j]),
                     base + static_cast<uint32_t>(j) * kGolden,
                     prime((s + j) % 5));
    }
    set_bit(s_bm, words, s, hv, m, pow2);
  }
  __syncthreads();
  uint32_t* dst = out + (size_t)blockIdx.x * h * words;
  for (int w = threadIdx.x; w < h * words; w += blockDim.x) dst[w] = s_bm[w];
}

__global__ void popcount_kernel(const uint32_t* __restrict__ bm,
                                int32_t* __restrict__ out, int rows,
                                int words) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;   // uniform across the warp
  const uint32_t* src = bm + (size_t)warp * words;
  int c = 0;
  for (int w = lane; w < words; w += 32) c += __popc(src[w]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lane == 0) out[warp] = c;
}

}  // namespace

// a block of `work` threads rounded up to a warp, at most kMaxThreads
int block_threads(int work) {
  return work >= kMaxThreads ? kMaxThreads : (work + 31) / 32 * 32;
}

extern "C" int repro_cnd_bitmaps(const void* items, void* out, int k, int n,
                                 int f, int h, int m, void* stream) {
  const size_t smem = sizeof(uint32_t) * (size_t)h * (m / 32);
  const auto* src = static_cast<const int32_t*>(items);
  auto* dst = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 16 && h == 3 && (reinterpret_cast<uintptr_t>(items) & 15) == 0) {
    cnd_bitmaps_unrolled<16, 3><<<k, block_threads(n), smem, s>>>(src, dst,
                                                                 n, m);
  } else {
    cnd_bitmaps_chains<<<k, block_threads(n * h), smem, s>>>(src, dst, n, f,
                                                             h, m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_cnd_popcount(const void* bitmaps, void* out, int rows,
                                  int words, void* stream) {
  const int warps_per_block = 4;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  popcount_kernel<<<blocks, 32 * warps_per_block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmaps), static_cast<int32_t*>(out), rows,
      words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
